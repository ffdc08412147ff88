"""The forensic TSV nimble writes for a 10x 5′ BAM, worked out from the records
alone.

``bam_tsv`` is the decompressed output of ``bam_fast.process_fast`` (one
consumer) for one library, as nimble's reference path computes it: each
record's metadata as nimble's reader derives it, with the 10x rule
applied, then the flow of :func:`portbench.reference.expected.bam_tsv`
(the oriented, trimmed mates aligned by :mod:`portbench.reference.align`,
each UMI group scored by the frozen host calls of
:mod:`portbench.reference.host`, the BAM's final group never written).

The 10x rule, from nimble's ``strip_nonbio_regions`` and
``strip_nonbio_regions_qual`` (``src/parse/bam.rs:255-287``): a record
whose stored SEQ is exactly 124 bases loses 13 of them, at the start, or
at the end where the record is REVERSE; its QUAL loses the same 13 and is
then reversed for a REVERSE record.  The metadata row carries the clipped
SEQ and QUAL and the stored length (``SEQ_LEN``).

``pairs_oriented_out`` counts, over the pairs written, those with a call on
at least one mate (and, with ``require_valid_pair``, a valid pair) whose
orientation pipeline (``filter_and_coerce_sequence_call_orientations``)
ends in a triage: the pairs the program's counter
``bam.pairs_oriented_out`` counts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from portbench.fiveprime import FivePrimeRecords
from portbench.generate import decode
from portbench.reference import align, expected, host

CLIP_FROM = 124    # the stored SEQ length the rule clips
CLIP = 13          # the bases it clips


def clip(seq: str, qual: str, reverse: bool) -> Tuple[str, str]:
    """(SEQ, QUAL) of a record as nimble's reader reports them."""
    if len(seq) == CLIP_FROM:
        seq = seq[: -CLIP] if reverse else seq[CLIP:]
    if len(qual) == CLIP_FROM:
        qual = qual[: -CLIP] if reverse else qual[CLIP:]
    return seq, qual[::-1] if reverse else qual


def record_metadata(recs: FivePrimeRecords, records
                    ) -> Tuple[List[str], List[List[str]]]:
    """(clipped sequences, 38-field metadata rows) of ``records``, string
    tags CB, UB, CR and UR only."""
    seqs, rows = [], []
    b = host._rust_bool
    for i in records:
        flag = int(recs.flag[i])
        rev = bool(flag & 0x10)
        first = bool(flag & 0x40)
        group = i // (2 * recs.pairs_per_group)
        cb, ub = recs.cb[group], recs.ub[group]
        pos, mpos = int(recs.pos[i]), int(recs.mpos[i])
        if pos == mpos:
            orientation = "None"
        else:
            own = ("R" if rev else "F") + ("1" if first else "2")
            mate = ("R" if flag & 0x20 else "F") + ("2" if first else "1")
            orientation = own + mate if pos < mpos else mate + own
        stored = decode(recs.seq(i))
        seq, qual = clip(stored, chr(recs.qual) * len(stored), rev)
        seqs.append(seq)
        rows.append([
            recs.qname(i), qual, b(rev),
            b(bool(flag & 0x20)), b(bool(flag & 0x1)), b(bool(flag & 0x2)),
            orientation, b(bool(flag & 0x4)), b(bool(flag & 0x8)), b(first),
            b(bool(flag & 0x80)), "-" if rev else "+", "60", str(pos),
            str(mpos), seq, str(len(stored)), str(int(recs.tlen[i])),
            b(bool(flag & 0x200)), b(bool(flag & 0x100)),
            b(bool(flag & 0x400)), b(bool(flag & 0x800)),
            "", "", "", "", "", "", "", "", "",
            cb[:-2], "", cb, ub, "", ub, "FALSE"])
    return seqs, rows


def _oriented_out(res1, res2, ref, cfg) -> int:
    """The pairs with a call on a mate whose orientation ends in a triage."""
    outcome: Dict[tuple, bool] = {}
    n = 0
    for a1, a2 in zip(res1, res2):
        e1 = list(a1[0][0]) if a1[0] else []
        e2 = list(a2[0][0]) if a2[0] else []
        if not (e1 or e2):
            continue
        if cfg.require_valid_pair and host.filter_pair(e1, e2):
            continue
        key = (tuple(e1), tuple(e2))
        if key not in outcome:
            found: dict = {}
            triage: dict = {}
            host.filter_and_coerce_sequence_call_orientations(
                (None, (e1, 0.0) if e1 else None, (e2, 0.0) if e2 else None,
                 [], []), found, ref, cfg, "", triage)
            outcome[key] = not found
        n += outcome[key]
    return n


def bam_tsv(library_path: str, strand_filter: str, recs: FivePrimeRecords,
            device, overrides: Optional[dict] = None) -> Tuple[bytes, int]:
    """(the decompressed forensic TSV, ``pairs_oriented_out``) of the BAM,
    as one consumer writes it: the header, then the rows of every UMI group
    in file order but the final one (nimble's quirk)."""
    cfg, ref = expected.load(library_path, strand_filter, overrides)
    per_group = 2 * recs.pairs_per_group
    n_groups = recs.n_groups - 1
    seqs, meta = record_metadata(recs, range(n_groups * per_group))
    oriented = [host.encode_bases(host.reverse_comp_if_needed(
        s, host.parse_str_as_bool(m[2]))) for s, m in zip(seqs, meta)]
    t1, t2 = host.prepare_trimmed(oriented[0::2], oriented[1::2], meta, cfg)
    index = expected.index_of(ref, device)
    res1, res2 = align.align(index, t1, cfg), align.align(index, t2, cfg)
    ppg = recs.pairs_per_group
    lines = [host.log_header()]
    for g in range(n_groups):
        lo, hi = g * per_group, (g + 1) * per_group
        engine = host.PrecomputedEngine(res1[g * ppg: (g + 1) * ppg],
                                        res2[g * ppg: (g + 1) * ppg])
        (scores,) = host.align_umi_to_libraries(
            seqs[lo:hi], meta[lo:hi], [engine], [ref], [cfg])
        lines += [host.format_log_row(f, rec) for f, rec in scores]
    tsv = ("\n".join(lines) + "\n").encode("utf-8")
    return tsv, _oriented_out(res1, res2, ref, cfg)
