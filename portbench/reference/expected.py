"""The outputs the program has to write, worked out from the inputs alone.

``fastq_tsv`` is the count TSV of ``fastq_pipeline.process`` and
``bam_tsv`` the decompressed forensic TSV of ``bam_fast.process_fast``
(one consumer), each for one library, as
nimble's reference path computes them: the frozen host calls of
:mod:`portbench.reference.host` over the alignments of
:mod:`portbench.reference.align`.  Both read the library
JSON file the program reads, and take the reads and records the harness
generated, not the files the program parses.  ``overrides`` changes
fields of the library's filter configuration: the control of the check
runs the reference with a guarantee of the configuration broken.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.generate import TenxRecords, decode
from portbench.reference import align, host


def load(library_path: str, strand_filter: str,
         overrides: Optional[dict] = None):
    cfg, ref = host.load_reference_library(
        library_path, host.LibraryChemistry.from_cli(strand_filter))
    for key, value in (overrides or {}).items():
        setattr(cfg, key, value)
    return cfg, ref


def index_of(ref, device) -> align.KmerIndex:
    seqs, _names = host.get_reference_sequence_data(ref)
    return align.KmerIndex([host.encode_bases(s) for s in seqs], device)


def fastq_tsv(library_path: str, strand_filter: str, reads: np.ndarray,
              device, overrides: Optional[dict] = None) -> bytes:
    """The count TSV of single-end reads (N, L) int8.  nimble's score map
    is keyed by the read's sequence, so each distinct read counts once."""
    cfg, ref = load(library_path, strand_filter, overrides)
    uniq = np.unique(reads, axis=0)
    results = align.align(index_of(ref, device), list(uniq), cfg)
    callset_of: Dict[tuple, Optional[tuple]] = {}
    counts: Dict[tuple, int] = {}
    for aln, _filt in results:
        if aln is None:
            continue
        eq = tuple(aln[0])
        if eq not in callset_of:
            found: dict = {}
            host.filter_and_coerce_sequence_call_orientations(
                (host.PairState.FIRST, (list(eq), aln[1]), None, [], []),
                found, ref, cfg, "", {})
            callset_of[eq] = next(iter(found)) if found else None
        callset = callset_of[eq]
        if callset is not None:
            counts[callset] = counts.get(callset, 0) + 1
    rows = host.sort_score_vector([(list(c), n) for c, n in counts.items()])
    return ("feature\tscore\n" + "".join(
        "\t".join(f) + f"\t{n}\n" for f, n in rows)).encode("utf-8")


def record_metadata(recs: TenxRecords, records) -> Tuple[List[str],
                                                    List[List[str]]]:
    """(stored sequences, 38-field metadata rows) of ``records`` as the
    program's reader derives them (``io/umi.record_metadata`` over
    ``io/sorted_bam``'s paired records, SKIP_ALIGN "FALSE"), for this BAM's
    records: no clipping, string tags CB, UB, CR and UR only."""
    read_len = recs.seq.shape[1]
    qual = chr(recs.qual) * read_len
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
        seq = decode(recs.seq[i])
        seqs.append(seq)
        rows.append([
            recs.qname(i), qual[::-1] if rev else qual, b(rev),
            b(bool(flag & 0x20)), b(bool(flag & 0x1)), b(bool(flag & 0x2)),
            orientation, b(bool(flag & 0x4)), b(bool(flag & 0x8)), b(first),
            b(bool(flag & 0x80)), "-" if rev else "+", "60", str(pos),
            str(mpos), seq, str(read_len), str(int(recs.tlen[i])),
            b(bool(flag & 0x200)), b(bool(flag & 0x100)),
            b(bool(flag & 0x400)), b(bool(flag & 0x800)),
            "", "", "", "", "", "", "", "", "",
            cb[:-2], "", cb, ub, "", ub, "FALSE"])
    return seqs, rows


def bam_tsv(library_path: str, strand_filter: str, recs: TenxRecords,
            device, overrides: Optional[dict] = None) -> bytes:
    """The decompressed forensic TSV of the 10x BAM, as one consumer writes
    it: the header, then the rows of every UMI group in file order.  The
    BAM's final group is never written (nimble's quirk)."""
    cfg, ref = load(library_path, strand_filter, overrides)
    per_group = 2 * recs.pairs_per_group
    n_groups = recs.n_groups - 1
    seqs, meta = record_metadata(recs, range(n_groups * per_group))
    oriented = [host.encode_bases(host.reverse_comp_if_needed(
        s, host.parse_str_as_bool(m[2]))) for s, m in zip(seqs, meta)]
    t1, t2 = host.prepare_trimmed(oriented[0::2], oriented[1::2], meta, cfg)
    index = index_of(ref, device)
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
    return ("\n".join(lines) + "\n").encode("utf-8")
