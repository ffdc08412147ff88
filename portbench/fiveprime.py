"""The 10x 5′ BAM of the ``bam_fiveprime`` kind (the ``tenx5p`` mix), made from
a cell's seed, and its BAM writer.

A pass is ``n_groups`` UMI groups of ``pairs_per_group`` pairs, each group
one molecule with its own cell barcode and UMI.  A molecule is a sense
strand: exactly ``library_share`` of them are a forward row of the library
between two flanks of ``flank`` random bases (as ``paired.transcripts``
draws them), and of those exactly ``antisense_share`` are that
transcript's reverse complement; the rest are background transcripts of
random bases.  The molecule's 5′ start is shared by its pairs, so their
R1s are equal before errors; a library molecule starts where R1's cDNA
overlaps the row by at least ``min_overlap`` bases.  Each pair has its
own fragment length, uniform in ``fragment_len``.

The reads as sequenced: R1 is the template-switch oligo's end (``tso``)
then the fragment's first ``r1_len - len(tso)`` bases (Cell Ranger has
moved barcode and UMI into tags), R2 the reverse complement of the
fragment's last ``r2_len`` bases.  Exactly ``substitution_share`` of the
records get one substitution and, of the others, ``junk_share`` of all
become random bases of their length.  The records are stored
reference-forward: for the exactly ``minus_share`` of molecules from
minus-strand genes R1 is stored reverse-complemented with REVERSE and R2
as read; for the others R1 as read and R2 reverse-complemented with
REVERSE.  Every seed draws the same counts; the seed moves only sequences,
positions and order.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List

import numpy as np

from portbench import generate, paired

# flags of a pair's records: plus strand R1 forward, R2 REVERSE; minus
# strand R1 REVERSE, R2 forward
PLUS_FLAGS = (generate.R1_FLAG, generate.R2_FLAG)
MINUS_FLAGS = (
    generate.FLAG_PAIRED | generate.FLAG_FIRST | generate.FLAG_REVERSE,
    generate.FLAG_PAIRED | generate.FLAG_LAST | generate.FLAG_MATE_REVERSE)


@dataclass
class FivePrimeRecords:
    """The records of a 5′ BAM, in file order (R1, R2 of each pair; the pairs
    of a group together).  ``r1`` and ``r2`` are the stored,
    reference-forward sequences; ``flag``, ``pos``, ``mpos`` and ``tlen``
    are per record; the rest per pair or per group."""

    r1: np.ndarray          # (pairs, r1_len) int8, as stored
    r2: np.ndarray          # (pairs, r2_len) int8, as stored
    flag: np.ndarray        # (records,)
    pos: np.ndarray
    mpos: np.ndarray
    tlen: np.ndarray
    qual: int
    pairs_per_group: int
    cb: List[str]           # per group, with the "-1" suffix
    ub: List[str]           # per group
    on_library: np.ndarray  # (groups,) bool
    antisense: np.ndarray   # (groups,) bool: the row's reverse complement
    minus: np.ndarray       # (groups,) bool: R1 stored REVERSE
    row: np.ndarray         # (groups,) the library row, -1 off the library
    start: np.ndarray       # (groups,) the molecule's 5′ start
    length: np.ndarray      # (pairs,) the fragment's length
    edited: np.ndarray      # (records,) 0 clean, 1 substituted, 2 junk

    @property
    def n_groups(self) -> int:
        return len(self.cb)

    @property
    def n_records(self) -> int:
        return 2 * len(self.r1)

    def seq(self, i: int) -> np.ndarray:
        """Record ``i``'s stored sequence."""
        return (self.r2 if i % 2 else self.r1)[i // 2]

    def qname(self, i: int) -> str:
        return f"q{i // 2:08d}"


def umis(rng: np.random.Generator, n: int, length: int) -> List[str]:
    """``n`` distinct UMIs of ``length`` bases, none all A (nimble's reader
    skips the 10-base AAAAAAAAAA)."""
    picks = rng.choice((1 << (2 * length)) - 1, n, replace=False) + 1
    digits = (picks[:, None] >> (2 * np.arange(length - 1, -1, -1))) & 3
    return generate._rows_as_str(generate.BASES[digits])


def _errors(rng: np.random.Generator, reads: List[np.ndarray],
            traffic: dict) -> np.ndarray:
    """The error model in place over the records (``reads`` in record
    order): exactly ``substitution_share`` get one substitution and, of the
    others, ``junk_share`` of all become random bases.  Returns each
    record's edit (0 none, 1 substituted, 2 junk)."""
    n = len(reads)
    order = rng.permutation(n)
    n_sub = int(round(traffic["substitution_share"] * n))
    n_junk = int(round(traffic["junk_share"] * n))
    shift = rng.integers(1, 4, n_sub)
    where = rng.random(n_sub)
    edited = np.zeros(n, dtype=np.int8)
    for k, i in enumerate(order[:n_sub]):
        at = int(where[k] * len(reads[i]))
        reads[i][at] = (reads[i][at] + shift[k]) % 4
        edited[i] = 1
    for i in order[n_sub: n_sub + n_junk]:
        reads[i][:] = rng.integers(0, 4, len(reads[i]), dtype=np.int8)
        edited[i] = 2
    return edited


def records(lib: generate.Library, traffic: dict, n_groups: int,
            seed: int) -> FivePrimeRecords:
    rng = generate.rng_for(seed, 5)
    r1_len, r2_len = traffic["r1_len"], traffic["r2_len"]
    tso = generate._CODE[np.frombuffer(traffic["tso"].encode("ascii"),
                                       dtype=np.uint8)]
    cdna = r1_len - len(tso)
    ppg = traffic["pairs_per_group"]
    lo, hi = traffic["fragment_len"]
    flank, overlap = traffic["flank"], traffic["min_overlap"]
    row_len = len(lib.codes[0])
    assert all(len(c) == row_len for c in lib.codes)
    assert r2_len <= lo <= hi <= flank + overlap
    tx = paired.transcripts(lib, traffic, rng)
    background = rng.integers(
        0, 4, (traffic["background_transcripts"], traffic["background_len"]),
        dtype=np.int8)
    on_lib = generate._exact(rng, n_groups, traffic["library_share"])
    n_on = int(on_lib.sum())
    row = np.full(n_groups, -1, dtype=np.int64)
    row[on_lib] = rng.permutation(np.arange(n_on) % len(lib.codes))
    antisense = np.zeros(n_groups, dtype=bool)
    antisense[on_lib] = generate._exact(rng, n_on, traffic["antisense_share"])
    minus = generate._exact(rng, n_groups, traffic["minus_share"])
    # the 5′ start: on a library transcript where R1's cDNA overlaps the
    # row [flank, flank + row_len) by >= overlap (the flanks are equal, so
    # the same holds on its reverse complement); on a background one
    # anywhere a longest fragment fits
    start = np.empty(n_groups, dtype=np.int64)
    first = flank + overlap - cdna
    start[on_lib] = first + rng.integers(
        0, flank + row_len - overlap - first + 1, n_on)
    start[~on_lib] = rng.integers(0, background.shape[1] - hi + 1,
                                  n_groups - n_on)
    back_of = rng.integers(0, len(background), n_groups - n_on)
    n_pairs = n_groups * ppg
    length = rng.integers(lo, hi + 1, n_pairs)
    group = np.repeat(np.arange(n_groups), ppg)
    # each molecule's sense strand, long enough for its longest fragment
    sense = np.empty((n_groups, hi), dtype=np.int8)
    cols = start[:, None] + np.arange(hi)
    on_rows = np.where(antisense[on_lib][:, None],
                       generate.revcomp_codes(tx[row[on_lib]]),
                       tx[row[on_lib]])
    sense[on_lib] = np.take_along_axis(on_rows, cols[on_lib], axis=1)
    sense[~on_lib] = background[back_of[:, None], cols[~on_lib]]
    mol = sense[group]
    head = mol[:, :cdna]
    tail = np.take_along_axis(mol, (length - r2_len)[:, None]
                              + np.arange(r2_len), axis=1)
    read1 = np.concatenate([np.broadcast_to(tso, (n_pairs, len(tso))),
                            head], axis=1).astype(np.int8)
    read2 = generate.revcomp_codes(tail).astype(np.int8)
    reads = [x for p in range(n_pairs) for x in (read1[p], read2[p])]
    edited = _errors(rng, reads, traffic)
    pair_minus = minus[group]
    r1 = np.where(pair_minus[:, None], generate.revcomp_codes(read1), read1)
    r2 = np.where(pair_minus[:, None], read2, generate.revcomp_codes(read2))
    flag = np.empty(2 * n_pairs, dtype=np.int64)
    flag[0::2] = np.where(pair_minus, MINUS_FLAGS[0], PLUS_FLAGS[0])
    flag[1::2] = np.where(pair_minus, MINUS_FLAGS[1], PLUS_FLAGS[1])
    # the forward mate leftmost; the reverse one ends the fragment
    left = 100 + np.tile(np.arange(ppg), n_groups)
    right = left + length - np.where(pair_minus, r1_len, r2_len)
    pos = np.empty(2 * n_pairs, dtype=np.int64)
    pos[0::2] = np.where(pair_minus, right, left)
    pos[1::2] = np.where(pair_minus, left, right)
    mpos = np.empty_like(pos)
    mpos[0::2], mpos[1::2] = pos[1::2], pos[0::2]
    tlen = np.where(pos < mpos, 1, -1) * np.repeat(length, 2)
    return FivePrimeRecords(
        r1=np.ascontiguousarray(r1, dtype=np.int8),
        r2=np.ascontiguousarray(r2, dtype=np.int8), flag=flag, pos=pos,
        mpos=mpos, tlen=tlen, qual=traffic["quality"], pairs_per_group=ppg,
        cb=generate.cell_barcodes(n_groups),
        ub=umis(rng, n_groups, traffic["umi_len"]), on_library=on_lib,
        antisense=antisense, minus=minus, row=row, start=start,
        length=length, edited=edited)


def _rows(recs: FivePrimeRecords, mate: int) -> np.ndarray:
    """The records of one mate (0: R1, 1: R2), each a fixed-size row of
    BAM record bytes: block size, the fixed fields, name, SEQ, QUAL, then
    the tags CB, UB, CR and UR."""
    seqs = recs.r2 if mate else recs.r1
    n, read_len = seqs.shape
    at = np.arange(mate, 2 * n, 2)
    group = np.arange(n) // recs.pairs_per_group
    names = generate._text_column([f"q{i:08d}\x00" for i in range(n)])
    cb = generate._text_column(recs.cb)[group]
    ub = generate._text_column(recs.ub)[group]
    codes = generate._NIBBLE[seqs.astype(np.int64)]
    if read_len % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    seq = (codes[:, 0::2] << 4) | codes[:, 1::2]
    qual = np.full((n, read_len), recs.qual, dtype=np.uint8)
    zero = np.zeros((n, 1), dtype=np.uint8)

    def tag(name: str, text: np.ndarray) -> list:
        head = np.frombuffer(name.encode("ascii") + b"Z", np.uint8)
        return [np.repeat(head[None, :], n, 0), text, zero]

    col = generate._column
    body = [
        col(np.zeros(n), "<i4"),                    # refID
        col(recs.pos[at], "<i4"),
        col(np.full(n, names.shape[1]), "<u1"),     # l_read_name
        col(np.full(n, generate.MAPQ), "<u1"),
        col(np.zeros(n), "<u2"),                    # bin
        col(np.zeros(n), "<u2"),                    # n_cigar_op
        col(recs.flag[at], "<u2"),
        col(np.full(n, read_len), "<i4"),           # l_seq
        col(np.zeros(n), "<i4"),                    # next refID
        col(recs.mpos[at], "<i4"),
        col(recs.tlen[at], "<i4"),
        names, seq, qual,
        *tag("CB", cb), *tag("UB", ub), *tag("CR", cb[:, :-2]),
        *tag("UR", ub),
    ]
    size = sum(p.shape[1] for p in body)
    return np.concatenate([col(np.full(n, size), "<i4"), *body], axis=1)


def bam_bytes(recs: FivePrimeRecords) -> bytes:
    """The uncompressed BAM stream: the header, then each pair's R1 and R2
    records (two fixed sizes, one a mate)."""
    text = generate.BAM_HEADER_TEXT.encode("ascii")
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text
    head += struct.pack("<i", len(generate.BAM_REFERENCES))
    for name, length in generate.BAM_REFERENCES:
        raw = name.encode("ascii") + b"\x00"
        head += struct.pack("<i", len(raw)) + raw + struct.pack("<i", length)
    return head + np.concatenate([_rows(recs, 0), _rows(recs, 1)],
                                 axis=1).tobytes()


def write_bam(path: str, recs: FivePrimeRecords) -> None:
    payload = memoryview(bam_bytes(recs))
    step = generate._BGZF_STEP
    with open(path, "wb") as f:
        for i in range(0, len(payload), step):
            f.write(generate._bgzf(bytes(payload[i: i + step])))
        f.write(generate._BGZF_EOF)
