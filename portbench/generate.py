"""Inputs of a cell, made from its seed: the library, the reads, the files.

The harness's own generators, independent of the program's: a
configuration file (``configs/<name>.json``) holds the library as
published, with its filters; a traffic file (``traffic/<name>.json``) says
how to draw the reads from it, and the cell file (``cells/<name>.json``)
how many.  Every seed draws the same counts (fragments, copies,
substitutions, junk reads, on-library molecules); the seed moves only
sequences, positions and order, so two seeds give the same amount of work.

Codes are int8, A=0 C=1 G=2 T=3; the reverse complement of codes ``c`` is
``3 - c[::-1]``.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from typing import List

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream): seeds of any size."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def decode(codes: np.ndarray) -> str:
    return BASES[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray((3 - codes)[..., ::-1])


@dataclass
class Library:
    """A configuration's library: the JSON the program loads ([filters,
    columnar table]) and its forward features as codes."""

    json_obj: list
    codes: List[np.ndarray]       # forward feature codes, int8

    def doubled(self) -> List[np.ndarray]:
        """Rows as the loader doubles them: feature, reverse complement."""
        return [x for c in self.codes for x in (c, revcomp_codes(c))]


_CODE = np.zeros(256, dtype=np.int8)
for _i, _ch in enumerate("ACGT"):
    _CODE[ord(_ch)] = _CODE[ord(_ch.lower())] = _i


def library(config: dict) -> Library:
    """The library a configuration file holds, as published."""
    obj = config["library"]
    table = obj[1]
    seqs = table["columns"][table["headers"].index("sequence")]
    codes = [_CODE[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]
             for s in seqs]
    return Library(obj, codes)


def write_library(path: str, lib: Library) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(lib.json_obj, f)


def _exact(rng, n: int, share: float) -> np.ndarray:
    """A mask of exactly round(share * n) of n items, placed by ``rng``."""
    mask = np.zeros(n, dtype=bool)
    mask[rng.permutation(n)[: int(round(share * n))]] = True
    return mask


def _mutate(rng, mat: np.ndarray, traffic: dict) -> None:
    """The error model in place: exactly ``substitution_share`` of the rows
    get one substitution and, of the others, ``junk_share`` of all rows
    become random bases."""
    n, length = mat.shape
    order = rng.permutation(n)
    n_sub = int(round(traffic["substitution_share"] * n))
    n_junk = int(round(traffic["junk_share"] * n))
    sub, junk = order[:n_sub], order[n_sub: n_sub + n_junk]
    pos = rng.integers(0, length, n_sub)
    mat[sub, pos] = (mat[sub, pos] + rng.integers(1, 4, n_sub)) % 4
    mat[junk] = rng.integers(0, 4, (n_junk, length), dtype=np.int8)


def fastq_reads(lib: Library, traffic: dict, n_reads: int,
                seed: int) -> np.ndarray:
    """(n_reads, read_len) int8 reads of the ``ontarget`` kind: distinct
    fragments of the doubled rows, each read ``copies`` times.  Fragments
    go to the rows in turn, so every row gets as many as any other (a pass
    of fewer fragments than rows takes the first rows only)."""
    rng = rng_for(seed, 2)
    read_len = traffic["read_len"]
    copies = np.asarray(traffic["copies"])
    n_frag = -(-n_reads * len(copies) // int(copies.sum()))
    rows = lib.doubled()
    row_codes = np.stack(rows)  # every row of a library has one length
    row_of = rng.permutation(np.arange(n_frag) % len(rows))
    starts = rng.integers(0, row_codes.shape[1] - read_len + 1, n_frag)
    frags = row_codes[row_of[:, None], starts[:, None] + np.arange(read_len)]
    frags = np.ascontiguousarray(frags, dtype=np.int8)
    _mutate(rng, frags, traffic)
    times = rng.permutation(np.resize(copies, n_frag))
    ids = rng.permutation(np.repeat(np.arange(n_frag), times))[:n_reads]
    return np.ascontiguousarray(frags[ids])


def write_fastq(path: str, mat: np.ndarray) -> None:
    """Reads as FASTQ: @r<index>, the bases, +, quality I."""
    n, length = mat.shape
    digits = 9
    head = np.empty((n, 2 + digits + 1), dtype=np.uint8)
    head[:, 0], head[:, 1], head[:, -1] = ord("@"), ord("r"), ord("\n")
    idx = np.arange(n, dtype=np.int64)
    for d in range(digits):
        head[:, 2 + d] = ord("0") + (idx // 10 ** (digits - 1 - d)) % 10
    tail = np.frombuffer(b"\n+\n", dtype=np.uint8)[None, :].repeat(n, 0)
    qual = np.full((n, length), ord("I"), dtype=np.uint8)
    nl = np.full((n, 1), ord("\n"), dtype=np.uint8)
    rec = np.concatenate([head, BASES[mat.astype(np.int64)], tail, qual, nl],
                         axis=1)
    with open(path, "wb") as f:
        f.write(rec.tobytes())


# --- the 10x BAM -----------------------------------------------------------

FLAG_PAIRED, FLAG_REVERSE, FLAG_MATE_REVERSE = 0x1, 0x10, 0x20
FLAG_FIRST, FLAG_LAST = 0x40, 0x80
R1_FLAG = FLAG_PAIRED | FLAG_FIRST | FLAG_MATE_REVERSE
R2_FLAG = FLAG_PAIRED | FLAG_LAST | FLAG_REVERSE
MAPQ = 60
BAM_HEADER_TEXT = "@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:chr1\tLN:1000000\n"
BAM_REFERENCES = (("chr1", 1_000_000),)


@dataclass
class TenxRecords:
    """The records of a 10x BAM, in file order (R1, R2 of each pair; the
    pairs of a group together).  ``seq`` is the stored, reference-forward
    sequence; ``qname``, ``cb`` and ``ub`` are per pair / per group."""

    seq: np.ndarray        # (N, read_len) int8
    flag: np.ndarray       # (N,) int
    pos: np.ndarray
    mpos: np.ndarray
    tlen: np.ndarray
    qual: int
    pairs_per_group: int
    cb: List[str]          # per group, with the "-1" suffix
    ub: List[str]          # per group
    on_library: np.ndarray  # (groups,) bool: the molecule is a feature

    @property
    def n_groups(self) -> int:
        return len(self.cb)

    def qname(self, i: int) -> str:
        return f"q{i // 2:08d}"


def _rows_as_str(mat: np.ndarray) -> List[str]:
    width = mat.shape[1]
    flat = mat.astype(np.uint8).tobytes().decode("ascii")
    return [flat[i * width: (i + 1) * width] for i in range(mat.shape[0])]


def tenx_records(lib: Library, traffic: dict, n_groups: int,
                 seed: int) -> TenxRecords:
    rng = rng_for(seed, 3)
    read_len, gap = traffic["read_len"], traffic["mate_gap"]
    ppg = traffic["pairs_per_group"]
    span = 2 * read_len + gap
    background = rng.integers(
        0, 4, (traffic["background_transcripts"], traffic["background_len"]),
        dtype=np.int8)
    features = np.stack(lib.codes)
    on_lib = _exact(rng, n_groups, traffic["library_share"])
    n_on = int(on_lib.sum())
    mol = np.empty(n_groups, dtype=np.int64)
    mol[on_lib] = rng.permutation(np.arange(n_on) % len(features))
    mol[~on_lib] = rng.integers(0, len(background), n_groups - n_on)
    pair_group = np.repeat(np.arange(n_groups), ppg)
    n_pairs = len(pair_group)
    pair_on = on_lib[pair_group]
    pair_mol = mol[pair_group]
    seq = np.empty((2 * n_pairs, read_len), dtype=np.int8)
    for source, sel in ((features, pair_on), (background, ~pair_on)):
        idx = np.flatnonzero(sel)
        starts = rng.integers(0, source.shape[1] - span + 1, len(idx))
        cols = starts[:, None] + np.arange(read_len)
        seq[2 * idx] = source[pair_mol[idx][:, None], cols]
        seq[2 * idx + 1] = source[pair_mol[idx][:, None],
                                  cols + read_len + gap]
    _mutate(rng, seq, traffic)
    p = np.tile(np.arange(ppg), n_groups)
    flag = np.empty(2 * n_pairs, dtype=np.int64)
    flag[0::2], flag[1::2] = R1_FLAG, R2_FLAG
    pos = np.empty(2 * n_pairs, dtype=np.int64)
    pos[0::2], pos[1::2] = 100 + p, 200 + p
    mpos = np.empty(2 * n_pairs, dtype=np.int64)
    mpos[0::2], mpos[1::2] = 200 + p, 100 + p
    tlen = np.empty(2 * n_pairs, dtype=np.int64)
    tlen[0::2], tlen[1::2] = 150, -150
    umis = _rows_as_str(BASES[rng.integers(0, 4, (n_groups,
                                                  traffic["umi_len"]))])
    return TenxRecords(seq=seq, flag=flag, pos=pos, mpos=mpos, tlen=tlen,
                       qual=traffic["quality"], pairs_per_group=ppg,
                       cb=cell_barcodes(n_groups), ub=umis,
                       on_library=on_lib)


def cell_barcodes(n: int) -> List[str]:
    """16-base cell barcodes with the gem-group suffix, distinct per group:
    the group's index written in base 4."""
    idx = np.arange(n, dtype=np.int64)
    digits = (idx[:, None] >> (2 * np.arange(15, -1, -1))) & 3
    return [s + "-1" for s in _rows_as_str(BASES[digits])]


# BAM SEQ nibbles of A, C, G, T (the SAM spec's "=ACMGRSVTWYHKDBN")
_NIBBLE = np.array([1, 2, 4, 8], dtype=np.uint8)
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BGZF_STEP = 60000  # uncompressed bytes a block; BGZF blocks stay < 64 KiB


def _bgzf(payload: bytes) -> bytes:
    comp = zlib.compressobj(1, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + b"\x06\x00" + b"BC\x02\x00"
              + struct.pack("<H", len(cdata) + 25))
    return (header + cdata + struct.pack("<I", zlib.crc32(payload))
            + struct.pack("<I", len(payload)))


def _column(values: np.ndarray, fmt: str) -> np.ndarray:
    """(N,) integers -> (N, size) little-endian bytes."""
    return np.ascontiguousarray(values.astype(fmt)).view(np.uint8).reshape(
        len(values), -1)


def _text_column(strings: List[str]) -> np.ndarray:
    return np.frombuffer("".join(strings).encode("ascii"),
                         dtype=np.uint8).reshape(len(strings), -1)


def bam_bytes(recs: TenxRecords) -> bytes:
    """The uncompressed BAM stream: header and fixed-size records, built as
    one (N, record) byte matrix."""
    n, read_len = recs.seq.shape
    ppg = recs.pairs_per_group
    group = np.arange(n) // (2 * ppg)
    names = _text_column([f"q{i:08d}\x00" for i in range(n // 2)])
    names = np.repeat(names, 2, axis=0)
    cb = _text_column(recs.cb)[group]
    ub = _text_column(recs.ub)[group]
    codes = _NIBBLE[recs.seq.astype(np.int64)]
    if read_len % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    seq = (codes[:, 0::2] << 4) | codes[:, 1::2]
    qual = np.full((n, read_len), recs.qual, dtype=np.uint8)
    zero = np.zeros((n, 1), dtype=np.uint8)

    def tag(name: str, text: np.ndarray) -> list:
        head = np.frombuffer(name.encode("ascii") + b"Z", np.uint8)
        return [np.repeat(head[None, :], n, 0), text, zero]

    body_parts = [
        _column(np.zeros(n), "<i4"),                       # refID
        _column(recs.pos, "<i4"),
        _column(np.full(n, names.shape[1]), "<u1"),        # l_read_name
        _column(np.full(n, MAPQ), "<u1"),
        _column(np.zeros(n), "<u2"),                       # bin
        _column(np.zeros(n), "<u2"),                       # n_cigar_op
        _column(recs.flag, "<u2"),
        _column(np.full(n, read_len), "<i4"),              # l_seq
        _column(np.zeros(n), "<i4"),                       # next refID
        _column(recs.mpos, "<i4"),
        _column(recs.tlen, "<i4"),
        names, seq, qual,
        *tag("CB", cb), *tag("UB", ub), *tag("CR", cb[:, :-2]),
        *tag("UR", ub),
    ]
    body_len = sum(p.shape[1] for p in body_parts)
    rows = np.concatenate([_column(np.full(n, body_len), "<i4"),
                           *body_parts], axis=1)
    text = BAM_HEADER_TEXT.encode("ascii")
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text
    head += struct.pack("<i", len(BAM_REFERENCES))
    for name, length in BAM_REFERENCES:
        raw = name.encode("ascii") + b"\x00"
        head += struct.pack("<i", len(raw)) + raw + struct.pack("<i", length)
    return head + rows.tobytes()


def write_bam(path: str, recs: TenxRecords) -> None:
    payload = memoryview(bam_bytes(recs))
    with open(path, "wb") as f:
        for i in range(0, len(payload), _BGZF_STEP):
            f.write(_bgzf(bytes(payload[i: i + _BGZF_STEP])))
        f.write(_BGZF_EOF)
