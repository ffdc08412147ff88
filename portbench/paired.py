"""Paired-end FASTQ of the ``fastq_paired`` kind (the ``paired150`` mix), made
from a cell's seed.

Each forward row of the library stands inside a transcript: the row between
two flanks of ``flank`` random bases, drawn once a seed and fixed for that
row.  Fragments go to the rows in turn, as ``generate.fastq_reads`` deals
them; a fragment's length is uniform in ``fragment_len``, its start
uniform over the positions at which it overlaps its row by at least
``min_overlap`` bases, and exactly half of the fragments are read off the
transcript's reverse complement (an unstranded prep).  The mates are FR:
R1 the fragment's first ``read_len`` bases, R2 the reverse complement of
its last ``read_len``.  Exactly ``substitution_share`` of the fragments get
one substitution, in R1 for half of them and in R2 for the other half, and,
of the others, ``junk_share`` of all become random bases in both mates;
then each fragment is read ``copies`` times, a duplicate repeating both
mates exactly.  Every seed draws the same counts; the seed moves only
sequences, positions and order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench import generate


@dataclass
class Pairs:
    """The pairs of a pass, in file order, and the fragment each came from.

    ``r1`` and ``r2`` are (pairs, read_len) int8; the per-fragment arrays
    are indexed by ``fragment`` (each pair's fragment)."""

    r1: np.ndarray
    r2: np.ndarray
    fragment: np.ndarray    # (pairs,) the pair's fragment
    row: np.ndarray         # (fragments,) its forward row of the library
    reverse: np.ndarray     # (fragments,) bool: off the reverse complement
    start: np.ndarray       # (fragments,) on the forward transcript
    length: np.ndarray      # (fragments,)
    substituted: np.ndarray  # (fragments,) 0 none, 1 in R1, 2 in R2
    junk: np.ndarray        # (fragments,) bool
    transcripts: np.ndarray  # (rows, flank + row length + flank) int8
    flank: int


def transcripts(lib: generate.Library, traffic: dict,
                rng: np.random.Generator) -> np.ndarray:
    """Each forward row between its two random flanks (rows of one
    length)."""
    rows = np.stack(lib.codes)
    flank = traffic["flank"]
    left = rng.integers(0, 4, (len(rows), flank), dtype=np.int8)
    right = rng.integers(0, 4, (len(rows), flank), dtype=np.int8)
    return np.ascontiguousarray(np.concatenate([left, rows, right], axis=1))


def fastq_pairs(lib: generate.Library, traffic: dict, n_pairs: int,
                seed: int) -> Pairs:
    rng = generate.rng_for(seed, 4)
    read_len, flank = traffic["read_len"], traffic["flank"]
    lo, hi = traffic["fragment_len"]
    overlap = traffic["min_overlap"]
    copies = np.asarray(traffic["copies"])
    row_len = len(lib.codes[0])
    assert read_len <= lo <= hi <= flank + overlap
    assert all(len(c) == row_len for c in lib.codes)
    tx = transcripts(lib, traffic, rng)
    n_frag = -(-n_pairs * len(copies) // int(copies.sum()))
    while np.resize(copies, n_frag).sum() < n_pairs:
        n_frag += 1
    row_of = rng.permutation(np.arange(n_frag) % len(lib.codes))
    length = rng.integers(lo, hi + 1, n_frag)
    # starts overlapping the row [flank, flank + row_len) by >= overlap
    first = flank + overlap - length
    start = first + rng.integers(0, flank + row_len - overlap - first + 1)
    reverse = generate._exact(rng, n_frag, 0.5)
    cols = np.arange(read_len)
    head = tx[row_of[:, None], start[:, None] + cols]
    tail = tx[row_of[:, None], (start + length - read_len)[:, None] + cols]
    # off the reverse complement the fragment is the reverse complement of
    # the forward one: R1 is then the forward fragment's tail, reverse
    # complemented, and R2 its head
    r1 = np.where(reverse[:, None], generate.revcomp_codes(tail), head)
    r2 = np.where(reverse[:, None], head, generate.revcomp_codes(tail))
    r1, r2 = r1.astype(np.int8), r2.astype(np.int8)
    order = rng.permutation(n_frag)
    n_sub = int(round(traffic["substitution_share"] * n_frag))
    n_junk = int(round(traffic["junk_share"] * n_frag))
    sub, junk = order[:n_sub], order[n_sub: n_sub + n_junk]
    in_r2 = generate._exact(rng, n_sub, 0.5)
    pos = rng.integers(0, read_len, n_sub)
    shift = rng.integers(1, 4, n_sub)
    for mates, sel in ((r1, ~in_r2), (r2, in_r2)):
        at = (sub[sel], pos[sel])
        mates[at] = (mates[at] + shift[sel]) % 4
    r1[junk] = rng.integers(0, 4, (n_junk, read_len), dtype=np.int8)
    r2[junk] = rng.integers(0, 4, (n_junk, read_len), dtype=np.int8)
    substituted = np.zeros(n_frag, dtype=np.int8)
    substituted[sub] = np.where(in_r2, 2, 1)
    is_junk = np.zeros(n_frag, dtype=bool)
    is_junk[junk] = True
    times = rng.permutation(np.resize(copies, n_frag))
    ids = rng.permutation(np.repeat(np.arange(n_frag), times))[:n_pairs]
    return Pairs(r1=np.ascontiguousarray(r1[ids]),
                 r2=np.ascontiguousarray(r2[ids]), fragment=ids, row=row_of,
                 reverse=reverse, start=start, length=length,
                 substituted=substituted, junk=is_junk, transcripts=tx,
                 flank=flank)
