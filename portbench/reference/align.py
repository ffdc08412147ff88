"""The reference's alignment of reads, in plain torch, from the inputs alone.

nimble's per-read function (``pseudoalign`` over
``map_read_with_mismatch``, the semantics of the port's
``core/walk.py`` and ``core/filters.py``):

1. a read shorter than 40 bases fails as a short read, one whose base
   entropy is under 1.75 bits as low entropy;
2. the anchor is the read's first 30-mer that occurs in the doubled
   library; without one the read has no match;
3. the candidates are every (row, offset) at which the anchor occurs;
4. the walk goes forward from the anchor's end, then left from its start,
   one base a step over all live candidates: candidates whose row has no
   base there leave; if a live candidate matches the read's base the live
   set becomes the matching ones and the score gains one, otherwise the
   live set keeps those with a base and a mismatch is counted; a direction
   ends when no live candidate has a base;
5. the result is the distinct rows left live, the score (the anchor's 30
   bases and every matched base) and the mismatches, which the score and
   mismatch gates of ``filter_alignment_by_metrics`` then judge.

Here all distinct reads of a batch walk together as (reads, candidates)
tensors, in blocks; the index is a sorted array of the library's 30-mer
keys with their postings.  Nothing here is the program's: not its
bucketed tables, its fingerprints or its kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import host

K = host.KMER_SIZE
BLOCK = 1 << 15  # distinct reads a block


class KmerIndex:
    """Every 30-mer of the doubled rows as a 60-bit key, sorted, with its
    postings (row, offset) in row then offset order."""

    def __init__(self, rows: Sequence[np.ndarray], device):
        self.device = torch.device(device)
        lens = np.array([len(r) for r in rows], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        flat = torch.from_numpy(np.concatenate(rows).astype(np.int64))
        flat = flat.to(self.device)
        keys = _keys(flat[None, :], K)[0]
        pos = torch.arange(keys.numel(), device=self.device)
        row_of = torch.from_numpy(np.repeat(np.arange(len(rows)), lens))
        row_of = row_of.to(self.device)[: keys.numel()]
        start_of = torch.from_numpy(starts).to(self.device)[row_of]
        len_of = torch.from_numpy(lens).to(self.device)[row_of]
        off = pos - start_of
        ok = off + K <= len_of
        keys, row_of, off = keys[ok], row_of[ok], off[ok]
        order = torch.sort(keys, stable=True).indices
        keys = keys[order]
        self.post_row, self.post_off = row_of[order], off[order]
        self.keys, counts = torch.unique_consecutive(keys, return_counts=True)
        self.post_start = torch.cumsum(counts, 0) - counts
        self.post_count = counts
        self.flat = flat
        self.row_start = torch.from_numpy(starts).to(self.device)
        self.row_len = torch.from_numpy(lens).to(self.device)


def _keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(B, W) int64 codes -> (B, W - k + 1) 60-bit keys, first base most
    significant."""
    n = codes.shape[1] - k + 1
    acc = torch.zeros((codes.shape[0], max(n, 0)), dtype=torch.int64,
                      device=codes.device)
    for j in range(k):
        acc = (acc << 2) | codes[:, j: j + n]
    return acc


def walk(index: KmerIndex, reads: np.ndarray, lens: np.ndarray):
    """Anchor and walk of (B, W) int8 reads with their lengths.

    Returns numpy (has_anchor (B,) bool, score, mismatches (B,) int64,
    eq (B, C) int64 sorted distinct live rows padded with -1)."""
    dev = index.device
    B, W = reads.shape
    r = torch.from_numpy(reads.astype(np.int64)).to(dev)
    ln = torch.from_numpy(np.asarray(lens, dtype=np.int64)).to(dev)
    P = max(W - K + 1, 0)
    keys = _keys(r, K)
    pos = torch.arange(P, device=dev)
    slot = torch.searchsorted(index.keys, keys).clamp(max=index.keys.numel()
                                                     - 1)
    found = (index.keys[slot] == keys) & (pos[None, :] + K <= ln[:, None])
    has = found.any(1)
    anchor = torch.where(found, pos[None, :], P).amin(1).clamp(max=P - 1)
    aslot = slot.gather(1, anchor[:, None])[:, 0]
    count = torch.where(has, index.post_count[aslot], 0)
    C = max(int(count.max()) if B else 0, 1)
    lane = torch.arange(C, device=dev)
    live = lane[None, :] < count[:, None]
    pidx = (index.post_start[aslot][:, None] + lane).clamp(
        max=index.post_row.numel() - 1)
    rows = index.post_row[pidx]
    offs = index.post_off[pidx]
    rstart = index.row_start[rows]
    rlen = index.row_len[rows]
    score = torch.full((B,), K, dtype=torch.int64, device=dev)
    mm = torch.zeros(B, dtype=torch.int64, device=dev)
    last = index.flat.numel() - 1

    def step(live, ok, read_base, ref_pos):
        has_base = live & ok
        base = index.flat[(rstart + ref_pos).clamp(0, last)]
        match = has_base & (base == read_base[:, None])
        any_m, any_h = match.any(1), has_base.any(1)
        live = torch.where(any_m[:, None], match,
                           torch.where(any_h[:, None], has_base, live))
        return live, any_m, any_h & ~any_m

    for t in range(max(W - K, 0)):
        rp = anchor + K + t
        on = (rp < ln)[:, None]
        read_base = r.gather(1, rp.clamp(max=W - 1)[:, None])[:, 0]
        ref = offs + K + t
        live, hit, miss = step(live, on & (ref < rlen), read_base, ref)
        score += hit
        mm += miss
    for j in range(1, P):
        on = (j <= anchor)[:, None]
        read_base = r.gather(1, (anchor - j).clamp(min=0)[:, None])[:, 0]
        ref = offs - j
        live, hit, miss = step(live, on & (ref >= 0), read_base, ref)
        score += hit
        mm += miss

    eq = torch.where(live, rows, torch.iinfo(torch.int64).max)
    eq = torch.sort(eq, 1).values
    dup = torch.zeros_like(live)
    dup[:, 1:] = eq[:, 1:] == eq[:, :-1]
    eq = torch.where(dup, torch.iinfo(torch.int64).max, eq)
    eq = torch.sort(eq, 1).values
    eq = torch.where(eq == torch.iinfo(torch.int64).max, -1, eq)
    return (has.cpu().numpy(), score.cpu().numpy(), mm.cpu().numpy(),
            eq.cpu().numpy())


def _entropy_ok(reads: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The entropy gate, exact: each distinct (A, T, C, G) count is judged
    by the frozen ``shannon_entropy_from_counts``."""
    W = reads.shape[1]
    inside = np.arange(W)[None, :] < lens[:, None]
    counts = np.stack([((reads == c) & inside).sum(1) for c in (0, 3, 1, 2)],
                      axis=1)
    uniq, inv = np.unique(counts, axis=0, return_inverse=True)
    ok = np.array([
        host.shannon_entropy_from_counts(*map(int, u), int(u.sum()))
        >= host.MIN_ENTROPY_SCORE for u in uniq], dtype=bool)
    return ok[inv.reshape(-1)]


Result = Tuple[Optional[host.AlignmentScore], Optional[host.FilterRec]]


def align(index: KmerIndex, seqs: Sequence[Optional[np.ndarray]],
          config: host.AlignFilterConfig) -> List[Result]:
    """``pseudoalign`` of every read (None: a skipped read, which gets
    (None, None)), each distinct read walked once."""
    out: List[Result] = [(None, None)] * len(seqs)
    live = [i for i, s in enumerate(seqs) if s is not None]
    if not live:
        return out
    width = max(len(seqs[i]) for i in live)
    # a read's key: its codes, zero past its end, and its length
    mat = np.zeros((len(live), width + 2), dtype=np.uint8)
    for row, i in enumerate(live):
        s = seqs[i]
        mat[row, : len(s)] = s
        mat[row, width: width + 2] = (len(s) >> 8, len(s) & 0xFF)
    uniq, inv = np.unique(mat, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    ulens = ((uniq[:, width].astype(np.int64) << 8)
             | uniq[:, width + 1].astype(np.int64))
    ureads = np.ascontiguousarray(uniq[:, :width].astype(np.int8))
    results = _align_distinct(index, ureads, ulens, config)
    for row, i in enumerate(live):
        out[i] = results[inv[row]]
    return out


def _align_distinct(index, reads, lens, config) -> List[Result]:
    n = len(lens)
    short = lens < host.MIN_READ_LENGTH
    ent_ok = _entropy_ok(reads, lens)
    res: List[Result] = [None] * n
    for b0 in range(0, n, BLOCK):
        sl = slice(b0, min(n, b0 + BLOCK))
        has, score, mm, eq = walk(index, reads[sl], lens[sl])
        eq_keys, eq_inv = np.unique(eq, axis=0, return_inverse=True)
        eq_inv = eq_inv.reshape(-1)
        eq_lists = [[int(x) for x in row if x >= 0] for row in eq_keys]
        for j in range(sl.stop - sl.start):
            i = b0 + j
            if short[i]:
                res[i] = (None, (host.FilterReason.SHORT_READ, 0.0, 0))
            elif not ent_ok[i]:
                res[i] = (None, (host.FilterReason.HIGH_ENTROPY, 0.0, 0))
            elif not has[j]:
                res[i] = (None, (host.FilterReason.NO_MATCH, 0.0, 0))
            else:
                s, m = int(score[j]), int(mm[j])
                norm = s / int(lens[i])
                if config.discard_nonzero_mismatch and m != 0:
                    res[i] = (None, (
                        host.FilterReason.DISCARDED_NONZERO_MISMATCH, 0.0, 0))
                    continue
                res[i] = host.filter_alignment_by_metrics(
                    list(eq_lists[eq_inv[j]]), s, norm,
                    config.score_threshold, config.score_percent,
                    config.discard_multiple_matches, config.num_mismatches,
                    m)
    return res
