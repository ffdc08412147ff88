"""Fingerprint anchor probe over the bucketed table, in torch.

Counterpart: ``engine_fast._probe_encoded`` + ``_probe_bucketed``.  Each
read's anchor is its first k-mer position with a fingerprint hit in its
bucket row, and the lowest hitting lane at that position; only that lane's
full key is then verified, and a mismatch sets ``fp_bad`` (host rescue) with
no further search.  The JAX probe splits the position range in two phases
to save TPU gather volume; its results are identical for every split, so
this is the single-phase form: one max over an encoded
``((P - pos) << 8) | (W - lane)`` value.
"""

from __future__ import annotations

import torch

from nimble_tpu_torch.ops.device_tables import IndexTables, take
from nimble_tpu_torch.ops.hashing import (
    as_int32_bits,
    hash_kmer,
    kmer_fp,
    rolling_keys,
)


def probe_bucketed(reads: torch.Tensor, read_lens: torch.Tensor,
                   t: IndexTables, *, p_limit: int, lib=None):
    """Anchor probe of (B, Lmax) 2-bit codes; positions [0, p_limit) only.
    With stacked tables, ``lib`` (B,) int64 names each read's library.

    Returns (has_anchor (B,) bool, anchor, bucket_sel, lane_sel (B,) int64,
    fp_bad (B,) bool).
    """
    B, Lmax = reads.shape
    k, W = t.k, t.width
    P = min(Lmax - k + 1, p_limit)
    dev = reads.device

    lo, hi = rolling_keys(reads[:, : P + k - 1], k)          # (B, P) int64
    h = hash_kmer(lo, hi) & t.bucket_mask
    fp = as_int32_bits(kmer_fp(lo, hi))

    pos = torch.arange(P, device=dev)
    pos_valid = (pos[None, :] + k) <= read_lens[:, None]
    lane_prio = W - torch.arange(W, device=dev)               # (W,)

    # lane_m: W - first hitting lane (0 = miss); the first hop with any hit
    # wins, as the table was filled by linear probing over buckets
    lane_m = torch.zeros((B, P), dtype=torch.int64, device=dev)
    hop_rec = torch.zeros((B, P), dtype=torch.int64, device=dev)
    for hop in range(t.max_probe):
        bidx = (h + hop) & t.bucket_mask
        bfps = take(t.bkey_fp, lib, bidx)                     # (B, P, W)
        enc = torch.where(bfps == fp[:, :, None], lane_prio, 0).amax(dim=2)
        new = (lane_m == 0) & (enc > 0)
        lane_m = torch.where(new, enc, lane_m)
        hop_rec = torch.where(new, hop, hop_rec)

    pos_prio = P - pos                                        # (P,)
    m = torch.where(
        (lane_m > 0) & pos_valid, (pos_prio[None, :] << 8) | lane_m, 0
    ).amax(dim=1)

    has_anchor = m > 0
    anchor = torch.where(has_anchor, P - (m >> 8), 0)
    lane_sel = torch.where(has_anchor, W - (m & 0xFF), 0)

    def at_anchor(a):
        return a.gather(1, anchor[:, None])[:, 0]

    bucket_sel = torch.where(
        has_anchor, (at_anchor(h) + at_anchor(hop_rec)) & t.bucket_mask, 0
    )
    lo_sel = take(t.bkey_lo, lib, bucket_sel, lane_sel)
    hi_sel = take(t.bkey_hi, lib, bucket_sel, lane_sel)
    fp_bad = has_anchor & (
        (lo_sel != as_int32_bits(at_anchor(lo)))
        | (hi_sel != as_int32_bits(at_anchor(hi)))
    )
    return has_anchor, anchor, bucket_sel, lane_sel, fp_bad
