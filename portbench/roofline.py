"""The least time the ``probe_walk_filter`` pass could take on its inputs.

A frozen copy of ``chip_smoke._probe_walk_work`` (with ``_walk_steps`` and
``_walk_ops``) for one library's tables: the bytes the pass needs, each
read once, and its 32-bit operations.  The probe and the candidate gather
it counts are recomputed here in plain torch (copies of the port's
``ops/hashing.py``, ``ops/probe.py``'s ``probe_encoded`` and
``ops/compact.py``'s ``probe_candidates``), so a change to the program's
ops leaves the count as it is.  It reads the program's tables, which are
the kernel's inputs.

The peaks are NVIDIA's for the H100 SXM at its full 700 W: 3.35 TB/s of
HBM, and 67 T 32-bit operations a second.  The card has no published
integer rate outside the tensor cores: the float32 rate is assumed for the
walk's integer operations.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
M32 = 0xFFFFFFFF
FP_SALT = 0x7FEB352D  # ops/device_index.FP_SALT


def pack_reads(mat: np.ndarray, lens: np.ndarray, bucket: int) -> np.ndarray:
    """(m, width) int8 codes -> (m, ceil(bucket/4) + 2) uint8 rows, the
    kernel's input: base j at bits 2*(j%4) of byte j//4, then the
    little-endian uint16 length (``models/aligner.pack_reads``)."""
    m, width = mat.shape
    nb = (bucket + 3) // 4
    buf = np.zeros((m, nb + 2), dtype=np.uint8)
    src = np.zeros((m, nb * 4), dtype=np.uint8)
    take = min(width, bucket)
    src[:, :take] = mat[:, :take].astype(np.uint8) & 3
    q = src.reshape(m, nb, 4)
    buf[:, :nb] = q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4) | (
        q[:, :, 3] << 6)
    buf[:, nb] = (lens & 0xFF).astype(np.uint8)
    buf[:, nb + 1] = (lens >> 8).astype(np.uint8)
    return buf


def _mul32(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _fmix32(x):
    x = x.to(torch.int64) & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _hash_kmer(lo, hi):
    return _fmix32((lo & M32) ^ _fmix32(hi))


def _kmer_fp(lo, hi):
    hi = hi.to(torch.int64) & M32
    rot = ((hi << 16) & M32) | (hi >> 16)
    return _fmix32(rot ^ _fmix32((lo & M32) ^ FP_SALT))


def _rolling_keys(codes, k: int):
    B, width = codes.shape
    P = width - k + 1
    half = k // 2
    c = codes.to(torch.int64)

    def window(w: int, start: int):
        acc = torch.zeros((B, P), dtype=torch.int64, device=codes.device)
        for j in range(w):
            acc = (acc << 2) | c[:, start + j: start + j + P]
        return acc

    return window(k - half, half), window(half, 0)


def _as_int32_bits(x):
    x = x & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _unpack_reads(packed, bucket: int):
    nb = (bucket + 3) // 4
    by = packed[:, :nb].to(torch.int32)
    j = torch.arange(bucket, device=packed.device)
    reads = (by[:, j >> 2] >> ((j & 3) * 2)) & 3
    lens = packed[:, nb].to(torch.int32) | (packed[:, nb + 1].to(torch.int32)
                                            << 8)
    return reads, lens


def _probe_encoded(reads, read_lens, t, p_limit: int):
    B, Lmax = reads.shape
    k, W = t.k, t.width
    P = min(Lmax - k + 1, p_limit)
    dev = reads.device
    lo, hi = _rolling_keys(reads[:, : P + k - 1], k)
    h = _hash_kmer(lo, hi) & t.bucket_mask
    fp = _as_int32_bits(_kmer_fp(lo, hi))
    pos = torch.arange(P, device=dev)
    pos_valid = (pos[None, :] + k) <= read_lens[:, None]
    lane_prio = W - torch.arange(W, device=dev)
    lane_m = torch.zeros((B, P), dtype=torch.int64, device=dev)
    hop_rec = torch.zeros((B, P), dtype=torch.int64, device=dev)
    for hop in range(t.max_probe):
        bfps = t.bkey_fp[(h + hop) & t.bucket_mask]
        enc = torch.where(bfps == fp[:, :, None], lane_prio, 0).amax(dim=2)
        new = (lane_m == 0) & (enc > 0)
        lane_m = torch.where(new, enc, lane_m)
        hop_rec = torch.where(new, hop, hop_rec)
    m = torch.where((lane_m > 0) & pos_valid,
                    ((P - pos)[None, :] << 8) | lane_m, 0).amax(dim=1)
    return m, h, lo, hi, hop_rec


def _probe_candidates(packed, t, bucket: int, c_max: int):
    reads, read_lens = _unpack_reads(packed, bucket)
    m, h, _lo, _hi, hop = _probe_encoded(reads, read_lens, t,
                                         bucket - t.k + 1)
    P = h.shape[1]
    has = m > 0
    anchor = torch.where(has, P - (m >> 8), 0)

    def at_anchor(a):
        return a.gather(1, anchor[:, None])[:, 0]

    lane_sel = torch.where(has, t.width - (m & 0xFF), 0)
    bucket_sel = torch.where(has, (at_anchor(h) + at_anchor(hop))
                             & t.bucket_mask, 0)
    astart = t.bstart[bucket_sel, lane_sel]
    acnt = torch.where(has, t.bcount[bucket_sel, lane_sel], 0)
    c_idx = torch.arange(c_max, device=packed.device)
    pidx = (astart.to(torch.int64)[:, None] + c_idx).clamp(
        0, t.postings_row.shape[-1] - 1)
    return SimpleNamespace(
        read_lens=read_lens, anchor=anchor, astart=astart,
        rows=t.postings_row[pidx].to(torch.int64),
        offs=t.postings_off[pidx].to(torch.int64),
        live0=c_idx[None, :] < acnt.clamp(max=c_max)[:, None])


def _walk_steps(cand, t, bucket: int):
    k, P = t.k, bucket - t.k + 1
    row_len = t.row_lengths.reshape(-1)[cand.rows].long()
    anchor = cand.anchor.long()[:, None]
    base = cand.offs - anchor
    f_lo = (anchor + k).clamp(k, bucket)
    f_hi = torch.minimum((row_len - base).clamp(-1, bucket),
                         cand.read_lens.long()[:, None].clamp(max=bucket))
    l_lo = (-base).clamp(0, bucket)
    l_hi = anchor.clamp(0, P - 1)
    live = cand.live0
    forward = (torch.where(live, (f_hi - f_lo).clamp(min=0), 0),
               (torch.where(live, f_hi, 0).amax(1) - f_lo[:, 0]).clamp(min=0))
    left = (torch.where(live, (l_hi - l_lo).clamp(min=0), 0),
            (l_hi[:, 0] - torch.where(live, l_lo, bucket).amin(1))
            .clamp(min=0))
    return live, (forward, left)


def _walk_ops(cand, t, bucket: int) -> int:
    live, directions = _walk_steps(cand, t, bucket)
    nr = (bucket + 15) // 16
    n_live = live.sum(1)
    one = n_live == 1
    ops = 5 * nr * int(n_live.sum())
    for lane_steps, read_steps in directions:
        ops += 3 * int(((lane_steps + 31) // 32)[one].sum())
        windows = ((read_steps + 31) // 32)[n_live > 1]
        ops += int((windows * (6 * n_live[n_live > 1] + 4)).sum())
    return ops


def probe_walk_work(packed, t, bucket: int, c_max: int, full: bool):
    """(bytes, operations) one launch of ``probe_walk_filter`` needs on
    ``packed`` rows against one library's tables ``t``: the packed rows;
    the distinct fingerprint rows the first-hit search reads; the distinct
    anchor slots' key halves, bstart and bcount; the live candidates'
    distinct postings, row spans and reference windows; the distinct s_min
    entries; the results written.  Operations: ~40 a probed position and W
    compares a hop read, plus the event walk's."""
    B = packed.shape[0]
    dev = packed.device
    reads, read_lens = _unpack_reads(packed, bucket)
    k, W, mp = t.k, t.bkey_fp.shape[-1], t.max_probe
    m, h, _lo, _hi, hop = _probe_encoded(reads, read_lens, t,
                                         bucket - k + 1)
    P = h.shape[1]
    has = m > 0
    anchor = torch.where(has, P - (m >> 8), 0)
    n_valid = (read_lens.long() - k + 1).clamp(0, P)
    last = torch.where(has, anchor, n_valid - 1)
    pos = torch.arange(P, device=dev)
    probed = pos[None, :] <= last[:, None]
    at_anchor = has[:, None] & (pos[None, :] == anchor[:, None])
    n_hops = torch.where(at_anchor, hop + 1, mp)
    hops = torch.arange(mp, device=dev)
    read = probed[:, :, None] & (hops < n_hops[:, :, None])
    fp_rows = ((h[:, :, None] + hops) & t.bucket_mask)[read].unique()
    at = anchor[:, None]
    bucket_sel = torch.where(has, (h.gather(1, at) + hop.gather(1, at))[:, 0]
                             & t.bucket_mask, 0)
    lane_sel = torch.where(has, W - (m & 0xFF), 0)
    slots = (bucket_sel * W + lane_sel).unique()
    cand = _probe_candidates(packed, t, bucket, c_max)
    live = cand.live0
    c_idx = torch.arange(c_max, device=dev)
    n_post = t.postings_row.shape[-1]
    postings = (cand.astart.long()[:, None] + c_idx).clamp(
        0, n_post - 1)[live].unique()
    spans = cand.rows[live].unique()
    nr = (bucket + 15) // 16
    n_words = t.ref_codes_packed.shape[-1]
    start = (t.row_starts.reshape(-1)[cand.rows].long() + cand.offs
             - cand.anchor[:, None] + t.ref_pad)
    w0 = (start >> 4).clamp(0, n_words - nr - 1)
    words = (w0[..., None] + torch.arange(nr + 1, device=dev))[live].unique()
    n_smin = 0 if full else int(torch.unique(
        read_lens.long().clamp(0, bucket)).numel())
    n_bytes = (packed.numel() + 4 * W * fp_rows.numel() + 16 * slots.numel()
               + 8 * postings.numel() + 8 * spans.numel()
               + 4 * words.numel() + 4 * n_smin + 4 * B * (3 if full else 2))
    n_ops = (40 * int(probed.sum()) + W * int(read.sum())
             + _walk_ops(cand, t, bucket))
    return n_bytes, n_ops


def least_seconds(n_bytes: int, n_ops: int) -> float:
    """The larger of the bytes over the HBM peak and the operations over
    the 32-bit peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S)
