"""Throughput probe: row gathers from a shared-memory table vs device memory.

The port of ``scripts/probe_mosaic_gather.py``: the same table (4096, 8) of
uint32 values and the same (65536,) indices from ``default_rng(0)``, the
same printed lines.  On a CUDA card the three kernels of
``csrc/gather_rows.cu`` (``ops/gather.py``) gather rows of a table held on
chip (take and taa, on the probe's broadcast index, through L1; lane from
one table row staged in shared memory a block), against
``torch.index_select``, the gather from device memory (the probe's XLA
``jnp.take`` baseline); each must give the baseline's bits (``match=``).
Then the probe's two XLA sub-ops at its bench shapes, as plain torch ops:
the funnel-shift + match of the span stage (B = 8192, C = 8, NWr = 6) and
the sliding-window build + row take.
Times are the best of 5 rounds of 20 calls, between CUDA events on the
card.

    python -m nimble_tpu_torch.probe_gather [--cpu] [--table-rows N]
                                           [--rows M] [--batch B]

``--cpu`` runs the plain versions on the CPU (host clock); the size flags
shrink the run.  Exits non-zero when a kernel disagrees with the baseline,
and when there is no card without ``--cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from nimble_tpu_torch.ops.gather import gather_lane, gather_taa, gather_take

M32 = 0xFFFFFFFF
W = 8      # table row width (uint32 words)
C = 8      # candidates per read in the funnel+match sub-op
NWR = 6    # read words per candidate (96 bases)


def timed(fn, device: torch.device, reps: int = 20):
    """Best seconds per call over 5 rounds of ``reps`` calls, and the last
    output."""
    out = fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = fn()
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            secs = time.perf_counter() - t0
        best = min(best, secs / reps)
    return best, out


def _u32(rng, size) -> np.ndarray:
    """uint32 draws, held as int32 bit patterns."""
    return rng.integers(0, 2**32, size=size, dtype=np.uint32).view(np.int32)


def funnel_match(words, phase, reads, B: int):
    """The span stage's funnel shift + 16-base match words (uint32 in int64
    masked to 32 bits): (B*C, NWR+1) words, (B*C,) phases, (B, 16*NWR)
    reads -> (B, C, NWR) match bits."""
    w = words.to(torch.int64) & M32
    sh = (2 * phase.to(torch.int64))[:, None]
    lo_w = w[:, :NWR] >> sh
    hi_w = (((w[:, 1:NWR + 1] << (31 - sh)) & M32) << 1) & M32
    aligned = (lo_w | hi_w).reshape(B, C, NWR)
    j16 = 2 * torch.arange(16, device=words.device)
    rw = (reads.to(torch.int64).reshape(B, NWR, 16) << j16).sum(dim=2) & M32
    x = aligned ^ rw[:, None, :]
    return ~(x | (x >> 1)) & 0x55555555


def win_build_and_take(packed, idx, n_tab: int):
    """Stack 8 shifted slices into an (n_tab, 8) window table, then take
    rows."""
    win = torch.stack([packed[j:n_tab + j] for j in range(W)], dim=1)
    return win.index_select(0, idx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="plain torch versions on the CPU")
    ap.add_argument("--table-rows", type=int, default=4096)
    ap.add_argument("--rows", type=int, default=65536,
                    help="gathered rows M")
    ap.add_argument("--batch", type=int, default=8192,
                    help="reads B of the funnel+match sub-op")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("probe_gather: no CUDA card (pass --cpu for the plain "
              "versions)", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    n_tab, M, B = args.table_rows, args.rows, args.batch
    what = "plain" if args.cpu else "CUDA"

    rng = np.random.default_rng(0)
    tab = torch.from_numpy(_u32(rng, (n_tab, W))).to(device)
    idx = torch.from_numpy(
        rng.integers(0, n_tab, size=(M,), dtype=np.int32)).to(device)
    print(f"[probe_gather] {device.type}"
          + (f" ({torch.cuda.get_device_name(0)})" if not args.cpu else "")
          + f": table ({n_tab}, {W}) int32, {M} rows")

    t_base, ref = timed(lambda: tab.index_select(0, idx), device)
    print(f"torch index_select: {t_base * 1e6:9.1f} us  "
          f"({t_base / M * 1e9:6.2f} ns/row)")

    # k_taa's own index: the (M,) indices broadcast over each row, a view
    # the kernel reads as one index per row; k_lane's broadcast is
    # materialised (W, M), since gather_lane takes a contiguous index
    idx_rows = idx.reshape(-1, 1).expand(M, W)
    tab_t = tab.t().contiguous()
    idx_lanes = idx.reshape(1, -1).expand(W, M).contiguous()
    ok_all = True
    for label, fn, check in (
            ("gather_take", lambda: gather_take(tab, idx), lambda o: o),
            ("gather_taa", lambda: gather_taa(tab, idx_rows), lambda o: o),
            ("gather_lane", lambda: gather_lane(tab_t, idx_lanes),
             lambda o: o.t())):
        t_k, out = timed(fn, device)
        ok = bool(torch.equal(check(out), ref))
        ok_all &= ok
        print(f"{what} {label:<11}: {t_k * 1e6:9.1f} us  "
              f"({t_k / M * 1e9:6.2f} ns/row)  match={ok}")

    words = torch.from_numpy(_u32(rng, (B * C, NWR + 1))).to(device)
    phase = torch.from_numpy(
        rng.integers(0, 16, size=(B * C,), dtype=np.int32)).to(device)
    reads = torch.from_numpy(
        rng.integers(0, 4, size=(B, 16 * NWR), dtype=np.int32)).to(device)
    t_fm, _ = timed(lambda: funnel_match(words, phase, reads, B), device)
    print(f"torch funnel+match: {t_fm * 1e6:9.1f} us  (per {B}x{C} launch)")

    packed = torch.from_numpy(_u32(rng, (n_tab + 8,))).to(device)
    t_wb, _ = timed(lambda: win_build_and_take(packed, idx, n_tab), device)
    print(f"torch win+take    : {t_wb * 1e6:9.1f} us  "
          f"({t_wb / M * 1e9:6.2f} ns/row)")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
