#!/usr/bin/env python3
"""Smoke run of the torch port (nimble_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--reads 524288] [--trace]

Phases; each one passes or the script exits non-zero (nothing is caught,
nothing falls back to the CPU):

1. build: compile every csrc/*.cu kernel (fused_span_walk, double_walk,
   gather_rows) with nvcc for sm_90a from the checkout's sources, one nvcc
   per source, all started together, and the port's C++ host library
   (csrc/nimble_host.cpp, g++) beside them;
2. kernel: each kernel against its plain torch version on the same CUDA
   tensors at the main path's shapes (B = 8192 reads, C = 8 candidates,
   Lmax = 92 and 96, candidates probed from a real index: for
   fused_span_walk the uploaded packed reads, the probe's candidates and
   the tables; for double_walk the masks of ops.span_walk.rel_walk_masks at
   l_steps = Lmax - k, and a case with l_steps = 0; for the three gathers
   of gather_rows the gather probe's (4096, 8) table and 65,536 rows, and a
   (1024, 8) table under 48 KiB of shared memory, take and taa also on a
   512 KiB table; taa on k_taa's own broadcast index (a view) and on a
   general (M, W) index, lane on a general index and on the broadcast
   index materialised, as the probe passes it); outputs must be
   bit-equal; both timed per call with CUDA events (``ms``, ``plain_ms``:
   what a caller waits, host launch gaps included) and by device time from
   a torch.profiler trace (``device_ms``, ``plain_device_ms``), beside the
   least time the card could take (``bound_ms``: the kernel's bytes, each
   input read once and each output written once, over HBM_BYTES_PER_S, or
   its operations over OPS_PER_S, whichever is larger); the gathers also
   against the one torch call that computes them (``library_ms``:
   ``index_select`` for take, ``torch.gather`` for taa and lane),
   fused_span_walk also on its first 1,024 reads
   (``small_batch_device_ms``: the launch's latency), and double_walk and
   the gathers also with the L2 cache flushed before every call
   (``cold_device_ms``: a 128 MiB buffer is written between launches; the
   warm time reads inputs that fit in the 50 MB L2).  A gather's bound
   counts the distinct bytes of its function's inputs: a broadcast index
   counts its M indices once.  Each gather row names the design its
   kernel ran (``gather.rows_design`` for take and taa: unstaged or
   per-block) and the shared memory a block held;
3. gather: the port's gather probe (``nimble_tpu_torch.probe_gather``, the
   entry point of the three gather kernels) end to end on the card; every
   ``match=`` must be true;
4. fastq: the port's CLI (``nimble_tpu_torch.cli.main``) counts a FASTQ on
   the card at two library sizes, the bench workload (50 features x 500 bp,
   2^19 reads of 90 bp) and an MHC-scale library (1,000 features x
   1,500 bp), with ``--walk fused`` and ``--walk double``.  Each run's
   kernel launch counter must grow, both TSVs must equal the same CLI run
   with ``--device cpu`` byte for byte, and the TSV of a few thousand reads
   must equal the one written through the port's copy of
   core.calls.HostAlignEngine, the NumPy oracle;
5. multi-fastq: the CLI with several libraries in one call (one parse, one
   stacked device pass per slice for all libraries): four bench libraries
   (seeds 0-3) and the bench library plus the MHC-scale one (bench's
   2^16 buckets rebuilt at MHC's 2^21), 2^19 mixed reads drawn equally
   from every library, ``--walk fused`` and ``--walk double``.  Each
   library's TSV must equal its single-library card run and the same
   N-library run with ``--device cpu``, byte for byte, and the stacked
   run's walk launches must equal one single-library run's (one launch per
   slice serves all libraries, not L);
6. bam: the CLI on synthetic 10x BAMs over the same two libraries (16,384
   groups = 131,072 records each), ``--walk fused`` and ``--walk double``,
   each on the card and with ``--device cpu``, with 4 cores (3 consumer
   threads).  Each card run's kernel counter must grow and the four
   decompressed forensic TSVs must be byte-equal.  Oracles: the golden
   fixture tests/data/golden/forensic.bam through process_fast with
   the torch engine on the card (both walks, both quirk modes) must equal
   forensic_quirks.tsv / forensic_noquirks.tsv, and 4,096 records of the
   bench BAM must give the card's CLI the bytes of bam_pipeline.process with
   HostAlignEngine.  ``--trace`` also profiles the MHC card runs and prints
   the card's busy share;
7. multi-bam: the CLI with the four bench libraries over one BAM of 131,072
   records (``-c 4``), with uniform trim (one stacked pass per batch) and
   with per-library ``-t`` settings (per-engine launches); each library's
   decompressed forensic TSV must equal its single-library card run and
   the ``--device cpu`` run, byte for byte;
8. align_batch: ``TorchAlignEngine.align_batch`` on the card over
   ORACLE_READS reads of the bench library, both walks, result for result
   equal to the port's HostAlignEngine; ``bam_pipeline.process`` (the slow
   BAM pipeline, one consumer) with the torch engine over the bench BAM of
   ORACLE_GROUPS groups, equal to the HostAlignEngine run and to
   process_fast, and over the golden fixture, equal to
   forensic_quirks.tsv; the CLI's ``--engine host`` TSV equal to the card
   CLI's.  Each run's walk counter must grow;
9. mesh: two ranks of this script (``--worker``, started with the
   environment torchrun gives its ranks) share the card, with gloo merges
   (the backend is printed): the CLI's ``--engine mesh`` on a (1, 2) mesh
   at the MHC-scale library (2^19 reads, both walks), on the 4 x bench
   libraries (2^19 reads) and on the bench BAM (131,072 records, ``-c
   4``), and the library API on a (2, 1) mesh on the bench library.  Every
   TSV and decompressed forensic TSV must equal the single-device card run
   of phases 4-6 byte for byte, and every rank's walk counter must grow in
   every run (each rank reports its counters through a file); the walk
   rows' ``launches`` add both ranks' counts;
10. multihost: the CLI's multi-host mode (``--num-processes 2``, one
   ``--process-id`` each, ``file://`` rendezvous, gloo) in two processes
   of this script (``--worker``) sharing the card, each host with its own
   TorchAlignEngine and pipeline: the bench FASTQ (2^19 reads, each host
   parsing its byte range), a paired FASTQ of 2^17 pairs on the bench
   library and the bench BAM (131,072 records, a group range per host).
   The TSVs must equal the single-device card runs (phase 4's, and one made
   here for the paired input) and the decompressed forensic TSV phase 6's,
   byte for byte; the walk kernel must launch on both hosts in every run.
   Each host's wall and NIMBLE_TIMING split (parse, exchange, align, merge
   and owned reads; count, align, merge and owned groups for BAM) are
   printed;
11. entry: ``graft_entry.entry()``'s step on the card equal to
   ``entry(device="cpu")``'s, and ``graft_entry.dryrun_multichip(2)`` on
   two ranks sharing the card (gloo), every check passing and the walk
   kernel launching on both ranks.

Cut to fit the time limit: the MHC BAM runs read 131,072 records (16,384
groups) rather than 524,288; that cell is bound by the host orientation
memo, not the card.

Prints the card's name and power limit (as nvidia-smi reports them), JSON
lines of the slice results and per-kernel results, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without CUDA or outside a checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_BATCH = 8192
SMALL_BATCH = 1024  # the fused walk is also timed on this many reads
KERNEL_BUCKETS = (92, 96)
ORACLE_READS = 3000
ORACLE_GROUPS = 512
SIZES = (
    # (name, features, feature length, BAM groups): the bench workload, then
    # an MHC-scale library (2,000 doubled rows, about 3 Mbp)
    ("bench", 50, 500, 16384),
    ("mhc", 1000, 1500, 16384),
)
MULTI_FASTQ = (
    # (name, library sizes): library i from seed --seed + i
    ("4 x bench", ((50, 500),) * 4),
    ("bench + mhc", ((50, 500), (1000, 1500))),
)
MULTI_BAM_GROUPS = 16384
MULTI_BAM_TRIMS = "40:0.9,30:0.5,40:0.9,30:0.5"  # the JSON's is 40:0.9
WALK_KERNELS = {"fused": "fused_span_walk", "double": "double_walk"}
MESH_RANKS = 2           # ranks of the mesh phase, sharing the one card
MESH_TIMEOUT_S = 900     # the mesh phase's processes are killed after this
MULTIHOST_PAIRS = 1 << 17  # pairs of the multihost phase's paired FASTQ
# the single-device card runs the later phases are held to, by (phase, case)
RUNS: dict = {}
GATHER_KERNELS = ("gather_take", "gather_taa", "gather_lane")
GATHER_SHAPES = ((4096, 8, 65536), (1024, 8, 65536))  # (N, W, M)
# take and taa also on a 512 KiB table, over the 227 KiB one block can hold
GATHER_BIG = (16384, 8, 65536)
GATHER_CASE_KEYS = ("N", "W", "M", "case", "design", "smem_kib",
                    "device_ms", "cold_device_ms", "plain_device_ms",
                    "library_device_ms", "bound_ms", "bound_bytes",
                    "bound_share", "cold_bound_share")
# the card's peak rates for the bounds (NVIDIA H100 SXM data sheet, at the
# full 700 W): HBM bytes per second, and 32-bit operations per second
# outside the tensor cores (the float32 rate, 67 T/s, used for the walks'
# integer operations)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
L2_FLUSH_BYTES = 128 << 20  # written between launches for a cold L2
REPLACES = {
    "fused_span_walk": "nimble_tpu/ops/pallas_fused.py:130",
    "double_walk": "nimble_tpu/ops/pallas_walk.py:75",
    "gather_take": "scripts/probe_mosaic_gather.py:75",
    "gather_taa": "scripts/probe_mosaic_gather.py:101",
    "gather_lane": "scripts/probe_mosaic_gather.py:128",
}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str = "") -> float:
    """Device time per call of ``fn`` from a torch.profiler (CUPTI) trace:
    the summed duration of the CUDA kernels whose name contains ``kernel``
    (all kernels when empty), over ``iters`` calls.  Unlike :func:`cuda_ms`
    it excludes the host's launch gaps between kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace is taken only when it holds a record of every launch: at
    # least one a call, and for a named kernel a whole number a call.
    # Traces on an H100 have come back missing about a quarter of a
    # kernel's records, for no cause found yet (PERF.md section 7); such a
    # trace is retaken, at most four times, and said so
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, count = _device_us(prof, kernel)
        if count >= iters and (not kernel or count % iters == 0):
            return total_us / 1e3 / iters
        print(f"[profiler] trace {attempt + 1} of {kernel or 'all kernels'!r}"
              f" holds {count} kernel records for {iters} calls; retaken")
    raise AssertionError(f"profiler traces of {kernel!r} miss launches")


def cold_device_ms(fn, iters: int, kernel: str) -> float:
    """:func:`device_ms` of the kernel named ``kernel`` with the L2 cache
    cold: before each call a buffer of L2_FLUSH_BYTES, well over the
    card's 50 MB of L2, is written (its fill kernel is not summed)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")

    def call():
        flush.fill_(1)
        return fn()

    return device_ms(call, iters, kernel)


def _cold(row: dict, fn, kernel: str) -> str:
    """Adds the cold device time and its share of the bound to ``row``;
    returns its text for the kernel's line."""
    row["cold_device_ms"] = cold_device_ms(fn, 50, kernel)
    row["cold_bound_share"] = row["bound_ms"] / row["cold_device_ms"]
    return (f"; L2 cold: device time {row['cold_device_ms']:.4f} ms, at "
            f"{row['cold_bound_share']:.3f} of the bound (warm "
            f"{row['bound_share']:.3f})")


def _device_us(prof, name: str = "") -> tuple:
    """(summed device time in us, records) of the trace's CUDA kernels
    whose name contains ``name``."""
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and name in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    return total, count


class Counters:
    """The kernel wrappers' launch counters, zeroed around one run."""

    def __init__(self):
        from nimble_tpu_torch.ops import gather
        from nimble_tpu_torch.ops.double_walk import double_walk
        from nimble_tpu_torch.ops.span_walk import fused_span_walk

        self.wrappers = {"fused_span_walk": fused_span_walk,
                         "double_walk": double_walk,
                         **{n: getattr(gather, n) for n in GATHER_KERNELS}}
        self.main_path = {name: 0 for name in self.wrappers}

    @contextlib.contextmanager
    def run(self, label: str, walk: str = "", kernels=()):
        """Counts of one main-path run: the run's walk kernel (or each of
        ``kernels``) must launch and every other kernel must not."""
        import torch

        want = set(kernels) | ({WALK_KERNELS[walk]} if walk else set())
        torch.cuda.synchronize()
        for w in self.wrappers.values():
            w.launches = 0
        got = {}
        yield got
        got.update({n: w.launches for n, w in self.wrappers.items()})
        if any(got[n] <= 0 for n in want) or any(
                v for n, v in got.items() if n not in want):
            raise AssertionError(f"{label}: launch counts {got} (want "
                                 f"{sorted(want)})")
        for name, count in got.items():
            self.main_path[name] += count


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from nimble_tpu_torch import native
    from nimble_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(native.available)  # g++, beside the nvcc builds
        _build.build_libraries(_build.KERNELS, rebuild=True)
        if not host.result():
            raise AssertionError("the port's C++ host library "
                                 "(csrc/nimble_host.cpp) did not build")
    secs = time.perf_counter() - t0
    print(f"[build] nimble_tpu_torch/csrc/nimble_host.cpp -> "
          f"{native.library_path().name} (g++)")
    for name in _build.KERNELS:
        print(f"[build] {_build.source_path(name).relative_to(ROOT)} -> "
              f"{_build.library_path(name).name} (nvcc "
              f"{_build.build_seconds[name]:.2f} s)")
        for line in _build.ptxas_report[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas {name}: {line.strip()}")
    print(f"[build] {len(_build.KERNELS)} kernels in {secs:.2f} s")


def _check_equal(label, got, want) -> int:
    import torch

    max_err = 0
    for name, g, w in zip(("live", "score", "mm"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {name}: {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
    if max_err != 0:
        raise AssertionError(f"{label}: kernel disagrees with plain, max "
                             f"|err| {max_err}")
    return max_err


def _timings(kernel, plain, kernel_name: str) -> dict:
    return {"ms": cuda_ms(kernel, 200), "plain_ms": cuda_ms(plain, 5),
            "device_ms": device_ms(kernel, 50, kernel_name),
            "plain_device_ms": device_ms(plain, 3)}


def _bound(n_bytes: int, n_ops: int, device: float) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes over HBM_BYTES_PER_S and the operations over OPS_PER_S, with the
    kernel's device time as a share of it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    return {"bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(n_bytes), "bound_ops": int(n_ops),
            "bound_share": bound / device}


def _fused_walk_work(cand, t, bucket: int):
    """(bytes, operations) the fused walk needs on this run's candidates:
    each input read once (packed rows, anchor, the (B, C) row ids, offsets
    and live0, the table entries of the distinct rows and words the windows
    touch), each output written once; 32-bit operations of the word compare
    (5 per candidate and word) and of the steps (3 per candidate and 4 per
    read, 2 * (Lmax - k) steps)."""
    import torch

    B, C = cand.rows.shape
    nr = (bucket + 15) // 16
    n_words = t.ref_codes_packed.shape[-1]
    start = t.row_starts[cand.rows].long() + cand.offs \
        - cand.anchor[:, None] + t.ref_pad
    w0 = (start >> 4).clamp(0, n_words - nr - 1)
    words = (w0[..., None] + torch.arange(nr + 1, device=w0.device)).unique()
    rows = cand.rows.unique()
    n_in = (cand.packed.numel() + 8 * B + 17 * B * C + 8 * rows.numel()
            + 4 * words.numel())
    n_out = B * C + 8 * B
    steps = 2 * (bucket - t.k)
    return n_in + n_out, B * C * (5 * nr + 3 * steps) + 4 * B * steps


def _double_walk_work(masks):
    """(bytes, operations) of the double walk: its int8 masks read once,
    live / score / mm written once; 3 operations per candidate and step, 4
    per read and step."""
    B, C, T = masks["f_alive"].shape
    Tl = masks["l_alive"].shape[2]
    n_bytes = sum(m.numel() for m in masks.values()) + B * C + 8 * B
    return n_bytes, (T + Tl) * (3 * B * C + 4 * B)


def phase_kernel(seed: int):
    """Both walk kernels vs plain on main-path inputs; returns per-case
    rows."""
    import numpy as np
    import torch

    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.models.aligner import pack_reads
    from nimble_tpu_torch.ops.compact import probe_candidates
    from nimble_tpu_torch.ops.device_index import build_bucketed_index
    from nimble_tpu_torch.ops.device_tables import tables_from_bucketed_index
    from nimble_tpu_torch.ops.double_walk import double_walk, double_walk_plain
    from nimble_tpu_torch.ops.span_walk import (
        fused_span_walk,
        rel_walk_masks,
        span_walk_plain,
    )
    from nimble_tpu_torch.workload import generate

    _feats, doubled, mat, _ = generate(n_features=50, feat_len=500,
                                       read_len=90, n_reads=KERNEL_BATCH,
                                       seed=seed)
    bidx = build_bucketed_index(build_index(doubled))
    t = tables_from_bucketed_index(bidx, "cuda")
    lens = np.full(KERNEL_BATCH, 90, dtype=np.int32)
    rows = {"fused_span_walk": [], "double_walk": []}
    for bucket in KERNEL_BUCKETS:
        packed = torch.from_numpy(pack_reads(mat, lens, bucket)).cuda()
        cand = probe_candidates(packed, t, bucket=bucket, c_max=8)
        wargs = (cand.packed, cand.anchor, cand.rows, cand.offs, cand.live0,
                 t)

        def walk(b=bucket):
            return fused_span_walk(*wargs, bucket=b)

        def walk_plain(b=bucket):
            return span_walk_plain(*wargs, bucket=b)

        got = walk()
        torch.cuda.synchronize()
        row = {"Lmax": bucket, "max_abs_err": _check_equal(
            f"fused_span_walk Lmax={bucket}", got, walk_plain())}
        row.update(_timings(walk, walk_plain, "fused_span_walk_kernel"))
        row.update(_bound(*_fused_walk_work(cand, t, bucket),
                          row["device_ms"]))
        row["library_ms"] = None  # no single torch call computes a walk
        # the same launch on an eighth of the reads: what a launch costs
        # whatever its size (latency, not throughput)
        small = tuple(x[:SMALL_BATCH].contiguous() for x in wargs[:5])
        row["small_batch_device_ms"] = device_ms(
            lambda b=bucket: fused_span_walk(*small, t, bucket=b), 50,
            "fused_span_walk_kernel")
        print(f"[kernel] fused_span_walk B={KERNEL_BATCH} C=8 Lmax={bucket}"
              f": bit-equal to plain (live lanes "
              f"{float(got[0].float().mean()):.3f}, score sum "
              f"{int(got[1].sum())}); device time (profiler): kernel "
              f"{row['device_ms']:.4f} ms, plain "
              f"{row['plain_device_ms']:.3f} ms; per call (CUDA events): "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms; "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bound_bytes']} bytes, {row['bound_ops']} ops), "
              f"device time at {row['bound_share']:.3f} of it; "
              f"B={SMALL_BATCH}: device time "
              f"{row['small_batch_device_ms']:.4f} ms")
        rows["fused_span_walk"].append(row)

        cargs = (cand.reads, cand.read_lens, cand.anchor, cand.rows,
                 cand.offs, cand.live0, t)
        for l_steps in ((bucket - t.k, 0) if bucket == KERNEL_BUCKETS[0]
                        else (bucket - t.k,)):
            masks = rel_walk_masks(*cargs, l_steps=l_steps)
            got_d = double_walk(**masks)
            torch.cuda.synchronize()
            err = _check_equal(f"double_walk Lmax={bucket} l_steps={l_steps}",
                               got_d, double_walk_plain(**masks))
            if l_steps:
                # the main path's walk: equal to the fused walk's bits
                _check_equal(f"double vs fused Lmax={bucket}",
                             (got_d[0] != 0, got_d[1], got_d[2]), got)
            T, Tl = masks["f_alive"].shape[2], masks["l_alive"].shape[2]
            row = {"Lmax": bucket, "T": T, "Tl": Tl, "max_abs_err": err}
            row.update(_timings(lambda: double_walk(**masks),
                                lambda: double_walk_plain(**masks),
                                "double_walk_kernel"))
            row.update(_bound(*_double_walk_work(masks), row["device_ms"]))
            row["library_ms"] = None
            cold = _cold(row, lambda: double_walk(**masks),
                         "double_walk_kernel")
            mb = sum(m.numel() for m in masks.values()) / 2**20
            print(f"[kernel] double_walk B={KERNEL_BATCH} C=8 Lmax={bucket} "
                  f"T={T} Tl={Tl} ({mb:.1f} MiB of masks): bit-equal to "
                  f"plain{' and to fused_span_walk' if l_steps else ''}; "
                  f"device time (profiler): kernel {row['device_ms']:.4f} ms,"
                  f" plain {row['plain_device_ms']:.3f} ms; per call (CUDA "
                  f"events): kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.3f} ms; bound {row['bound_ms']:.4f} ms "
                  f"by {row['bound_by']}, device time at "
                  f"{row['bound_share']:.3f} of it{cold}")
            rows["double_walk"].append(row)
    return rows


def _gather_cases(gather, N, W, M, tab, idx, idx2):
    """(kernel, case, (table, index), library call, distinct index bytes,
    profiler name) of one table: take; taa on k_taa's own broadcast index
    (the view idx[:, None].expand(M, W)) and on a general (M, W) index; lane
    on a general index and on the broadcast index materialised (W, M), as
    the probe passes it, whose distinct bytes are k_lane's (M,) index."""
    import torch

    tab_t = tab.t().contiguous()
    idx2_t = idx2.t().contiguous()
    lanes = idx[None, :].expand(W, M).contiguous()
    bcast, bcast64 = idx[:, None].expand(M, W), idx.long()[:, None].expand(
        M, W)
    idx2_64, idx2_t64, lanes64 = idx2.long(), idx2_t.long(), lanes.long()
    rows, lane = "gather_rows_kernel", "gather_lane_kernel"
    return [
        ("gather_take", "(M,) index", (tab, idx),
         lambda: tab.index_select(0, idx), M * 4, rows),
        ("gather_taa", "broadcast index", (tab, bcast),
         lambda: torch.gather(tab, 0, bcast64), M * 4, rows),
        ("gather_taa", "(M, W) index", (tab, idx2),
         lambda: torch.gather(tab, 0, idx2_64), M * W * 4, rows),
        ("gather_lane", "(W, M) index", (tab_t, idx2_t),
         lambda: torch.gather(tab_t, 1, idx2_t64), M * W * 4, lane),
        ("gather_lane", "broadcast index, materialised", (tab_t, lanes),
         lambda: torch.gather(tab_t, 1, lanes64), M * 4, lane),
    ]


def _design(gather, name, a, b):
    """(design, KiB of shared memory a block holds) of one gather call:
    the kernel entry's choice for take and taa; lane stages one table row
    per block."""
    if name == "gather_lane":
        return "per-block", a.shape[1] * 4 / 1024
    design, smem = gather.rows_design(a, b)
    return design, smem / 1024


def phase_gather_kernels(seed: int):
    """The three gather kernels vs plain and vs the one torch call that
    computes the same gather (``index_select`` for take, ``torch.gather``
    for taa and lane) at the gather probe's shapes, and take and taa on a
    table over the 227 KiB one block could hold; device time warm and with
    the L2 cold.  Returns per-case rows by kernel."""
    import numpy as np
    import torch

    from nimble_tpu_torch.ops import gather

    rows = {n: [] for n in GATHER_KERNELS}
    for N, W, M in GATHER_SHAPES + (GATHER_BIG,):
        rng = np.random.default_rng(seed)
        tab = torch.from_numpy(rng.integers(0, 2**32, size=(N, W),
                                            dtype=np.uint32).view(np.int32))
        tab = tab.cuda()
        idx = torch.from_numpy(rng.integers(0, N, size=(M,),
                                            dtype=np.int32)).cuda()
        idx2 = torch.from_numpy(rng.integers(0, N, size=(M, W),
                                             dtype=np.int32)).cuda()
        big = (N, W, M) == GATHER_BIG
        for (name, case, (a, b), library, idx_bytes,
             kname) in _gather_cases(gather, N, W, M, tab, idx, idx2):
            if big and name == "gather_lane":
                continue
            fn = getattr(gather, name)
            plain = getattr(gather, name + "_plain")
            got = fn(a, b)
            torch.cuda.synchronize()
            want = plain(a, b)
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {case} ({N}, {W}): {got.shape} "
                                     f"{got.dtype} vs {want.shape}")
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            if err or not torch.equal(library(), want):
                raise AssertionError(f"{name} {case} ({N}, {W}): kernel or "
                                     f"library call disagrees with plain, "
                                     f"max |err| {err}")
            n_bytes = a.numel() * 4 + idx_bytes + got.numel() * 4
            design, smem_kib = _design(gather, name, a, b)
            row = {"N": N, "W": W, "M": M, "case": case, "design": design,
                   "max_abs_err": err, "smem_kib": smem_kib,
                   **_timings(lambda: fn(a, b), lambda: plain(a, b), kname),
                   "library_ms": cuda_ms(library, 200),
                   "library_device_ms": device_ms(library, 50)}
            row.update(_bound(n_bytes, 0, row["device_ms"]))
            cold = _cold(row, lambda: fn(a, b), kname)
            rows[name].append(row)
            print(f"[kernel] {name}, {case}, table ({N}, {W}), M={M}: "
                  f"design {design}, {smem_kib:.1f} KiB of shared memory a "
                  f"block; bit-equal to plain and to the library call; "
                  f"device time (profiler): kernel {row['device_ms']:.4f} ms, "
                  f"plain {row['plain_device_ms']:.4f} ms, library "
                  f"{row['library_device_ms']:.4f} ms; per call (CUDA "
                  f"events): kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.5f} "
                  f"ms by bytes ({n_bytes} bytes), device time at "
                  f"{row['bound_share']:.3f} of it{cold}")
    return rows


def phase_gather(counters: Counters):
    """The gather probe's entry point end to end on the card."""
    from nimble_tpu_torch import probe_gather

    out = io.StringIO()
    with counters.run("probe_gather", kernels=GATHER_KERNELS) as counts:
        with contextlib.redirect_stdout(out):
            rc = probe_gather.main([])
    text = out.getvalue()
    for line in text.splitlines():
        print(f"[gather] {line}")
    if rc != 0 or text.count("match=True") != 3 or "match=False" in text:
        raise AssertionError(f"probe_gather: rc {rc}, matches "
                             f"{text.count('match=True')} of 3")
    print(f"[gather] probe_gather: three match=True; launches {dict(counts)}")


def _tsv_lines(path: str):
    with open(path, "rb") as f:
        data = f.read()
    lines = data.decode().splitlines()
    if not lines or lines[0] != "feature\tscore":
        raise AssertionError(f"{path}: missing TSV header")
    for ln in lines[1:]:
        count = int(ln.rsplit("\t", 1)[1])
        if count <= 0:
            raise AssertionError(f"{path}: non-positive count in {ln!r}")
    return data, lines


def _library_engine_inputs(library: str):
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )

    cfg, ref = load_reference_library(library, LibraryChemistry.UNSTRANDED)
    return cfg, ref, build_index(get_reference_sequence_data(ref)[0])


def _host_oracle_tsv(wl, out: str) -> None:
    from nimble_tpu_torch.core.calls import HostAlignEngine
    from nimble_tpu_torch.pipeline import fastq_pipeline

    cfg, ref, index = _library_engine_inputs(wl.library)
    fastq_pipeline.process(wl.inputs, [HostAlignEngine(index, cfg)], [ref],
                           [cfg], [out])


def phase_fastq(tmp: str, seed: int, n_reads: int, counters: Counters):
    """The port's CLI on FASTQ input at both sizes; returns result rows."""
    from nimble_tpu_torch.utils.metrics import METRICS
    from nimble_tpu_torch import cli
    from nimble_tpu_torch.workload import write_workload

    meter = METRICS.meter("fastq_align")
    rows = []
    for name, n_feat, feat_len, _groups in SIZES:
        d = os.path.join(tmp, name)
        wl = write_workload(d, n_features=n_feat, feat_len=feat_len,
                            read_len=90, n_reads=n_reads, seed=seed)
        runs = {}
        for device, walk in (("cuda", "fused"), ("cuda", "double"),
                             ("cpu", "fused")):
            out = os.path.join(d, f"{device}_{walk}.tsv")
            argv = ["-r", wl.library, "-i", wl.inputs[0], "-o", out,
                    "--device", device, "--walk", walk]
            items0, secs0 = meter.items, meter.seconds
            t0 = time.perf_counter()
            counts = {}
            if device == "cuda":
                with counters.run(f"fastq {name} {walk}", walk) as counts:
                    rc = cli.main(argv)
            else:
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"{name}/{device}: CLI returned {rc}")
            runs[(device, walk)] = (out, wall, meter.items - items0,
                                    meter.seconds - secs0, dict(counts))
        RUNS[("fastq", name)] = (wl, runs[("cuda", "fused")])
        cpu_bytes, _ = _tsv_lines(runs[("cpu", "fused")][0])
        for key in (("cuda", "fused"), ("cuda", "double")):
            gpu_bytes, gpu_lines = _tsv_lines(runs[key][0])
            if gpu_bytes != cpu_bytes:
                raise AssertionError(f"{name}: {key} TSV != cpu TSV")
        if len(gpu_lines) < 2:
            raise AssertionError(f"{name}: no feature was counted")

        small = write_workload(os.path.join(d, "oracle"), n_features=n_feat,
                               feat_len=feat_len, read_len=90,
                               n_reads=ORACLE_READS, seed=seed)
        dev_out = os.path.join(d, "oracle", "cuda.tsv")
        host_out = os.path.join(d, "oracle", "host.tsv")
        if cli.main(["-r", small.library, "-i", small.inputs[0], "-o",
                     dev_out, "--device", "cuda"]) != 0:
            raise AssertionError(f"{name}: oracle-size CLI run failed")
        _host_oracle_tsv(small, host_out)
        if _tsv_lines(dev_out)[0] != _tsv_lines(host_out)[0]:
            raise AssertionError(f"{name}: cuda TSV != HostAlignEngine TSV")

        for (device, walk), (_, wall, items, secs, counts) in runs.items():
            row = {"size": name, "features": n_feat, "feature_len": feat_len,
                   "reads": n_reads, "device": device, "walk": walk,
                   "cli_wall_s": wall, "cli_reads_per_s": n_reads / wall,
                   "pipeline_s": secs,
                   "pipeline_reads_per_s": items / secs if secs else 0.0,
                   "launches": counts}
            rows.append(row)
            print(f"[fastq] {name} ({n_feat} x {feat_len} bp, {n_reads} "
                  f"reads) {device}/{walk}: CLI {wall:.2f} s = "
                  f"{row['cli_reads_per_s']:.0f} reads/s end to end; "
                  f"FASTQ loop {secs:.2f} s = "
                  f"{row['pipeline_reads_per_s']:.0f} reads/s; launches "
                  f"{counts}")
        print(f"[fastq] {name}: {len(gpu_lines) - 1} callsets; cuda TSVs "
              f"(fused, double) == cpu TSV; {ORACLE_READS}-read cuda TSV == "
              "HostAlignEngine TSV")
    return rows


def _library_argv(libraries, outs):
    return [a for lib, out in zip(libraries, outs)
            for a in ("-r", lib, "-o", out)]


def phase_multi_fastq(tmp: str, seed: int, n_reads: int, counters: Counters):
    """The CLI with several libraries on one FASTQ; returns result rows."""
    from nimble_tpu_torch.workload import write_multi_workload

    rows = []
    for name, libraries in MULTI_FASTQ:
        d = os.path.join(tmp, "multi_" + name.replace(" ", ""))
        t0 = time.perf_counter()
        wl = write_multi_workload(d, libraries=libraries, read_len=90,
                                  n_reads=n_reads, seed=seed)
        L = len(libraries)
        n_in = n_reads // L * L
        print(f"[multi-fastq] {name}: wrote {L} libraries and {n_in} reads "
              f"in {time.perf_counter() - t0:.1f} s")

        def run(tag, libs, device, walk):
            outs = [os.path.join(d, f"{tag}_{i}.tsv")
                    for i in range(len(libs))]
            argv = _library_argv(libs, outs) + [
                "-i", wl.inputs[0], "--device", device, "--walk", walk]
            counts = {}
            if device == "cuda":
                with counters.run(f"multi-fastq {name} {tag}", walk) as counts:
                    rc, wall, _ = _quiet_cli(argv)
            else:
                rc, wall, _ = _quiet_cli(argv)
            if rc != 0:
                raise AssertionError(f"multi-fastq {name} {tag}: rc {rc}")
            return [_tsv_lines(o)[0] for o in outs], wall, dict(counts)

        stacked = {walk: run(f"cuda_{walk}", wl.libraries, "cuda", walk)
                   for walk in WALK_KERNELS}
        RUNS[("multi_fastq", name)] = (wl, stacked["fused"])
        cpu = run("cpu_fused", wl.libraries, "cpu", "fused")
        singles = [run(f"single{i}", [lib], "cuda", "fused")
                   for i, lib in enumerate(wl.libraries)]
        single_tsvs = [s[0][0] for s in singles]
        single_launches = [s[2]["fused_span_walk"] for s in singles]
        if any(t.count(b"\n") < 2 for t in single_tsvs):
            raise AssertionError(f"multi-fastq {name}: a library counted "
                                 "nothing")
        if len(set(single_launches)) != 1:
            raise AssertionError(f"multi-fastq {name}: single-library runs "
                                 f"launched {single_launches}")
        seq_wall = sum(s[1] for s in singles)
        for walk, (tsvs, wall, counts) in stacked.items():
            if tsvs != cpu[0]:
                raise AssertionError(f"multi-fastq {name} {walk}: cuda TSVs "
                                     "!= cpu TSVs")
            if tsvs != single_tsvs:
                raise AssertionError(f"multi-fastq {name} {walk}: TSVs != "
                                     "single-library TSVs")
            launches = counts[WALK_KERNELS[walk]]
            if launches != single_launches[0]:
                raise AssertionError(
                    f"multi-fastq {name} {walk}: {launches} walk launches, "
                    f"one single-library run {single_launches[0]}")
            row = {"case": name, "libraries": [list(x) for x in libraries],
                   "reads": n_in, "walk": walk, "stacked_wall_s": wall,
                   "stacked_reads_per_s": n_in / wall,
                   "sequential_wall_s": seq_wall,
                   "sequential_reads_per_s": n_in / seq_wall,
                   "stacked_walk_launches": launches,
                   "sequential_walk_launches": sum(single_launches),
                   "cpu_stacked_wall_s": cpu[1]}
            rows.append(row)
            print(f"[multi-fastq] {name}, {n_in} reads, {walk}: stacked CLI "
                  f"{wall:.2f} s = {row['stacked_reads_per_s']:.0f} reads/s; "
                  f"{L} single-library CLI runs {seq_wall:.2f} s = "
                  f"{row['sequential_reads_per_s']:.0f} reads/s; walk "
                  f"launches stacked {launches}, sequential "
                  f"{sum(single_launches)}; --device cpu stacked "
                  f"{cpu[1]:.2f} s")
        print(f"[multi-fastq] {name}: each library's TSV (cuda fused, cuda "
              "double, cpu) == its single-library card run, byte for byte")
    return rows


def phase_multi_bam(tmp: str, seed: int, counters: Counters):
    """The CLI with the four bench libraries on one BAM, uniform and
    per-library trim; returns result rows."""
    from nimble_tpu_torch.workload import write_multi_bam_workload

    d = os.path.join(tmp, "multi_bam")
    libraries = ((50, 500),) * 4
    t0 = time.perf_counter()
    wl = write_multi_bam_workload(d, libraries=libraries,
                                  n_groups=MULTI_BAM_GROUPS, seed=seed)
    n_records = 8 * MULTI_BAM_GROUPS
    print(f"[multi-bam] wrote 4 libraries and {n_records} records in "
          f"{time.perf_counter() - t0:.1f} s")
    trims = MULTI_BAM_TRIMS.split(",")

    def run(tag, libs, device, trim=None):
        outs = [os.path.join(d, f"{tag}_{i}.tsv.gz")
                for i in range(len(libs))]
        argv = _library_argv(libs, outs) + [
            "-i", wl.inputs[0], "--device", device, "-c", "4"]
        if trim:
            argv += ["-t", trim]
        counts = {}
        if device == "cuda":
            with counters.run(f"multi-bam {tag}", "fused") as counts:
                rc, wall, _ = _quiet_cli(argv)
        else:
            rc, wall, _ = _quiet_cli(argv)
        if rc != 0:
            raise AssertionError(f"multi-bam {tag}: rc {rc}")
        return ([_gunzip(o) for o in outs], wall,
                dict(counts).get("fused_span_walk", 0))

    uniform = run("cuda_uniform", wl.libraries, "cuda")
    uniform_cpu = run("cpu_uniform", wl.libraries, "cpu")
    per = run("cuda_per_library", wl.libraries, "cuda", MULTI_BAM_TRIMS)
    per_cpu = run("cpu_per_library", wl.libraries, "cpu", MULTI_BAM_TRIMS)
    singles = [run(f"single{i}", [lib], "cuda")
               for i, lib in enumerate(wl.libraries)]
    singles_trim = [singles[i] if trim == "40:0.9"
                    else run(f"single{i}_trim", [lib], "cuda", trim)
                    for i, (lib, trim) in enumerate(zip(wl.libraries, trims))]
    for label, got, cpu, want in (
            ("uniform", uniform, uniform_cpu, singles),
            ("per-library trim", per, per_cpu, singles_trim)):
        want_bytes = [w[0][0] for w in want]
        if got[0] != want_bytes or cpu[0] != want_bytes:
            raise AssertionError(f"multi-bam {label}: TSVs differ from the "
                                 "single-library / cpu runs")
        if min(b.count(b"\n") for b in want_bytes) < MULTI_BAM_GROUPS:
            raise AssertionError(f"multi-bam {label}: too few rows")
    if (uniform[2] != singles[0][2]
            or per[2] != sum(s[2] for s in singles_trim)):
        raise AssertionError(
            f"multi-bam: walk launches stacked {uniform[2]} (single "
            f"{singles[0][2]}), per-engine {per[2]} (singles "
            f"{[s[2] for s in singles_trim]})")
    seq_wall = sum(s[1] for s in singles)
    rows = []
    for label, got, cpu in (("uniform", uniform, uniform_cpu),
                            ("per-library trim", per, per_cpu)):
        row = {"case": label, "libraries": 4, "records": n_records,
               "cuda_wall_s": got[1], "cuda_records_per_s": n_records / got[1],
               "cpu_wall_s": cpu[1], "walk_launches": got[2]}
        rows.append(row)
        how = ("one stacked pass" if label == "uniform"
               else "per-engine launches")
        print(f"[multi-bam] {label} ({how}): "
              f"CLI {got[1]:.2f} s = {row['cuda_records_per_s']:.0f} "
              f"records/s; --device cpu {cpu[1]:.2f} s; walk launches "
              f"{got[2]}")
    rows[0]["sequential_wall_s"] = seq_wall
    print(f"[multi-bam] 4 single-library CLI runs {seq_wall:.2f} s = "
          f"{n_records / seq_wall:.0f} records/s; walk launches "
          f"{[s[2] for s in singles]}; every library's TSV (stacked, "
          "per-engine, cpu) == its single-library card run, byte for byte")
    return rows


def _gunzip(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def _quiet_cli(argv):
    """Run the CLI with its stdout and stderr captured; returns (rc, wall
    seconds, captured stderr).  With NIMBLE_TIMING=1, process_fast's
    threads print their split to stderr."""
    from nimble_tpu_torch import cli

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, time.perf_counter() - t0, err.getvalue()


def _timing_split(stderr: str) -> dict:
    """process_fast's NIMBLE_TIMING lines -> seconds by stage."""
    split = {}
    for line in stderr.splitlines():
        if line.startswith("[bam_fast wall] "):
            label, at = line[len("[bam_fast wall] "):].split(" @ ")
            split[label.replace(" ", "_")] = float(at.rstrip("s"))
        elif line.startswith("[bam_fast producer] read "):
            split["producer_read"] = float(line.split()[-1].rstrip("s"))
        elif line.startswith("[bam_fast logger] gzip-write "):
            split["gzip_write"] = float(line.split()[3].rstrip("s"))
        elif line.startswith("[bam_fast consumer "):
            words = line.split("] ", 1)[1].split()
            for key, val in zip(words[0::2], words[1::2]):
                k = "consumer_" + key.replace("-", "_")
                split[k] = split.get(k, 0.0) + float(val.rstrip("s"))
    return split


def _golden_forensic_inputs():
    """The library of tests/data/golden (tests/test_golden_forensic.py):
    5 random 180 bp features from seed 12345 and their reverse
    complements."""
    import numpy as np

    from nimble_tpu_torch.config import AlignFilterConfig
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import Reference
    from nimble_tpu_torch.utils.dna import revcomp

    rng = np.random.default_rng(12345)
    feats = ["".join(rng.choice(list("ACGT"), size=180)) for _ in range(5)]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    names = [n for i in range(5) for n in (f"F{i}", f"F{i}§rev")]
    reference = Reference(
        group_on=0, headers=["sequence_name", "sequence"],
        columns=[names, doubled], sequence_name_idx=0, sequence_idx=1,
    )
    cfg = AlignFilterConfig(
        reference_genome_size=10, score_percent=0.25, score_threshold=40,
        num_mismatches=2, max_hits_to_report=8,
    )
    return reference, build_index(doubled), cfg


def _bam_oracles(tmp: str, seed: int) -> None:
    from nimble_tpu_torch.core.calls import HostAlignEngine
    from nimble_tpu_torch.pipeline import bam_pipeline
    from nimble_tpu_torch.pipeline.bam_fast import process_fast
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.workload import write_bam_workload

    golden = os.path.join(ROOT, "tests", "data", "golden")
    reference, index, cfg = _golden_forensic_inputs()
    for walk in WALK_KERNELS:
        engine = TorchAlignEngine(index, cfg, device="cuda", walk=walk)
        for quirks in (True, False):
            out = os.path.join(tmp, f"golden_{walk}_{quirks}.tsv.gz")
            interval = sys.getswitchinterval()
            with contextlib.redirect_stdout(io.StringIO()):
                process_fast([os.path.join(golden, "forensic.bam")],
                             [engine], [reference], [cfg], [out], 2, False,
                             parity_quirks=quirks)
            sys.setswitchinterval(interval)
            name = "forensic_quirks.tsv" if quirks else "forensic_noquirks.tsv"
            with open(os.path.join(golden, name), "rb") as f:
                if _gunzip(out) != f.read():
                    raise AssertionError(f"golden {name} != cuda {walk}")
    print("[bam] tests/data/golden/forensic.bam on the card (walks fused and "
          "double, quirks on and off) == forensic_quirks.tsv / "
          "forensic_noquirks.tsv byte for byte")

    _name, n_feat, feat_len, _groups = SIZES[0]
    wl = write_bam_workload(os.path.join(tmp, "bam_oracle"),
                            n_features=n_feat, feat_len=feat_len,
                            n_groups=ORACLE_GROUPS, seed=seed)
    dev_out = os.path.join(tmp, "bam_oracle", "cuda.tsv.gz")
    host_out = os.path.join(tmp, "bam_oracle", "host.tsv.gz")
    rc, _, _ = _quiet_cli(["-r", wl.library, "-i", wl.inputs[0], "-o",
                           dev_out, "--device", "cuda", "-c", "2"])
    if rc != 0:
        raise AssertionError(f"bam oracle-size CLI run returned {rc}")
    cfg, ref, index = _library_engine_inputs(wl.library)
    with contextlib.redirect_stdout(io.StringIO()):
        bam_pipeline.process(wl.inputs, [HostAlignEngine(index, cfg)], [ref],
                             [cfg], [host_out], 2, False)
    got, want = _gunzip(dev_out), _gunzip(host_out)
    n_rows = got.count(b"\n") - 1
    if got != want or n_rows < 100:
        raise AssertionError("bam: cuda TSV != HostAlignEngine TSV")
    RUNS["bam_oracle"] = (wl, got)
    print(f"[bam] {ORACLE_GROUPS * 8} records of the bench BAM: cuda TSV == "
          f"bam_pipeline.process with HostAlignEngine TSV ({n_rows} rows)")


def phase_bam(tmp: str, seed: int, counters: Counters, trace: bool):
    """The port's CLI on BAM input at both sizes; returns result rows."""
    import torch

    from nimble_tpu_torch.workload import write_bam_workload

    os.environ["NIMBLE_TIMING"] = "1"
    rows = []
    for name, n_feat, feat_len, n_groups in SIZES:
        t0 = time.perf_counter()
        wl = write_bam_workload(os.path.join(tmp, f"bam_{name}"),
                                n_features=n_feat, feat_len=feat_len,
                                n_groups=n_groups, seed=seed)
        n_records = 8 * n_groups
        print(f"[bam] {name}: wrote {n_records} records ({n_groups} groups) "
              f"in {time.perf_counter() - t0:.1f} s")
        outs = {}
        for device, walk in (("cuda", "fused"), ("cuda", "double"),
                             ("cpu", "fused"), ("cpu", "double")):
            out = os.path.join(tmp, f"bam_{name}", f"{device}_{walk}.tsv.gz")
            argv = ["-r", wl.library, "-i", wl.inputs[0], "-o", out,
                    "--device", device, "--walk", walk, "-c", "4"]
            busy = None
            if device == "cuda":
                with counters.run(f"bam {name} {walk}", walk) as counts:
                    if trace and name == "mhc":
                        from torch.profiler import ProfilerActivity, profile

                        with profile(activities=[ProfilerActivity.CUDA]) as p:
                            rc, wall, err = _quiet_cli(argv)
                            torch.cuda.synchronize()
                        busy = _device_us(p)[0] / 1e6 / wall
                    else:
                        rc, wall, err = _quiet_cli(argv)
            else:
                counts = {}
                rc, wall, err = _quiet_cli(argv)
            if rc != 0:
                raise AssertionError(f"bam {name}/{device}/{walk}: rc {rc}")
            outs[(device, walk)] = _gunzip(out)
            split = _timing_split(err)
            row = {"size": name, "features": n_feat, "feature_len": feat_len,
                   "records": n_records, "device": device, "walk": walk,
                   "cli_wall_s": wall, "cli_records_per_s": n_records / wall,
                   "launches": dict(counts), "split_s": split}
            loop = split.get("logger_joined")
            if loop:
                row["loop_records_per_s"] = n_records / loop
            if busy is not None:
                row["device_busy_share"] = busy
            rows.append(row)
            print(f"[bam] {name} ({n_feat} x {feat_len} bp) {device}/{walk}: "
                  f"CLI {wall:.2f} s = {row['cli_records_per_s']:.0f} "
                  f"records/s end to end; process_fast "
                  f"{loop if loop else float('nan'):.2f} s = "
                  f"{row.get('loop_records_per_s', 0.0):.0f} records/s"
                  + (f"; card busy {busy:.3f} of the CLI wall" if busy
                     is not None else ""))
            print(f"[bam] {name} {device}/{walk} split: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
        RUNS[("bam", name)] = (wl, outs[("cuda", "fused")], rows[-4])
        ref_bytes = outs[("cpu", "fused")]
        for key, data in outs.items():
            if data != ref_bytes:
                raise AssertionError(f"bam {name}: {key} TSV != cpu TSV")
        n_rows = ref_bytes.count(b"\n") - 1
        if n_rows < n_groups:
            raise AssertionError(f"bam {name}: only {n_rows} rows")
        print(f"[bam] {name}: {n_rows} forensic rows; cuda and cpu, fused "
              "and double: byte-equal")
    del os.environ["NIMBLE_TIMING"]
    _bam_oracles(tmp, seed)
    return rows


def phase_align_batch(tmp: str, seed: int, counters: Counters):
    """``TorchAlignEngine.align_batch`` on the card, both walks: over
    ORACLE_READS reads of the bench library, result for result equal to the
    port's HostAlignEngine; ``bam_pipeline.process`` over the bench BAM of
    ORACLE_GROUPS groups (the slow pipeline, one consumer thread), equal to
    the HostAlignEngine run and to process_fast; the golden fixture through
    it, equal to forensic_quirks.tsv; and the CLI's ``--engine host`` TSV
    equal to the card CLI's.  Returns result rows."""
    import torch

    from nimble_tpu_torch.core.calls import HostAlignEngine
    from nimble_tpu_torch.io.fastq import read_fastq_codes
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.pipeline import bam_pipeline
    from nimble_tpu_torch.workload import write_workload

    _name, n_feat, feat_len, _groups = SIZES[0]
    d = os.path.join(tmp, "align_batch")
    wl = write_workload(d, n_features=n_feat, feat_len=feat_len, read_len=90,
                        n_reads=ORACLE_READS, seed=seed)
    cfg, ref, index = _library_engine_inputs(wl.library)
    reads = read_fastq_codes(wl.inputs[0])
    t0 = time.perf_counter()
    want = HostAlignEngine(index, cfg).align_batch(reads)
    host_s = time.perf_counter() - t0
    aligned = sum(a is not None for a, _f in want)
    if aligned < len(reads) // 2:
        raise AssertionError(f"align_batch: only {aligned} reads aligned")
    rows = []
    for walk in WALK_KERNELS:
        engine = TorchAlignEngine(index, cfg, device="cuda", walk=walk)
        with counters.run(f"align_batch {walk}", walk) as counts:
            t0 = time.perf_counter()
            got = engine.align_batch(reads)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if got != want:
            bad = sum(g != w for g, w in zip(got, want))
            raise AssertionError(f"align_batch {walk}: {bad} results differ "
                                 "from HostAlignEngine")
        rows.append({"case": "align_batch", "walk": walk,
                     "reads": len(reads), "wall_s": wall,
                     "host_wall_s": host_s, "launches": dict(counts)})
        print(f"[align_batch] {walk}: {len(reads)} reads ({aligned} aligned) "
              f"in {wall:.3f} s on the card, == HostAlignEngine.align_batch "
              f"({host_s:.2f} s) result for result; launches {dict(counts)}")

    host_out, card_out = (os.path.join(d, f) for f in ("host.tsv", "cuda.tsv"))
    rc_h, host_wall, _ = _quiet_cli(["-r", wl.library, "-i", wl.inputs[0],
                                     "-o", host_out, "--engine", "host"])
    with counters.run("align_batch card CLI", "fused"):
        rc_c, card_wall, _ = _quiet_cli(["-r", wl.library, "-i",
                                         wl.inputs[0], "-o", card_out,
                                         "--device", "cuda"])
    if rc_h or rc_c or _tsv_lines(host_out)[0] != _tsv_lines(card_out)[0]:
        raise AssertionError("CLI --engine host TSV != card CLI TSV")
    print(f"[align_batch] CLI --engine host ({host_wall:.2f} s) TSV == card "
          f"CLI ({card_wall:.2f} s) TSV, {ORACLE_READS} reads")

    bam_wl, fast_bytes = RUNS["bam_oracle"]
    b_cfg, b_ref, b_index = _library_engine_inputs(bam_wl.library)
    golden = os.path.join(ROOT, "tests", "data", "golden")
    g_ref, g_index, g_cfg = _golden_forensic_inputs()
    with open(os.path.join(golden, "forensic_quirks.tsv"), "rb") as f:
        golden_bytes = f.read()
    for walk in WALK_KERNELS:
        for label, engine, ref_, cfg_, bam, want_bytes in (
                ("bench BAM", TorchAlignEngine(b_index, b_cfg, device="cuda",
                                               walk=walk),
                 b_ref, b_cfg, bam_wl.inputs[0], fast_bytes),
                ("golden BAM", TorchAlignEngine(g_index, g_cfg, device="cuda",
                                                walk=walk),
                 g_ref, g_cfg, os.path.join(golden, "forensic.bam"),
                 golden_bytes)):
            out = os.path.join(d, f"slow_{label[:5]}_{walk}.tsv.gz")
            with counters.run(f"bam_pipeline {label} {walk}", walk) as counts:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    bam_pipeline.process([bam], [engine], [ref_], [cfg_],
                                         [out], 2, False)
                wall = time.perf_counter() - t0
            if _gunzip(out) != want_bytes:
                raise AssertionError(f"bam_pipeline {label} {walk}: bytes "
                                     "differ")
            rows.append({"case": f"bam_pipeline {label}", "walk": walk,
                         "wall_s": wall, "launches": dict(counts)})
            print(f"[align_batch] bam_pipeline.process, {label}, {walk}: "
                  f"{wall:.2f} s; launches {dict(counts)}")
    print(f"[align_batch] bam_pipeline.process with TorchAlignEngine: the "
          f"bench BAM ({ORACLE_GROUPS} groups) == the HostAlignEngine run == "
          "process_fast; tests/data/golden/forensic.bam == "
          "forensic_quirks.tsv; byte for byte, both walks")
    return rows


def _mesh_api_run(run: dict, init_method: str) -> int:
    """One rank of the library API on a mesh: TorchMeshAlignEngine on
    ``run["shape"]``, fastq_pipeline.process on rank 0 while the other
    ranks serve."""
    from nimble_tpu_torch.models.mesh_aligner import TorchMeshAlignEngine
    from nimble_tpu_torch.parallel.mesh import Mesh, init_runtime
    from nimble_tpu_torch.pipeline import fastq_pipeline

    runtime = init_runtime("cuda", init_method=init_method)
    ok = False
    try:
        mesh = Mesh(runtime, *run["shape"])
        cfg, ref, index = _library_engine_inputs(run["library"])
        engine = TorchMeshAlignEngine(index, cfg, mesh=mesh, walk=run["walk"])
        if runtime.is_controller:
            fastq_pipeline.process([run["fastq"]], [engine], [ref], [cfg],
                                   [run["out"]])
        else:
            runtime.serve()
        ok = True
        return 0
    finally:
        runtime.close(ok)


def worker(run_dir: str) -> int:
    """A process of the mesh or the multihost phase (rank or host ``RANK``
    of ``WORLD_SIZE``): every run of ``run_dir/runs.json`` in turn (the CLI
    with ``--engine mesh``, the library API on a mesh, or the CLI as one
    host of a multi-host run, ``--num-processes``), each with its own
    process group and its launch counters set to 0 just before it; writes
    ``run_dir/rank<r>.json``: per run its exit code, wall time, launches
    and (multi-host runs) its NIMBLE_TIMING lines, and the jax / nimble_tpu
    modules this process loaded."""
    import torch

    sys.path.insert(0, ROOT)
    from nimble_tpu_torch import cli

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    counters = Counters()
    with open(os.path.join(run_dir, "runs.json")) as f:
        runs = json.load(f)
    report = {"rank": rank, "runs": []}
    for i, run in enumerate(runs):
        init = "file://" + os.path.join(run_dir, f"init{i}")
        for w in counters.wrappers.values():
            w.launches = 0
        entry = {}
        t0 = time.perf_counter()
        if run["kind"] == "cli":
            rc = cli.main(run["argv"] + ["--engine", "mesh", "--device",
                                         "cuda", "--init-method", init])
        elif run["kind"] == "host":
            err = io.StringIO()
            os.environ["NIMBLE_TIMING"] = "1"
            with contextlib.redirect_stderr(err):
                rc = cli.main(run["argv"] + [
                    "--device", "cuda", "--num-processes", str(world),
                    "--process-id", str(rank), "--init-method", init])
            del os.environ["NIMBLE_TIMING"]
            entry["timing"] = [ln for ln in err.getvalue().splitlines()
                               if ln.startswith(("[multihost", "[byterange"))]
        else:
            rc = _mesh_api_run(run, init)
        torch.cuda.synchronize()
        report["runs"].append(dict(
            entry, rc=rc, wall_s=time.perf_counter() - t0,
            launches={n: w.launches for n, w in counters.wrappers.items()}))
    report["leaked"] = sorted(m for m in sys.modules if m.split(".")[0] in
                              ("jax", "jaxlib", "nimble_tpu"))
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def _workers(run_dir: str, runs: list) -> list:
    """Start MESH_RANKS processes of this script (``--worker``) with the
    environment torchrun gives its ranks, all on the one card; wait at most
    MESH_TIMEOUT_S, kill what is left, and return each process's report."""
    with open(os.path.join(run_dir, "runs.json"), "w") as f:
        json.dump(runs, f)
    procs = []
    for rank in range(MESH_RANKS):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(MESH_RANKS),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(MESH_RANKS))
        log = open(os.path.join(run_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             run_dir], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for p, _log in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, (p, _log) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(run_dir, f"rank{rank}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"worker {rank} exited {p.returncode}:\n"
                                 f"{tail}")
    with open(os.path.join(run_dir, "rank0.log")) as f:
        for line in f:
            if line.startswith("[mesh]"):
                print(line.rstrip())
    reports = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(run_dir, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    return reports


def phase_mesh(tmp: str, counters: Counters):
    """The mesh on two ranks sharing the one card (gloo): the CLI's
    ``--engine mesh`` on a (1, 2) mesh (the table split over two model
    shards) at the MHC-scale library with both walks, on the 4 x bench
    libraries (the mesh's stacked pass) and on the bench BAM (``-c 4``);
    the library API on a (2, 1) mesh (reads split over two data rows) on
    the bench library.  Every output must equal the single-device card run
    of the earlier phases byte for byte, and every rank's walk kernel must
    launch in every run.  Returns result rows."""
    d = os.path.join(tmp, "mesh")
    os.makedirs(d)
    smi = nvidia_smi()
    mhc_wl, (_o, mhc_wall, *_r) = RUNS[("fastq", "mhc")]
    bench_wl, (_o, bench_wall, *_r) = RUNS[("fastq", "bench")]
    multi_wl, (multi_tsvs, multi_wall, _c) = RUNS[("multi_fastq", "4 x bench")]
    bam_wl, bam_bytes, bam_row = RUNS[("bam", "bench")]
    single = {  # case -> (single-device bytes per output, its wall)
        "mhc": ([_tsv_lines(RUNS[("fastq", "mhc")][1][0])[0]], mhc_wall),
        "bench": ([_tsv_lines(RUNS[("fastq", "bench")][1][0])[0]],
                  bench_wall),
        "4 x bench": (multi_tsvs, multi_wall),
        "bench BAM": ([bam_bytes], bam_row["cli_wall_s"]),
    }

    def out(name):
        return os.path.join(d, name)

    runs, cases = [], []
    for walk in WALK_KERNELS:
        runs.append({"kind": "cli", "argv": [
            "-r", mhc_wl.library, "-i", mhc_wl.inputs[0], "-o",
            out(f"mhc_{walk}.tsv"), "--walk", walk]})
        cases.append(("mhc", walk, (1, 2), [out(f"mhc_{walk}.tsv")]))
    multi_outs = [out(f"multi_{i}.tsv") for i in range(len(multi_wl.libraries))]
    runs.append({"kind": "cli", "argv": _library_argv(
        multi_wl.libraries, multi_outs) + ["-i", multi_wl.inputs[0]]})
    cases.append(("4 x bench", "fused", (1, 2), multi_outs))
    runs.append({"kind": "cli", "argv": [
        "-r", bam_wl.library, "-i", bam_wl.inputs[0], "-o",
        out("bam.tsv.gz"), "-c", "4"]})
    cases.append(("bench BAM", "fused", (1, 2), [out("bam.tsv.gz")]))
    runs.append({"kind": "api", "shape": [2, 1], "walk": "fused",
                 "library": bench_wl.library, "fastq": bench_wl.inputs[0],
                 "out": out("api_bench.tsv")})
    cases.append(("bench", "fused", (2, 1), [out("api_bench.tsv")]))

    t0 = time.perf_counter()
    reports = _workers(d, runs)
    total = time.perf_counter() - t0
    for rep in reports:
        if rep["leaked"]:
            raise AssertionError(f"mesh rank {rep['rank']} imported "
                                 f"{rep['leaked'][:5]}")
    rows = []
    for i, (case, walk, shape, outs) in enumerate(cases):
        per_rank = [rep["runs"][i] for rep in reports]
        kernel = WALK_KERNELS[walk]
        for rank, r in enumerate(per_rank):
            others = {n: v for n, v in r["launches"].items()
                      if n != kernel and v}
            if r["rc"] != 0 or r["launches"][kernel] <= 0 or others:
                raise AssertionError(f"mesh {case} {walk} rank {rank}: rc "
                                     f"{r['rc']}, launches {r['launches']}")
        got = [_gunzip(o) if o.endswith(".gz") else _tsv_lines(o)[0]
               for o in outs]
        want, single_wall = single[case]
        if got != want:
            raise AssertionError(f"mesh {case} {walk} {shape}: output != the "
                                 "single-device card run")
        for name in counters.main_path:
            counters.main_path[name] += sum(r["launches"][name]
                                            for r in per_rank)
        wall = per_rank[0]["wall_s"]
        row = {"case": case, "walk": walk, "mesh": list(shape),
               "ranks": MESH_RANKS, "backend": "gloo", "wall_s": wall,
               "single_device_wall_s": single_wall,
               "launches_per_rank": [r["launches"][kernel]
                                     for r in per_rank], "card": smi}
        rows.append(row)
        print(f"[mesh] {case}, {walk}, {shape} mesh on {MESH_RANKS} ranks: "
              f"CLI/API {wall:.2f} s (single device {single_wall:.2f} s); "
              f"{kernel} launches per rank {row['launches_per_rank']}; "
              f"output == the single-device card run byte for byte; {smi}")
    print(f"[mesh] {len(cases)} runs on two ranks sharing one card in "
          f"{total:.1f} s, process start-up included (gloo merges on the "
          "host: this measures the protocol, not multi-card scaling)")
    return rows


def _timing_fields(lines) -> tuple:
    """A host's ``[multihost host i] stage 1.23s ... (N owned reads)``
    NIMBLE_TIMING line -> ({stage: seconds}, N)."""
    for line in lines:
        if line.startswith("[multihost host"):
            stages, owned = line.split("] ", 1)[1].split(" (")
            words = stages.split()
            return ({k: float(v.rstrip("s"))
                     for k, v in zip(words[0::2], words[1::2])},
                    int(owned.split()[0]))
    raise AssertionError(f"no [multihost host] line in {lines}")


def phase_multihost(tmp: str, seed: int, counters: Counters):
    """The CLI's multi-host mode (``--num-processes 2``): two host
    processes of this script sharing the card, each with its own
    TorchAlignEngine on it and its own pipeline, meeting in a gloo process
    group (``file://`` rendezvous): the bench FASTQ of phase 4 (2^19 reads,
    the byte-range feed), a paired FASTQ of 2^17 pairs over the bench
    library (a full parse sliced by record, pairs routed as units) and the
    bench BAM of phase 6 (131,072 records, group ranges).  Each output must
    equal its single-device card run byte for byte (the paired one is made
    here), and the walk kernel must launch on both hosts in every run.
    Returns result rows."""
    from nimble_tpu_torch.workload import write_workload

    d = os.path.join(tmp, "multihost")
    os.makedirs(d)
    smi = nvidia_smi()
    bench_wl, (bench_out, bench_wall, *_r) = RUNS[("fastq", "bench")]
    bam_wl, bam_bytes, bam_row = RUNS[("bam", "bench")]
    _name, n_feat, feat_len, _groups = SIZES[0]
    t0 = time.perf_counter()
    paired = write_workload(os.path.join(d, "paired"), n_features=n_feat,
                            feat_len=feat_len, read_len=90,
                            n_reads=MULTIHOST_PAIRS, seed=seed, paired=True,
                            mate_gap=50)
    print(f"[multihost] wrote {MULTIHOST_PAIRS} pairs in "
          f"{time.perf_counter() - t0:.1f} s")
    single_paired = os.path.join(d, "single_paired.tsv")
    with counters.run("multihost paired single-device", "fused"):
        rc, paired_wall, _ = _quiet_cli(
            ["-r", paired.library, "-i", paired.inputs[0], "-i",
             paired.inputs[1], "-o", single_paired, "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"paired single-device CLI returned {rc}")

    def out(name):
        return os.path.join(d, name)

    cases = [  # (case, argv, output, single-device bytes, its wall, units)
        ("bench FASTQ", ["-r", bench_wl.library, "-i", bench_wl.inputs[0]],
         out("bench.tsv"), _tsv_lines(bench_out)[0], bench_wall,
         "reads"),
        ("paired FASTQ", ["-r", paired.library, "-i", paired.inputs[0], "-i",
                          paired.inputs[1]],
         out("paired.tsv"), _tsv_lines(single_paired)[0], paired_wall,
         "pairs"),
        ("bench BAM", ["-r", bam_wl.library, "-i", bam_wl.inputs[0], "-c",
                       "4"],
         out("bam.tsv.gz"), bam_bytes, bam_row["cli_wall_s"], "groups"),
    ]
    runs = [{"kind": "host", "argv": argv + ["-o", o]}
            for _c, argv, o, *_r in cases]
    t0 = time.perf_counter()
    reports = _workers(d, runs)
    total = time.perf_counter() - t0
    for rep in reports:
        if rep["leaked"]:
            raise AssertionError(f"multihost host {rep['rank']} imported "
                                 f"{rep['leaked'][:5]}")
    rows = []
    for i, (case, _argv, o, want, single_wall, units) in enumerate(cases):
        per_host = [rep["runs"][i] for rep in reports]
        for host, r in enumerate(per_host):
            others = {n: v for n, v in r["launches"].items()
                      if n != "fused_span_walk" and v}
            if (r["rc"] != 0 or r["launches"]["fused_span_walk"] <= 0
                    or others):
                raise AssertionError(f"multihost {case} host {host}: rc "
                                     f"{r['rc']}, launches {r['launches']}")
        got = _gunzip(o) if o.endswith(".gz") else _tsv_lines(o)[0]
        if got != want:
            raise AssertionError(f"multihost {case}: output != the "
                                 "single-device card run")
        if any(".part" in name for name in os.listdir(d)):
            raise AssertionError(f"multihost {case}: part files remain")
        counters.main_path["fused_span_walk"] += sum(
            r["launches"]["fused_span_walk"] for r in per_host)
        hosts = [{"wall_s": r["wall_s"],
                  **dict(zip(("split_s", "owned"),
                             _timing_fields(r["timing"]))),
                  "walk_launches": r["launches"]["fused_span_walk"]}
                 for r in per_host]
        row = {"case": case, "hosts": 2, "backend": "gloo",
               "wall_s": max(h["wall_s"] for h in hosts),
               "single_device_wall_s": single_wall, "per_host": hosts,
               "card": smi}
        rows.append(row)
        for host, h in enumerate(hosts):
            split = ", ".join(f"{k} {v} s" for k, v in h["split_s"].items())
            print(f"[multihost] {case}, host {host} of 2: CLI {h['wall_s']:.2f}"
                  f" s; split {split}; {h['owned']} {units} owned; "
                  f"fused_span_walk launches {h['walk_launches']}")
        print(f"[multihost] {case}: two hosts {row['wall_s']:.2f} s (single "
              f"device {single_wall:.2f} s); output == the single-device "
              f"card run byte for byte; {smi}")
    print(f"[multihost] {len(cases)} runs on two host processes sharing one "
          f"card in {total:.1f} s, process start-up included (gloo through "
          "host memory: this measures the protocol and the host feed, not "
          "multi-host scaling)")
    return rows


def phase_entry(counters: Counters):
    """The driver entries (``nimble_tpu_torch.graft_entry``): ``entry()``'s
    step on the card equal to ``entry(device="cpu")``'s (the plain
    versions), and ``dryrun_multichip(2)`` on two ranks sharing the card
    (gloo), with the walk kernel launching on both.  Returns a result
    row."""
    import torch

    from nimble_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    with counters.run("entry", "fused") as counts:
        got = fn(*args)
        torch.cuda.synchronize()
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    want = cpu_fn(*cpu_args)
    if got.shape != want.shape or not torch.equal(got.cpu(), want):
        raise AssertionError("entry(): the card's step != the CPU's")
    t0 = time.perf_counter()
    reports = graft_entry.dryrun_multichip(MESH_RANKS)
    wall = time.perf_counter() - t0
    launches = [r["launches"]["fused_span_walk"] for r in reports]
    for r in reports:
        if (r["leaked"] or r["launches"]["fused_span_walk"] <= 0
                or r["launches"]["double_walk"]):
            raise AssertionError(f"dryrun rank {r['rank']}: launches "
                                 f"{r['launches']}, imported "
                                 f"{r['leaked'][:5]}")
    counters.main_path["fused_span_walk"] += sum(launches)
    checks = reports[0]["checks"]
    print(f"[entry] entry(): ({got.shape[0]}, {got.shape[1]}) int32 on the "
          f"card == entry(device='cpu'); launches {dict(counts)}")
    print(f"[entry] dryrun_multichip({MESH_RANKS}): {checks} on "
          f"{reports[0]['device']} ({reports[0]['backend']}), == the "
          f"single-device engines field for field; fused_span_walk launches "
          f"per rank {launches}; {wall:.2f} s, start-up included")
    return {"entry_launches": dict(counts), "dryrun_ranks": MESH_RANKS,
            "dryrun_checks": checks, "dryrun_wall_s": wall,
            "dryrun_launches_per_rank": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=1 << 19,
                    help="reads per FASTQ run (default 2^19)")
    ap.add_argument("--trace", action="store_true",
                    help="profile the MHC BAM card runs (device busy share)")
    ap.add_argument("--worker", metavar="DIR",
                    help="run as one rank of the mesh phase or one host of "
                         "the multihost phase (started by the script "
                         "itself)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker)
    sys.path.insert(0, ROOT)
    import nimble_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *fn_args):
        t0 = time.perf_counter()
        result = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t0
        return result

    timed("build", phase_build)
    kernel = timed("kernel", phase_kernel, args.seed)
    kernel.update(timed("gather_kernels", phase_gather_kernels, args.seed))
    counters = Counters()
    timed("gather", phase_gather, counters)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fastq_rows = timed("fastq", phase_fastq, tmp, args.seed, args.reads,
                           counters)
        multi_fastq_rows = timed("multi_fastq", phase_multi_fastq, tmp,
                                 args.seed, args.reads, counters)
        bam_rows = timed("bam", phase_bam, tmp, args.seed, counters,
                         args.trace)
        multi_bam_rows = timed("multi_bam", phase_multi_bam, tmp, args.seed,
                               counters)
        align_batch_rows = timed("align_batch", phase_align_batch, tmp,
                                 args.seed, counters)
        mesh_rows = timed("mesh", phase_mesh, tmp, counters)
        multihost_rows = timed("multihost", phase_multihost, tmp, args.seed,
                               counters)
    entry_row = timed("entry", phase_entry, counters)

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "nimble_tpu"))
    if leaked:
        raise AssertionError(f"the port's path imported jax or the JAX "
                             f"package: {leaked[:5]}")
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(json.dumps({"fastq": fastq_rows}))
    print(json.dumps({"multi_fastq": multi_fastq_rows}))
    print(json.dumps({"bam": bam_rows}))
    print(json.dumps({"multi_bam": multi_bam_rows}))
    print(json.dumps({"align_batch": align_batch_rows}))
    print(json.dumps({"mesh": mesh_rows}))
    print(json.dumps({"multihost": multihost_rows}))
    print(json.dumps({"entry": entry_row}))
    lines = []
    for name, cases in kernel.items():
        main_row = cases[0]
        extra = {}
        if name in GATHER_KERNELS:
            source = "nimble_tpu_torch/csrc/gather_rows.cu"
            shape = (f"table ({main_row['N']}, {main_row['W']}) int32, "
                     f"M={main_row['M']}, {main_row['case']}")
            extra = {
                "design": main_row["design"],
                "cases": [{k: r[k] for k in GATHER_CASE_KEYS} for r in cases]}
        else:
            source = f"nimble_tpu_torch/csrc/{name}.cu"
            shape = f"B={KERNEL_BATCH} C=8 Lmax={main_row['Lmax']}"
            if "T" in main_row:
                shape += f" T={main_row['T']} Tl={main_row['Tl']}"
        lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name],
            "launches": counters.main_path[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            **{k: main_row.get(k) for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "plain_device_ms", "library_device_ms",
                "bound_bytes", "bound_ops", "bound_share",
                "small_batch_device_ms", "cold_device_ms",
                "cold_bound_share")},
            "shape": shape, **extra,
        })
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
