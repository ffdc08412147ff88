"""Throughput benchmark of the torch port: the root ``bench.py``'s modes,
workloads and JSON line, run through ``TorchAlignEngine`` and its walk
kernels.

    python -m nimble_tpu_torch.bench [--device cuda|cpu] [--walk fused|double]
        [--paired | --mesh | --e2e | --bam | --libraries N
         | --multihost-cpu N] [--reads N] [--chunk N] [--timed-rounds N] ...

Workload: a synthetic custom reference library (50 features x 500 bp, like
the KIR-style libraries nimble targets) against 90 bp reads of which ~20%
carry one substitution and ~5% are junk, drawn exactly as the root
``bench.py``'s ``build_workload`` draws them (the same arrays, byte for
byte).  The modes:

- default: in-memory matrices through ``FastCounter.dispatch_async`` at
  ``--depth`` chunks in flight (dedupe, pack, upload and launch on a
  dispatch thread, collect on a fetch thread, counting on this one), best
  of ``--timed-rounds`` rounds after one warm-up, with the median beside
  it, ``kernel_ns_per_read`` (the root bench's device-resident launch time
  per read: queued passes between CUDA events, which on the card also
  time the host's enqueue of each pass's torch ops) and
  ``kernel_device_ns_per_read`` (the same pass's kernel time on the card,
  from a profiler trace; null on the CPU);
  ``--paired`` adds R2 mates, the reverse complements of R1;
- ``--mesh``: the same loop through ``TorchMeshAlignEngine`` on the mesh
  of the ``torchrun`` ranks (``parallel.mesh``); without a ``torchrun``
  environment one rank, a (1, 1) mesh;
- ``--e2e``: the same reads written as a FASTQ and counted by
  ``pipeline.fastq_pipeline.process``, parse and TSV included;
- ``--bam``: a synthetic 10x BAM through ``pipeline.bam_fast.process_fast``
  (``bam_pipeline.process`` when the native host library is missing; the
  row names the pipeline that ran);
- ``--libraries N``: N libraries in one stacked pass per chunk
  (``TorchMultiLibraryDispatcher``);
- ``--multihost-cpu N``: N pinned CLI processes of a multi-host run against
  one process on the same cores, on the CPU only.

Baseline note: the reference publishes no benchmark numbers (BASELINE.md),
so ``vs_baseline`` divides by the high end of the defended 20k-170k
reads/s estimate of the reference's single-process throughput
(BASELINE.md, "Defended baseline estimate"); the row carries the range.

Prints ONE JSON line, the root bench's keys plus ``engine``, ``walk``,
``device`` (the torch device and, on a card, its name and power limit as
``nvidia-smi`` reports them) and, beside ``kernel_ns_per_read``,
``kernel_device_ns_per_read``.  ``--device cuda`` (the default) on a machine
without a card exits non-zero and prints no rate: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from nimble_tpu_torch import native
from nimble_tpu_torch.config import AlignFilterConfig
from nimble_tpu_torch.core.fast_count import FastCounter, split_stacked
from nimble_tpu_torch.index.build import build_index
from nimble_tpu_torch.io.synth import make_synthetic_bam
from nimble_tpu_torch.library import Reference
from nimble_tpu_torch.models.aligner import TorchAlignEngine, pack_reads
from nimble_tpu_torch.models.mesh_aligner import TorchMeshAlignEngine
from nimble_tpu_torch.models.multi_aligner import TorchMultiLibraryDispatcher
from nimble_tpu_torch.ops.compact import WALKS
from nimble_tpu_torch.parallel.mesh import Mesh, init_runtime, mesh_shape
from nimble_tpu_torch.pipeline import bam_pipeline, fastq_pipeline
from nimble_tpu_torch.pipeline.bam_fast import process_fast
from nimble_tpu_torch.utils.dna import encode_bases, revcomp
from nimble_tpu_torch.utils.metrics import device_ms
from nimble_tpu_torch.workload import write_fastq

# High end of the defended 20k-170k reads/s estimate range (BASELINE.md,
# "Defended baseline estimate") — generous to the reference by design.
BASELINE_RANGE_READS_PER_SEC = (20_000.0, 170_000.0)
RUST_BASELINE_READS_PER_SEC = BASELINE_RANGE_READS_PER_SEC[1]
_base_note = {"baseline_range_reads_per_sec": list(BASELINE_RANGE_READS_PER_SEC)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_workload(n_features=50, feat_len=500, read_len=90, n_reads=1 << 16, seed=0):
    """(index, reference, config, reads (n_reads, read_len) int8, lens):
    the root bench's workload, drawn in the same order from the same
    generator."""
    rng = np.random.default_rng(seed)
    feats = ["".join(rng.choice(list("ACGT"), size=feat_len)) for _ in range(n_features)]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    names = []
    for i in range(n_features):
        names.append(f"feature{i}")
        names.append(f"feature{i}§rev")
    reference = Reference(
        group_on=0,
        headers=["sequence_name", "sequence"],
        columns=[names, doubled],
        sequence_name_idx=0,
        sequence_idx=1,
    )
    cfg = AlignFilterConfig(
        reference_genome_size=len(doubled),
        score_percent=0.33,
        score_threshold=50,
        num_mismatches=1,
        max_hits_to_report=10,
    )
    index = build_index(doubled)

    # reads: sampled fragments; ~20% carry one substitution, ~5% are junk
    rows = rng.integers(0, len(doubled), n_reads)
    starts = rng.integers(0, feat_len - read_len, n_reads)
    base_codes = np.stack([encode_bases(s) for s in doubled])
    mat = base_codes[rows[:, None], starts[:, None] + np.arange(read_len)]
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    mutate = rng.random(n_reads) < 0.2
    pos = rng.integers(0, read_len, n_reads)
    delta = rng.integers(1, 4, n_reads).astype(np.int8)
    mat[mutate, pos[mutate]] = (mat[mutate, pos[mutate]] + delta[mutate]) % 4
    junk = rng.random(n_reads) < 0.05
    mat[junk] = rng.integers(0, 4, (junk.sum(), read_len), dtype=np.int8)
    lens = np.full(n_reads, read_len, dtype=np.int32)
    return index, reference, cfg, mat, lens


def paired_mates(mat, lens):
    """R2 mates of ``--paired``: the reverse complement of each R1 fragment
    (they hit the §rev library rows)."""
    W = mat.shape[1]
    ar = np.arange(W)[None, :]
    ridx = np.clip(lens[:, None] - 1 - ar, 0, W - 1)
    om = np.take_along_axis(mat, ridx, axis=1)
    return np.where(ar < lens[:, None], 3 - om, 0).astype(np.int8), lens.copy()


def _elapsed_s(device: torch.device, fn) -> float:
    """Seconds ``fn`` takes: on a card between two CUDA events on the
    current stream (what ``fn`` queues, to its end), on the CPU by the
    host clock (its ops run as they are called)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _resident_pass(engine, mat, lens):
    """The compact pass of one ``launch_batch`` of reads on resident
    buffers: packs the batch (zero rows pad a short one) and uploads it
    twice; returns (launch, the two buffers)."""
    lb = engine.launch_batch
    bucket_arr = np.asarray(engine.buckets)
    bucket = int(bucket_arr[np.searchsorted(bucket_arr, int(lens.max()))])
    m = min(mat.shape[0], lb)
    buf = np.zeros((lb, (bucket + 3) // 4 + 2), dtype=np.uint8)
    buf[:m] = pack_reads(mat[:m], lens[:m], bucket)
    x1 = torch.from_numpy(buf).to(engine.device)
    x2 = x1.clone()  # distinct buffer, same value
    return engine._device_pass(bucket, False), x1, x2


def measure_kernel_ns_per_read(engine, mat, lens, log, n_launches=16):
    """Device-resident compact pass time, ns/read.

    Queues N launches of the engine's compact pass alternating two resident
    buffers (:func:`_resident_pass`): (wall - one launch) / (N - 1), best
    of 3, amortizes the submission and excludes every transfer.  The root
    bench's method: on the card the CUDA events also time the host's
    enqueue of the pass's torch ops (:func:`measure_kernel_device_ns_per_read`
    gives the card's own time).
    """
    lb = engine.launch_batch
    launch, x1, x2 = _resident_pass(engine, mat, lens)
    _elapsed_s(engine.device, lambda: launch(x1))  # warm-up
    best = 1e9
    for _ in range(3):
        wall = _elapsed_s(engine.device, lambda: [
            launch(x1 if i % 2 == 0 else x2) for i in range(n_launches)])
        one = _elapsed_s(engine.device, lambda: launch(x1))
        best = min(best, max(wall - one, 0.0) / (n_launches - 1))
    ns = best / lb * 1e9
    log(f"kernel: {best*1e3:.3f} ms / {lb}-read launch = {ns:.0f} ns/read")
    return ns


def measure_kernel_device_ns_per_read(engine, mat, lens, log,
                                      n_launches=16):
    """The same compact pass's device time, ns/read: the summed time of its
    kernels on the card from a torch.profiler trace of N launches
    (``utils.metrics.device_ms``), without the host's enqueue.  None on the
    CPU, which has no device time."""
    if engine.device.type != "cuda":
        return None
    launch, x1, _x2 = _resident_pass(engine, mat, lens)
    ms = device_ms(lambda: launch(x1), n_launches)
    ns = ms / 1e3 / engine.launch_batch * 1e9
    log(f"kernel device time: {ms:.3f} ms / {engine.launch_batch}-read "
        f"launch = {ns:.1f} ns/read")
    return ns


def bench_bam(args, log, device):
    """End-to-end threaded BAM pipeline throughput (records/s); returns
    (row, the last round's decompressed forensic TSV)."""
    index, reference, cfg, _, _ = build_workload(n_reads=1)
    engine = TorchAlignEngine(index, cfg, device=device, walk=args.walk)
    feats = reference.columns[1][0::2]

    with tempfile.TemporaryDirectory() as td:
        bam = f"{td}/bench.bam"
        n_records = make_synthetic_bam(
            bam, feats, n_groups=args.bam_groups, pairs_per_group=4,
            read_len=90, seed=1, mutate_every=5,
        )
        log(f"synthetic BAM: {n_records} records, {args.bam_groups} groups")

        use_fast = native.available()

        def run(out):
            with contextlib.redirect_stdout(io.StringIO()):
                if use_fast:
                    process_fast(
                        [bam], [engine], [reference], [cfg], [out],
                        args.bam_cores, False,
                        batch_records=args.bam_batch,
                    )
                else:
                    bam_pipeline.process(
                        [bam], [engine], [reference], [cfg], [out],
                        args.bam_cores, False,
                    )

        run(f"{td}/warm.tsv.gz")  # warm-up
        times = []
        for r in range(6):
            t0 = time.time()
            run(f"{td}/out{r}.tsv.gz")
            dt = time.time() - t0
            times.append(dt)
            log(f"bam round {r}: {dt:.2f}s -> {n_records/dt:,.0f} records/s")
        with gzip.open(f"{td}/out5.tsv.gz", "rb") as f:
            forensic = f.read()
    rps = n_records / min(times)
    return {
        "metric": "bam_pipeline_records_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "records/s",
        "vs_baseline": round(rps / RUST_BASELINE_READS_PER_SEC, 2),
        "pipeline": "fast" if use_fast else "slow",
        "engine": type(engine).__name__,
    }, forensic


def bench_e2e(args, log, device):
    """From-disk end-to-end FASTQ bench: parse -> align -> count -> TSV.

    Writes the bench workload's reads as a FASTQ and times
    ``pipeline.fastq_pipeline.process``, so the rate is comparable with the
    reference's FASTQ path (`src/process/fastq.rs:7-30`).  The file lives
    in the temporary directory and is read back from the page cache.
    Returns (row, the last round's TSV bytes).
    """
    index, reference, cfg, mat, lens = build_workload(
        n_features=args.features, feat_len=args.feat_len, n_reads=args.reads)
    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "bench_e2e.fastq")
        out = os.path.join(td, "bench_e2e.tsv")
        t0 = time.time()
        write_fastq(fq, mat)
        log(f"wrote {os.path.getsize(fq)/1e6:.1f} MB FASTQ in "
            f"{time.time()-t0:.1f}s")

        engine = TorchAlignEngine(index, cfg, device=device, walk=args.walk)

        def run():
            if os.path.exists(out):
                os.remove(out)
            with contextlib.redirect_stdout(io.StringIO()) as cap:
                fastq_pipeline.process([fq], [engine], [reference], [cfg],
                                       [out], chunk_reads=args.chunk)
            return cap.getvalue()

        run()  # warm-up
        times = []
        for r in range(args.timed_rounds):
            t0 = time.time()
            stages = run()
            dt = time.time() - t0
            times.append(dt)
            log(f"e2e round {r}: {dt:.3f}s -> {args.reads/dt:,.0f} reads/s")
        log("pipeline stage meter (last round):", stages.strip())
        with open(out, "rb") as f:
            tsv = f.read()
    rps = args.reads / min(times)
    return {
        "metric": "fastq_e2e_from_disk_reads_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / RUST_BASELINE_READS_PER_SEC, 2),
        "engine": type(engine).__name__,
    }, tsv


def bench_multihost_cpu(args, log):
    """Multi-host overhead ratio on ONE machine: N coordinated CLI processes
    of a multi-host run (``--num-processes N``, gloo), each pinned to a
    disjoint 1/N of this process's CPU cores, vs ONE process on all of
    those cores: same total hardware, same total work.  Efficiency =
    T_single / T_multihost isolates what the multi-host machinery costs
    (byte-range parse split, content-hash routing exchange, count merge).
    Every process runs on the CPU (``--device cpu``).  Returns (row, the
    single-process TSV bytes), which every multi-host output equals.
    """
    n_hosts = args.multihost_cpu
    cores = sorted(os.sched_getaffinity(0))
    per = max(1, len(cores) // n_hosts)
    if per * n_hosts > len(cores):
        raise SystemExit(f"--multihost-cpu {n_hosts} needs at least "
                         f"{n_hosts} CPU cores; this process may use "
                         f"{len(cores)}")
    core_sets = [",".join(str(c) for c in cores[h * per:(h + 1) * per])
                 for h in range(n_hosts)]
    # pin the single-process reference to the SAME cores the multihost run
    # uses in total, so the comparison stays "same total hardware" even
    # when the core count isn't divisible by n_hosts
    single_cores = ",".join(str(c) for c in cores[:n_hosts * per])

    rng = np.random.default_rng(0)
    feats = ["".join(rng.choice(list("ACGT"), size=500)) for _ in range(50)]
    with tempfile.TemporaryDirectory() as td:
        lib = f"{td}/lib.json"
        with open(lib, "w") as f:
            json.dump([
                {"score_percent": 0.33, "score_filter": 25,
                 "score_threshold": 50, "num_mismatches": 1,
                 "discard_multiple_matches": False,
                 "require_valid_pair": False, "discard_multi_hits": 0,
                 "intersect_level": 0, "max_hits_to_report": 10,
                 "group_on": "", "trim_target_length": 0,
                 "trim_strictness": 0.5},
                {"headers": ["sequence_name", "sequence"],
                 "columns": [[f"f{i}" for i in range(50)], feats]},
            ], f)
        # size the workload so the per-process fixed costs (interpreter,
        # torch import, process group) are <10% of the run; mutate reads so
        # most are DISTINCT (a fully duplicate-heavy file measures only the
        # parse, which trivially scales)
        n = args.reads if args.reads != 2**19 else 6_000_000
        fastq = f"{td}/r.fastq"
        rows = rng.integers(0, 50, n)
        starts = rng.integers(0, 410, n)
        feat_mat = np.frombuffer("".join(feats).encode(), dtype=np.uint8)
        feat_mat = feat_mat.reshape(50, 500)
        reads = feat_mat[rows[:, None], starts[:, None] + np.arange(90)]
        mut_pos = rng.integers(0, 90, n)
        mut_base = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]
        reads[np.arange(n), mut_pos] = mut_base
        blank = np.full((n, 1), ord("\n"), dtype=np.uint8)
        qual = np.full((n, 90), ord("I"), dtype=np.uint8)
        plus = np.tile(np.frombuffer(b"\n+\n", dtype=np.uint8), (n, 1))
        hdr = np.tile(np.frombuffer(b"@rx\n", dtype=np.uint8), (n, 1))
        body = np.concatenate([hdr, reads, plus, qual, blank], axis=1)
        with open(fastq, "wb") as f:
            f.write(body.tobytes())

        env = dict(os.environ, PYTHONPATH=REPO)
        cli = [sys.executable, "-m", "nimble_tpu_torch.cli", "-r", lib, "-i",
               fastq, "--device", "cpu", "--walk", args.walk]
        seq = [0]

        def run_single():
            seq[0] += 1
            out = f"{td}/single{seq[0]}.tsv"
            t0 = time.time()
            rc = subprocess.run(["taskset", "-c", single_cores, *cli, "-o", out],
                                env=env, capture_output=True, timeout=1200)
            if rc.returncode != 0:
                raise RuntimeError(rc.stderr.decode()[-800:])
            shutil.copy(out, f"{td}/single.tsv")
            return time.time() - t0

        def run_multi():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = str(s.getsockname()[1])
            seq[0] += 1
            outs = [f"{td}/mh{seq[0]}_{h}.tsv" for h in range(n_hosts)]
            t0 = time.time()
            procs = [
                subprocess.Popen(
                    ["taskset", "-c", core_sets[h], *cli, "-o", outs[h],
                     "--num-processes", str(n_hosts), "--process-id", str(h),
                     "--coordinator", f"127.0.0.1:{port}"],
                    env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                )
                for h in range(n_hosts)
            ]
            try:
                errs = [p.communicate(timeout=1200)[1] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for p, err in zip(procs, errs):
                if p.returncode != 0:
                    raise RuntimeError(err.decode()[-800:])
            dt = time.time() - t0
            with open(outs[0], "rb") as a, open(f"{td}/single.tsv", "rb") as b:
                if a.read() != b.read():
                    raise AssertionError("the multi-host TSV differs from the "
                                         "single-process TSV")
            return dt

        run_single()  # warm the page cache and the native build
        t1 = min(run_single() for _ in range(2))
        tn = min(run_multi() for _ in range(2))
        with open(f"{td}/single.tsv", "rb") as f:
            tsv = f.read()
    log(f"single ({n_hosts * per} cores): {t1:.1f}s; "
        f"{n_hosts} hosts x {per} cores: {tn:.1f}s")
    eff = t1 / tn
    return {
        "metric": f"fastq_multihost{n_hosts}_overhead_efficiency",
        "value": round(eff, 3),
        "unit": "efficiency",
        "vs_baseline": round(eff / 0.9, 2),  # target >=0.9
        "t_single_s": round(t1, 1),
        "t_multi_s": round(tn, 1),
        "engine": TorchAlignEngine.__name__,
    }, tsv


def bench_multilib(args, log, device):
    """N-library single-pass dispatch (TorchMultiLibraryDispatcher): the
    N-library run should cost ~the cost of one library, vs the reference's
    sequential per-library passes (`src/process/fastq.rs:15`).  Returns
    (row, each library's counted results of the last round)."""
    L = args.libraries
    workloads = [build_workload(n_reads=args.reads, seed=s) for s in range(L)]
    engines = [TorchAlignEngine(w[0], w[2], device=device, walk=args.walk)
               for w in workloads]
    refs = [w[1] for w in workloads]
    cfgs = [w[2] for w in workloads]
    # mixed workload: equal read share drawn from every library's features
    per = args.reads // L
    mat = np.concatenate([w[3][:per] for w in workloads])
    lens = np.concatenate([w[4][:per] for w in workloads])
    args = argparse.Namespace(**{**vars(args), "reads": len(mat)})
    multi = TorchMultiLibraryDispatcher(engines)

    n_chunks = max(1, args.reads // args.chunk)
    bounds = [
        (i * args.reads // n_chunks, (i + 1) * args.reads // n_chunks)
        for i in range(n_chunks)
    ]

    def run_once(fetcher, dispatcher):
        # fresh shared dedupe set per round (pipeline state, not index state)
        multi._seen = native.make_dedupe_set()
        counters = [FastCounter(engines[i], refs[i], cfgs[i]) for i in range(L)]
        pending = None

        def drain(p):
            pmat, plens, _, _, fut, pdd = p.result()
            if not pmat.shape[0]:
                return
            for counter, raw in zip(counters, fut.result()):
                counter._add_with_raw(pmat, plens, None, None, raw, None,
                                      prededuped=pdd)

        for lo, hi in bounds:
            # pipelined dispatch (dedupe + pack + upload on its own thread),
            # the FASTQ pipeline's _run_fast_loop discipline
            fut = dispatcher.submit(
                fastq_pipeline._dispatch_multi, multi, fetcher, mat[lo:hi],
                lens[lo:hi], None, None,
            )
            if pending is not None:
                drain(pending)
            pending = fut
        drain(pending)
        return [c.finalize() for c in counters]

    with ThreadPoolExecutor(max_workers=1) as fetcher, \
            ThreadPoolExecutor(max_workers=1) as dispatcher:
        run_once(fetcher, dispatcher)  # warm-up
        times = []
        for r in range(args.timed_rounds):
            t0 = time.time()
            results = run_once(fetcher, dispatcher)
            dt = time.time() - t0
            times.append(dt)
            log(f"multilib round {r}: {dt:.3f}s -> "
                f"{args.reads/dt:,.0f} reads/s across {L} libraries")
    best = min(times)
    rps = args.reads / best
    log(f"callsets per library: {[len(r) for r in results]}")
    return {
        "metric": f"fastq_multilib{L}_reads_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps * L / RUST_BASELINE_READS_PER_SEC, 2),
        "libraries": L,
        "engine": type(multi).__name__,
    }, results


def bench_fastq(args, log, engine, workload):
    """The default / ``--paired`` / ``--mesh`` loop over ``engine``;
    returns (row, the last round's counted results)."""
    _index, reference, cfg, mat, lens = workload
    mate_mat = mate_lens = None
    if args.paired:
        mate_mat, mate_lens = paired_mates(mat, lens)

    n_chunks = max(1, args.reads // args.chunk)
    chunk_bounds = [
        (i * args.reads // n_chunks, (i + 1) * args.reads // n_chunks)
        for i in range(n_chunks)
    ]

    # warm-up: absorbs the kernel builds and the first transfers, through
    # the same chunked pathway the timed rounds use
    t0 = time.time()
    warm_counter = FastCounter(engine, reference, cfg)
    for lo, hi in chunk_bounds:
        warm_counter.process(warm_counter.dispatch(
            mat[lo:hi], lens[lo:hi],
            mate_mat[lo:hi] if mate_mat is not None else None,
            mate_lens[lo:hi] if mate_lens is not None else None,
        ))
    warm = warm_counter.finalize()
    log(f"warmup: {time.time()-t0:.1f}s, callsets={len(warm)}")

    times = []
    splits = []
    for r in range(args.timed_rounds):
        t0 = time.time()
        t_dispatch = t_collect = t_host = 0.0
        # the pipeline's feed: chunk N's fetch runs on a background thread
        # while chunk N-1's host counting executes (FastCounter.dispatch)
        counter = FastCounter(engine, reference, cfg)
        pending: list = []

        def drain_one():
            nonlocal t_collect, t_host
            handle = pending.pop(0)
            ts = time.time()
            if not isinstance(handle, tuple):
                handle = handle.result()  # dispatch_async future
            raw1 = handle[4].result() if handle[4] is not None else None
            raw2 = handle[5].result() if handle[5] is not None else None
            if raw1 is not None and handle[8]:
                # stacked R1+R2 transaction: split rows back per mate
                raw1, raw2 = split_stacked(raw1, handle[0].shape[0])
            t_collect += time.time() - ts
            ts = time.time()
            if raw1 is not None:
                counter._add_with_raw(
                    handle[0], handle[1], handle[2], handle[3], raw1, raw2,
                    prededuped=handle[7],
                )
            t_host += time.time() - ts

        for lo, hi in chunk_bounds:
            ts = time.time()
            # dispatch_async pipelines dedupe+pack+upload on a dedicated
            # thread: the 3 stages (dispatch | device+fetch | count) overlap
            pending.append(counter.dispatch_async(
                mat[lo:hi], lens[lo:hi],
                mate_mat[lo:hi] if mate_mat is not None else None,
                mate_lens[lo:hi] if mate_lens is not None else None,
            ))
            t_dispatch += time.time() - ts
            if len(pending) >= args.depth:
                drain_one()
        while pending:
            drain_one()
        ts = time.time()
        results = counter.finalize()
        t_host += time.time() - ts
        dt = time.time() - t0
        times.append(dt)
        splits.append((t_dispatch, t_collect, t_host))
        log(f"round {r}: {dt:.3f}s -> {args.reads/dt:,.0f} reads/s "
            f"(dispatch {t_dispatch:.3f}s, device-wait {t_collect:.3f}s, "
            f"host {t_host:.3f}s)")

    best_i = min(range(len(times)), key=lambda i: times[i])
    best = times[best_i]
    reads_per_sec = args.reads / best
    total_counted = sum(entry[0] for _, entry in results)
    log(f"distinct callsets: {len(results)}, reads counted: {total_counted}")

    # device-resident companion metric: the kernel path's time per read,
    # apart from every transfer and host stage
    kernel_note = {}
    if not args.mesh:
        ns = measure_kernel_ns_per_read(engine, mat, lens, log)
        # traced last, so that no profiler session precedes the root
        # bench's measurement in this process
        device_ns = measure_kernel_device_ns_per_read(engine, mat, lens, log)
        kernel_note = {
            "kernel_ns_per_read": round(ns, 1),
            "kernel_device_ns_per_read": (
                None if device_ns is None else round(device_ns, 1))}

    t_dispatch, t_collect, t_host = splits[best_i]
    return {
        "metric": (
            ("fastq_mesh" if args.mesh else "fastq")
            + ("_paired" if args.paired else "")
            + "_align_count_reads_per_sec_per_chip"
        ),
        "value": round(reads_per_sec, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_sec / RUST_BASELINE_READS_PER_SEC, 2),
        # best-of-N, with the median carried alongside so a lucky or
        # unlucky round is visible in the record itself
        "median_value": round(args.reads / float(np.median(times)), 1),
        "timed_rounds": len(times),
        **_base_note,
        **kernel_note,
        "split_s": {
            "dispatch_pack_upload": round(t_dispatch, 3),
            "device_wait_and_fetch": round(t_collect, 3),
            "host_tail": round(t_host, 3),
        },
        **(
            {"features": args.features, "feat_len": args.feat_len}
            if (args.features, args.feat_len) != (50, 500) else {}
        ),
        "engine": type(engine).__name__,
    }, results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m nimble_tpu_torch.bench")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the engines (default cuda; "
                        "--multihost-cpu always runs on the CPU)")
    p.add_argument("--reads", type=int, default=1 << 19)
    p.add_argument("--chunk", type=int, default=1 << 17)
    # library scale knobs: the default mirrors nimble's KIR-style custom
    # libraries; --features 2000 --feat-len 1500 is a transcriptome-scale
    # stress (several million k-mers; the device table auto-sizes)
    p.add_argument("--features", type=int, default=50,
                   help="reference features in the synthetic library")
    p.add_argument("--feat-len", type=int, default=500,
                   help="length (bp) of each synthetic feature")
    p.add_argument("--timed-rounds", type=int, default=12)
    p.add_argument("--walk", choices=WALKS, default="fused",
                   help="walk kernel: the fused span walk (default) or the "
                        "double walk over precomputed masks")
    p.add_argument("--bam", action="store_true",
                   help="benchmark the threaded BAM pipeline instead")
    p.add_argument("--bam-groups", type=int, default=16384)
    p.add_argument("--bam-batch", type=int, default=16384,
                   help="records per BAM device batch")
    p.add_argument("--bam-cores", type=int, default=3,
                   help="num_cores for the BAM pipeline (cores-1 consumers)")
    p.add_argument("--mesh", action="store_true",
                   help="run the FASTQ bench through TorchMeshAlignEngine on "
                        "the torchrun ranks (a (1, 1) mesh without torchrun)")
    p.add_argument("--init-method", default=None,
                   help="torch.distributed init method of --mesh (default "
                        "env://, as torchrun sets it)")
    p.add_argument("--e2e", action="store_true",
                   help="from-disk end-to-end FASTQ bench (parse -> align "
                        "-> count -> TSV), comparable to the reference's "
                        "fastq path")
    p.add_argument("--paired", action="store_true",
                   help="paired-end FASTQ workload (R2 = revcomp fragments)")
    p.add_argument("--multihost-cpu", type=int, default=0,
                   help="N>0: measure N-process scaling efficiency on CPU "
                        "(disjoint pinned cores per simulated host)")
    p.add_argument("--libraries", type=int, default=0,
                   help="N>0: benchmark the N-library single-pass dispatcher")
    p.add_argument("--depth", type=int, default=3,
                   help="max chunks in flight (drain when this many pend)")
    p.add_argument("--launch-batch", type=int, default=8192,
                   help="reads per kernel launch of the default loop")
    p.add_argument("--verbose", action="store_true")
    return p


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def device_note(device: torch.device) -> dict:
    """The row's ``device``: the torch device and, on a card, its name and
    power limit."""
    if device.type != "cuda":
        return {"torch": str(device)}
    return {"torch": str(device), "card": nvidia_smi()}


def run(argv=None):
    """Parse ``argv`` and run its mode; returns (the JSON row, the mode's
    counted results: ``FastCounter.finalize()`` lists, or the output
    bytes).  A serving rank of ``--mesh`` returns (None, None)."""
    args = build_parser().parse_args(argv)

    def log(*a):
        if args.verbose:
            print(*a, file=sys.stderr)

    # --multihost-cpu is a host-only orchestration bench: its CLI children
    # run with --device cpu, and it never touches the card
    device = torch.device("cpu" if args.multihost_cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda was requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU")
    log("device:", device)
    note = {"walk": args.walk, "device": device_note(device)}

    if args.bam:
        row, results = bench_bam(args, log, device)
        return {**row, **_base_note, **note}, results
    if args.e2e:
        row, results = bench_e2e(args, log, device)
        return {**row, **_base_note, **note}, results
    if args.libraries:
        row, results = bench_multilib(args, log, device)
        return {**row, **_base_note, **note}, results
    if args.multihost_cpu:
        row, results = bench_multihost_cpu(args, log)
        return {**row, **note}, results
    workload = build_workload(
        n_features=args.features, feat_len=args.feat_len, n_reads=args.reads)
    index, _reference, cfg, _mat, _lens = workload
    if not args.mesh:
        engine = TorchAlignEngine(index, cfg, device=device, walk=args.walk,
                                  launch_batch=args.launch_batch)
        row, results = bench_fastq(args, log, engine, workload)
        return {**row, **note}, results
    runtime = init_runtime(device, init_method=args.init_method or "env://")
    ok = False
    try:
        # every rank builds the mesh and the engine, in the same order,
        # before the controller starts the loop
        mesh = Mesh(runtime, *mesh_shape(runtime.world_size))
        engine = TorchMeshAlignEngine(index, cfg, mesh=mesh, walk=args.walk)
        log(f"mesh: {mesh.shape} over {runtime.world_size} ranks")
        if not runtime.is_controller:
            runtime.serve()
            ok = True
            return None, None
        row, results = bench_fastq(args, log, engine, workload)
        ok = True
        return {**row, **note}, results
    finally:
        runtime.close(ok)


def main(argv=None) -> int:
    row, _results = run(argv)
    if row is not None:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
