"""Driver entry points of the torch port (``__graft_entry__.py``'s pair).

* :func:`entry` — one compact align step of :class:`TorchAlignEngine` on a
  tiny problem, plus its example arguments, on a torch device.
* :func:`dryrun_multichip` — the data x model mesh over ``n`` ranks (one
  process each, started here), one full paired step and one 2-library
  stacked step, checked field for field against single-device engines.

Run both: ``python -m nimble_tpu_torch.graft_entry [--device cpu]
[--ranks N]`` (default: the card, two ranks sharing it when there is one).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_TIMEOUT_S = 900     # the whole dryrun; its ranks are killed after it
RANK_OP_TIMEOUT_S = 300    # one collective of a dryrun rank
FORBIDDEN = ("jax", "jaxlib", "nimble_tpu")


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return device


def _tiny_problem(n_reads: int = 16, l_max: int = 64):
    """Small synthetic library + reads (deterministic): 6 random 120 bp
    features from seed 7 and their reverse complements, and ``n_reads``
    48 bp fragments, as (index, (n_reads, l_max) int8 codes, lens)."""
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.utils.dna import encode_bases, revcomp

    rng = np.random.default_rng(7)
    feats = ["".join(rng.choice(list("ACGT"), size=120)) for _ in range(6)]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    index = build_index(doubled)

    reads = np.zeros((n_reads, l_max), dtype=np.int8)
    lens = np.zeros(n_reads, dtype=np.int32)
    for i in range(n_reads):
        src = feats[i % len(feats)]
        start = (i * 7) % (len(src) - 50)
        frag = encode_bases(src[start : start + 48])
        reads[i, : len(frag)] = frag
        lens[i] = len(frag)
    return index, reads, lens


def _paired_problem(n_pairs: int, n_feats: int, feat_len: int, seed: int):
    """Synthetic library + PAIRED reads spanning two length buckets.

    R1 fragments are 48 bp (bucket 64) for even pairs and 90 bp (bucket 96)
    for odd pairs; R2 is the reverse-complement of a nearby downstream
    fragment of the same feature (a proper mate)."""
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.utils.dna import encode_bases, revcomp

    rng = np.random.default_rng(seed)
    feats = ["".join(rng.choice(list("ACGT"), size=feat_len))
             for _ in range(n_feats)]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    index = build_index(doubled)

    l_max = 96
    r1 = np.zeros((n_pairs, l_max), dtype=np.int8)
    l1 = np.zeros(n_pairs, dtype=np.int32)
    r2 = np.zeros((n_pairs, l_max), dtype=np.int8)
    l2 = np.zeros(n_pairs, dtype=np.int32)
    for i in range(n_pairs):
        src = feats[i % n_feats]
        flen = 48 if i % 2 == 0 else 90
        start = (i * 13) % (feat_len - flen - 40)
        f1 = encode_bases(src[start : start + flen])
        m_start = start + 20
        f2 = encode_bases(revcomp(src[m_start : m_start + flen]))
        r1[i, : len(f1)] = f1
        l1[i] = len(f1)
        r2[i, : len(f2)] = f2
        l2[i] = len(f2)
    return index, r1, l1, r2, l2


def _config_a():
    """The filter settings of the tiny and the paired problem's library."""
    from nimble_tpu_torch.config import AlignFilterConfig

    return AlignFilterConfig(
        reference_genome_size=12, score_percent=0.25, score_threshold=40,
        num_mismatches=1, max_hits_to_report=10,
    )


def _config_b():
    from nimble_tpu_torch.config import AlignFilterConfig

    return AlignFilterConfig(
        reference_genome_size=10, score_percent=0.25, score_threshold=40,
        num_mismatches=0, max_hits_to_report=10,
    )


def _compare_compact(out, ref, eng_out, eng_ref, label: str) -> None:
    """Bit-compare two compact raw dicts (pass flags, host-rescue flags and
    decoded equivalence classes) produced by two engines; raises
    AssertionError at the first divergence."""
    if not (out["passed"] == ref["passed"]).all():
        raise AssertionError(f"{label}: pass flags diverge")
    if not (out["needs_host"] == ref["needs_host"]).all():
        raise AssertionError(f"{label}: needs_host diverges")
    for i in np.flatnonzero(ref["passed"]):
        eq_ref = eng_ref.decode_combo(int(ref["astart"][i]), int(ref["mask"][i]))
        eq_out = eng_out.decode_combo(int(out["astart"][i]), int(out["mask"][i]))
        if eq_ref != eq_out:
            raise AssertionError(f"{label}: eq class diverges at row {i}")


def entry(device="cuda"):
    """(fn, example_args): one compact align step on ``device``.

    ``fn(packed)`` is the launch :meth:`TorchAlignEngine.compact_dispatch`
    runs, ``ops.compact.probe_walk_filter`` (probe, walk kernel, filter),
    over the tiny problem's library; ``example_args`` holds its 16 reads of
    48 bp packed at their bucket (64), on ``device``.  It returns the (16,
    2) int32 compact results (``ops.compact.unpack_compact``).

    The JAX package's ``entry()`` runs ``engine_xla.probe_and_walk`` over
    the older flat ``DeviceIndex`` tables.  The port does not carry that
    path: the bucketed pass supersedes it, and the CLI runs the bucketed
    pass, so that is the step given here.
    """
    from nimble_tpu_torch.models.aligner import TorchAlignEngine, pack_reads

    device = _check_device(device)
    index, reads, lens = _tiny_problem()
    engine = TorchAlignEngine(index, _config_a(), device=device)
    bucket = engine.buckets[int(np.searchsorted(engine.buckets, lens.max()))]
    packed = torch.from_numpy(pack_reads(reads, lens, bucket)).to(device)
    return engine._device_pass(bucket, full=False), (packed,)


def _dryrun_checks(eng, eng_b, device) -> dict:
    """The controller's two checks (the JAX dryrun's): the paired
    two-bucket step on the mesh against a single-device engine, and the
    2-library stacked pass on the mesh against each library's own
    engine."""
    from nimble_tpu_torch.core.fast_count import stack_pair
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.models.mesh_aligner import stacked_dispatcher

    _index, r1, l1, r2, l2 = _paired_problem(
        n_pairs=4096, n_feats=6, feat_len=200, seed=11)
    # R1+R2 ride ONE stacked launch buffer (the production paired path);
    # launch_batch=1024 rows a data row splits each bucket over several
    # launches
    smat, slens = stack_pair(r1, l1, r2, l2)
    out = eng.align_raw_compact_from_matrix(smat, slens)
    if out["passed"].sum() == 0:
        raise AssertionError("dryrun produced no alignments")
    single = TorchAlignEngine(eng.index, eng.config, device=device,
                              launch_batch=1024)
    ref = single.align_raw_compact_from_matrix(smat, slens)
    _compare_compact(out, ref, eng, single, "mesh paired")

    singles = [TorchAlignEngine(e.index, e.config, device=device,
                                launch_batch=1024) for e in (eng, eng_b)]
    multi = stacked_dispatcher([eng, eng_b])
    per_lib = multi.collect(multi.dispatch(r1, l1))
    for li, (e, got) in enumerate(zip(singles, per_lib)):
        want = e.align_raw_compact_from_matrix(r1, l1)
        _compare_compact(got, want, e, e, f"multi-library lib{li}")
    if per_lib[0]["passed"].sum() == 0:
        raise AssertionError("library A matched nothing")
    return {"mesh": list(eng.mesh.shape), "rows": int(smat.shape[0]),
            "passed": int(out["passed"].sum()),
            "multi_passed": [int(p["passed"].sum()) for p in per_lib]}


def _dryrun_rank(work: str, device: str) -> int:
    """One rank of :func:`dryrun_multichip`: every rank builds the same
    mesh engines in the same order; rank 0 runs the checks while the others
    serve its launches.  Writes ``work/rank<r>.json``: the checks' summary
    (rank 0), the walk kernels' launches in the run and the FORBIDDEN
    modules this process loaded."""
    from nimble_tpu_torch.models.mesh_aligner import TorchMeshAlignEngine
    from nimble_tpu_torch.ops.double_walk import double_walk
    from nimble_tpu_torch.ops.span_walk import fused_span_walk
    from nimble_tpu_torch.parallel.mesh import Mesh, init_runtime, mesh_shape

    if device == "cpu":
        torch.set_num_threads(1)
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    timeout = datetime.timedelta(seconds=RANK_OP_TIMEOUT_S)
    rt = init_runtime(device, init_method=f"file://{work}/init",
                      op_timeout=timeout,
                      idle_timeout=datetime.timedelta(
                          seconds=DRYRUN_TIMEOUT_S))
    report = {"rank": rank, "device": str(rt.device), "backend": rt.backend}
    ok = False
    try:
        mesh = Mesh(rt, *mesh_shape(n))
        index_a = _paired_problem(n_pairs=1, n_feats=6, feat_len=200,
                                  seed=11)[0]
        index_b = _paired_problem(n_pairs=1, n_feats=5, feat_len=180,
                                  seed=23)[0]
        eng = TorchMeshAlignEngine(index_a, _config_a(), mesh=mesh,
                                   launch_batch=1024)
        eng_b = TorchMeshAlignEngine(index_b, _config_b(), mesh=mesh,
                                     launch_batch=1024)
        fused_span_walk.launches = double_walk.launches = 0
        if rt.is_controller:
            report["checks"] = _dryrun_checks(eng, eng_b, rt.device)
        else:
            rt.serve()
        ok = True
    finally:
        rt.close(ok)
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    report["launches"] = {"fused_span_walk": fused_span_walk.launches,
                          "double_walk": double_walk.launches}
    report["leaked"] = sorted(m for m in sys.modules
                              if m.split(".")[0] in FORBIDDEN)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def dryrun_multichip(n_devices: int, device="cuda", *,
                     timeout: float = DRYRUN_TIMEOUT_S) -> list:
    """Full sharded align-step dryrun on an ``n_devices``-rank (data,
    model) mesh (``parallel.mesh.mesh_shape``), verified bit-exactly
    against the single-device engine:

    * 4096 PAIRED reads (8192 stacked rows) spanning TWO length buckets
      (48 bp -> bucket 64, 90 bp -> bucket 96) through
      ``TorchMeshAlignEngine`` with 1,024 reads a data row per launch
      (several launches per bucket);
    * the 2-library STACKED pass on the same mesh over the R1 reads, each
      library's compact results against that library's own single-device
      engine.

    Starts one process per rank (``file://`` rendezvous in a temporary
    directory; on ``cuda`` local rank r takes card r % cards, gloo when
    ranks share a card) and waits at most ``timeout`` seconds.  A
    divergence, any rank's non-zero exit or the deadline raises
    RuntimeError, after every rank is stopped.  Returns the ranks'
    reports (see :func:`_dryrun_rank`).

    The JAX dryrun also forces padding to one executable shape per launch
    (``pad_launches=True``); that answers a TPU compile cost and is not
    ported (ROADMAP, "Deliberately not ported").
    """
    if n_devices < 1:
        raise ValueError(f"a dryrun needs at least one rank, got {n_devices}")
    device = _check_device(device).type
    with tempfile.TemporaryDirectory(prefix="nimble_dryrun_") as work:
        procs, logs = [], []
        try:
            for rank in range(n_devices):
                env = dict(os.environ, RANK=str(rank),
                           WORLD_SIZE=str(n_devices), LOCAL_RANK=str(rank),
                           LOCAL_WORLD_SIZE=str(n_devices),
                           PYTHONPATH=os.pathsep.join(
                               [_ROOT, os.environ.get("PYTHONPATH", "")]))
                if device == "cpu":
                    env["OMP_NUM_THREADS"] = "1"
                logs.append(open(os.path.join(work, f"rank{rank}.log"), "w"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "nimble_tpu_torch.graft_entry",
                     "--dryrun-rank", work, "--device", device],
                    cwd=_ROOT, env=env, stdout=logs[-1],
                    stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            # a failed rank leaves the others waiting in a collective: stop
            # at the first non-zero exit
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(work, f"rank{rank}.log")) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"dryrun rank {rank} of {n_devices} "
                                   f"exited {p.returncode}:\n{tail}")
        reports = []
        for rank in range(n_devices):
            with open(os.path.join(work, f"rank{rank}.json")) as f:
                reports.append(json.load(f))
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=2,
                    help="ranks of the dryrun's mesh (default 2)")
    ap.add_argument("--dryrun-rank", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_rank:
        return _dryrun_rank(args.dryrun_rank, args.device)
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print(f"entry ok: {tuple(out.shape)} {out.dtype} on {out.device}")
    reports = dryrun_multichip(args.ranks, args.device)
    print(f"dryrun_multichip ok on {args.ranks} ranks: {reports[0]['checks']}"
          f"; walk launches per rank "
          f"{[r['launches']['fused_span_walk'] for r in reports]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
