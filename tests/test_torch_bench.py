"""The port's bench entry (``nimble_tpu_torch.bench``) against the JAX
package's (the root ``bench.py``), on the CPU at small sizes.

- ``build_workload`` and the ``--paired`` mates give the root bench's arrays
  byte for byte (the library rows and names, the config, the reads).
- Every mode prints exactly one JSON line through ``main``, under the root
  bench's metric name with its keys, plus ``engine``, ``walk`` and
  ``device``; what each timed run counted equals the JAX package's result
  on the same inputs: the default, ``--paired`` and ``--mesh`` loops the
  JAX ``FastCounter`` over ``DeviceAlignEngine``, ``--libraries 2`` the JAX
  ``MultiLibraryDispatcher``, ``--e2e`` the JAX ``fastq_pipeline.process``
  TSV and ``--bam`` the JAX ``process_fast`` forensic bytes.
  ``--multihost-cpu 2`` passes its own check that the two-process TSV
  equals the single-process one.
- ``--device cuda`` on a machine with no card exits non-zero and prints no
  rate.

The JAX engines are built once per module.
"""

import dataclasses
import enum
import gzip
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nimble_tpu_torch import bench
from nimble_tpu_torch import native as port_native
from nimble_tpu_torch.workload import write_fastq

from test_torch_bam import ensure_native_libraries
from torch_sides import JAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--reads", "4096", "--chunk", "1024",
         "--timed-rounds", "1"]
# the root bench's row keys per mode (bench.py:186-189, 259-262, 395-400,
# 480-485, 739-762, with _base_note where it adds it)
BASE = {"metric", "value", "unit", "vs_baseline"}
LOOP = BASE | {"median_value", "timed_rounds", "baseline_range_reads_per_sec",
               "split_s"}
JAX_KEYS = {
    "default": LOOP | {"kernel_ns_per_read"},
    "mesh": LOOP,
    "bam": BASE | {"baseline_range_reads_per_sec"},
    "e2e": BASE | {"baseline_range_reads_per_sec"},
    "libraries": BASE | {"baseline_range_reads_per_sec", "libraries"},
    "multihost": BASE | {"t_single_s", "t_multi_s"},
}
PORT_KEYS = {"engine", "walk", "device"}


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_bench = _jax_bench()


def jax_mates(mat, lens):
    """The root bench's R2 mates, as bench.py:618-625 computes them."""
    W = mat.shape[1]
    ar = np.arange(W)[None, :]
    ridx = np.clip(lens[:, None] - 1 - ar, 0, W - 1)
    om = np.take_along_axis(mat, ridx, axis=1)
    return np.where(ar < lens[:, None], 3 - om, 0).astype(np.int8), lens.copy()


def _plain(value):
    return value.name if isinstance(value, enum.Enum) else value


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_features,feat_len", [(50, 500), (7, 200)])
def test_build_workload_is_the_root_benchs(seed, n_features, feat_len):
    want = jax_bench.build_workload(n_features=n_features, feat_len=feat_len,
                                    n_reads=2048, seed=seed)
    got = bench.build_workload(n_features=n_features, feat_len=feat_len,
                               n_reads=2048, seed=seed)
    j_index, j_ref, j_cfg, j_mat, j_lens = want
    p_index, p_ref, p_cfg, p_mat, p_lens = got
    assert p_mat.dtype == j_mat.dtype and p_mat.tobytes() == j_mat.tobytes()
    assert p_lens.dtype == j_lens.dtype and p_lens.tobytes() == j_lens.tobytes()
    assert p_ref.columns == j_ref.columns and p_ref.headers == j_ref.headers
    assert ((p_ref.group_on, p_ref.sequence_name_idx, p_ref.sequence_idx)
            == (j_ref.group_on, j_ref.sequence_name_idx, j_ref.sequence_idx))
    assert ({f.name: _plain(getattr(p_cfg, f.name))
             for f in dataclasses.fields(p_cfg)}
            == {f.name: _plain(getattr(j_cfg, f.name))
                for f in dataclasses.fields(j_cfg)})
    for name in ("keys_sorted", "post_starts", "postings_rows",
                 "postings_offs", "row_lengths"):
        assert np.array_equal(getattr(p_index, name), getattr(j_index, name))
    p_mates, p_mlens = bench.paired_mates(p_mat, p_lens)
    j_mates, j_mlens = jax_mates(j_mat, j_lens)
    assert p_mates.dtype == np.int8 and p_mates.tobytes() == j_mates.tobytes()
    assert p_mlens.tobytes() == j_mlens.tobytes()


def _main(monkeypatch, capsys, argv):
    """``bench.main(argv)``: the one JSON line it prints, and the counted
    results of the run it made."""
    ran = []
    real = bench.run

    def spy(args):
        ran.append(real(args))
        return ran[-1]

    monkeypatch.setattr(bench, "run", spy)
    capsys.readouterr()
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    row = json.loads(lines[0])
    assert row == ran[0][0]
    return row, ran[0][1]


def _keys(row, mode, *extra):
    assert set(row) == JAX_KEYS[mode] | PORT_KEYS | set(extra)
    assert row["device"] == {"torch": "cpu"}
    assert row["value"] > 0


@pytest.fixture(scope="module")
def jax_fastq():
    """The JAX FastCounter over DeviceAlignEngine (launch_batch 512) on the
    root bench's 4096 reads, single-end and paired."""
    from nimble_tpu.core.fast_count import fast_count_calls_matrix
    from nimble_tpu.models.aligner import DeviceAlignEngine

    index, ref, cfg, mat, lens = jax_bench.build_workload(n_reads=4096)
    engine = DeviceAlignEngine(index, cfg, launch_batch=512)
    mates = jax_mates(mat, lens)
    return {"single": fast_count_calls_matrix(mat, lens, None, None, engine,
                                              ref, cfg),
            "paired": fast_count_calls_matrix(mat, lens, *mates, engine, ref,
                                              cfg)}


@pytest.mark.parametrize("walk", ["fused", "double"])
@pytest.mark.parametrize("mode", ["default", "paired", "mesh"])
def test_fastq_loop_counts_what_jax_counts(monkeypatch, capsys, jax_fastq,
                                           mode, walk):
    extra = {"default": [], "paired": ["--paired"], "mesh": ["--mesh"]}[mode]
    row, results = _main(monkeypatch, capsys, SMALL + [
        "--launch-batch", "512", "--walk", walk, *extra])
    if mode == "mesh":
        _keys(row, "mesh")
    else:
        # the port's companion of kernel_ns_per_read: the pass's device
        # time, which the CPU has not
        _keys(row, "default", "kernel_device_ns_per_read")
        assert row["kernel_device_ns_per_read"] is None
    assert row["metric"] == {
        "default": "fastq_align_count_reads_per_sec_per_chip",
        "paired": "fastq_paired_align_count_reads_per_sec_per_chip",
        "mesh": "fastq_mesh_align_count_reads_per_sec_per_chip"}[mode]
    assert row["walk"] == walk and row["timed_rounds"] == 1
    assert row["engine"] == ("TorchMeshAlignEngine" if mode == "mesh"
                             else "TorchAlignEngine")
    assert set(row["split_s"]) == {"dispatch_pack_upload",
                                   "device_wait_and_fetch", "host_tail"}
    want = jax_fastq["paired" if mode == "paired" else "single"]
    assert results == want and len(results) > 20


def _jax_multilib(n_libraries, reads, chunk):
    """bench.py:415-465's counting with the JAX package, one chunk after
    another: each library's FastCounter results."""
    from nimble_tpu import native
    from nimble_tpu.core.fast_count import FastCounter
    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.models.multi_aligner import MultiLibraryDispatcher
    from nimble_tpu.pipeline.fastq_pipeline import _dispatch_multi

    workloads = [jax_bench.build_workload(n_reads=reads, seed=s)
                 for s in range(n_libraries)]
    engines = [DeviceAlignEngine(w[0], w[2]) for w in workloads]
    per = reads // n_libraries
    mat = np.concatenate([w[3][:per] for w in workloads])
    lens = np.concatenate([w[4][:per] for w in workloads])
    multi = MultiLibraryDispatcher(engines)
    multi._seen = native.make_dedupe_set()
    counters = [FastCounter(e, w[1], w[2]) for e, w in zip(engines, workloads)]
    n_chunks = max(1, len(mat) // chunk)
    for i in range(n_chunks):
        lo, hi = i * len(mat) // n_chunks, (i + 1) * len(mat) // n_chunks
        pmat, plens, _, _, fut, pdd = _dispatch_multi(
            multi, None, mat[lo:hi], lens[lo:hi], None, None)
        if pmat.shape[0]:
            for counter, raw in zip(counters, fut.result()):
                counter._add_with_raw(pmat, plens, None, None, raw, None,
                                      prededuped=pdd)
    return [c.finalize() for c in counters]


def test_libraries_count_what_the_jax_dispatcher_counts(monkeypatch, capsys):
    row, results = _main(monkeypatch, capsys, SMALL + ["--libraries", "2"])
    _keys(row, "libraries")
    assert row["metric"] == "fastq_multilib2_reads_per_sec_per_chip"
    assert row["libraries"] == 2
    assert row["engine"] == "TorchMultiLibraryDispatcher"
    want = _jax_multilib(2, 4096, 1024)
    assert results == want and min(len(r) for r in results) > 10


def test_e2e_writes_the_jax_pipelines_tsv(monkeypatch, capsys, tmp_path):
    from nimble_tpu.models.aligner import DeviceAlignEngine

    row, tsv = _main(monkeypatch, capsys, SMALL + ["--e2e"])
    _keys(row, "e2e")
    assert row["metric"] == "fastq_e2e_from_disk_reads_per_sec_per_chip"
    index, ref, cfg, mat, _lens = jax_bench.build_workload(n_reads=4096)
    fq, out = tmp_path / "r.fastq", tmp_path / "jax.tsv"
    write_fastq(str(fq), mat)
    JAX.fastq_pipeline.process([str(fq)], [DeviceAlignEngine(index, cfg)],
                               [ref], [cfg], [str(out)], chunk_reads=1024)
    assert tsv == out.read_bytes() and tsv.count(b"\n") > 20


@pytest.fixture(scope="module")
def jax_bam(tmp_path_factory):
    """The JAX process_fast's forensic bytes on the root bench's BAM of 64
    groups (bench.py:141-172)."""
    from nimble_tpu.io.synth import make_synthetic_bam
    from nimble_tpu.models.aligner import DeviceAlignEngine

    ensure_native_libraries()
    index, ref, cfg, _, _ = jax_bench.build_workload(n_reads=1)
    d = tmp_path_factory.mktemp("jax_bam")
    bam, out = str(d / "bench.bam"), str(d / "out.tsv.gz")
    make_synthetic_bam(bam, ref.columns[1][0::2], n_groups=64,
                       pairs_per_group=4, read_len=90, seed=1, mutate_every=5)
    JAX.bam_fast.process_fast([bam], [DeviceAlignEngine(index, cfg)], [ref],
                              [cfg], [out], 3, False, batch_records=16384)
    with gzip.open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("pipeline", ["fast", "slow"])
def test_bam_writes_the_jax_forensic_bytes(monkeypatch, capsys, jax_bam,
                                           pipeline):
    """The fast pipeline, and the slow one the bench runs when the native
    host library is missing (one consumer, so its rows keep their order)."""
    argv = ["--device", "cpu", "--bam", "--bam-groups", "64"]
    if pipeline == "slow":
        monkeypatch.setattr(port_native, "available", lambda: False)
        argv += ["--bam-cores", "2"]
    row, forensic = _main(monkeypatch, capsys, argv)
    _keys(row, "bam", "pipeline")
    assert row["metric"] == "bam_pipeline_records_per_sec_per_chip"
    assert row["pipeline"] == pipeline
    assert forensic == jax_bam and forensic.count(b"\n") > 64


def test_multihost_cpu_passes_its_equality_check(monkeypatch, capsys):
    if shutil.which("taskset") is None:
        pytest.skip("taskset is not installed")
    row, tsv = _main(monkeypatch, capsys, ["--multihost-cpu", "2",
                                           "--reads", "3000"])
    _keys(row, "multihost")
    assert row["metric"] == "fastq_multihost2_overhead_efficiency"
    assert tsv.startswith(b"feature\tscore\n") and tsv.count(b"\n") > 20


def test_mesh_under_torchrun_prints_on_the_controller_only(tmp_path):
    """``--mesh`` as two gloo ranks (a (1, 2) mesh): every rank builds the
    engine, rank 0 runs the loop and prints the one row, rank 1 serves."""
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nimble_tpu_torch.bench", "--device",
             "cpu", "--mesh", "--reads", "2048", "--chunk", "1024",
             "--timed-rounds", "1", "--init-method",
             f"file://{tmp_path / 'init'}"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and outs[1][0] == ""
    row = json.loads(lines[0])
    assert row["metric"] == "fastq_mesh_align_count_reads_per_sec_per_chip"
    assert row["engine"] == "TorchMeshAlignEngine" and row["value"] > 0


def test_cuda_without_a_card_exits_and_prints_no_rate(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--bam"], ["--e2e"], ["--libraries", "2"], ["--mesh"]):
        with pytest.raises(SystemExit) as err:
            bench.main(argv)
        assert err.value.code not in (0, None)
        assert "--device cuda" in str(err.value.code)
        assert capsys.readouterr().out == ""


def test_module_run_without_a_card_fails_with_no_output():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "nimble_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


class _Recorder:
    """A stand-in engine whose compact pass records the buffers it gets."""

    device = torch.device("cpu")
    buckets = (64, 92, 96)
    launch_batch = 64

    def __init__(self):
        self.calls = []

    def _device_pass(self, bucket, full):
        assert (bucket, full) == (92, False)
        return lambda x: self.calls.append(x)


def test_kernel_ns_per_read_times_launches_of_two_resident_buffers():
    """One warm-up, then per round N alternating launches and one more, all
    on two uploaded buffers of equal values (a short batch padded with zero
    rows to launch_batch)."""
    engine = _Recorder()
    mat = np.ones((40, 90), dtype=np.int8)
    lens = np.full(40, 90, dtype=np.int32)
    ns = bench.measure_kernel_ns_per_read(engine, mat, lens, lambda *a: None,
                                          n_launches=4)
    assert ns >= 0
    calls = engine.calls
    assert len(calls) == 1 + 3 * (4 + 1)
    x1, x2 = calls[1], calls[2]
    assert x1 is not x2 and torch.equal(x1, x2)
    assert x1.shape == (64, 25) and not x1[40:].any() and x1[:40].any()
    for rnd in range(3):
        got = calls[1 + 5 * rnd: 1 + 5 * (rnd + 1)]
        assert [c is x1 for c in got] == [True, False, True, False, True]
