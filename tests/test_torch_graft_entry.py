"""The port's driver entries (``nimble_tpu_torch.graft_entry``) and its
profiler hook, on the CPU.

``entry(device="cpu")``'s step on the tiny problem must give the JAX
engine's compact results on the same problem (each side builds its own
library and index).  ``dryrun_multichip`` runs the data x model mesh in
real gloo processes (8 ranks: a (4, 2) mesh; 2 ranks: (1, 2)), checks the
mesh's paired step and stacked 2-library pass against single-device
engines field for field on rank 0, and its rank processes load neither jax
nor ``nimble_tpu``.  ``profiler_trace`` does nothing without a directory
and writes a Chrome trace with one.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu_torch import graft_entry
from nimble_tpu_torch.models.aligner import entropy_pass_packed
from nimble_tpu_torch.ops.compact import unpack_compact
from nimble_tpu_torch.parallel.mesh import mesh_shape
from nimble_tpu_torch.utils.metrics import profiler_trace

from test_torch_host import _plain
from torch_sides import JAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_matches_jax_engine():
    fn, args = graft_entry.entry(device="cpu")
    (packed,) = args
    assert packed.device.type == "cpu" and packed.dtype == torch.uint8
    raw = fn(*args)
    assert raw.shape == (16, 2) and raw.dtype == torch.int32
    got = unpack_compact(raw.numpy())

    index, reads, lens = _jax_graft_entry()._tiny_problem()
    reads, lens = np.asarray(reads), np.asarray(lens)
    _pidx, preads, plens = graft_entry._tiny_problem()
    np.testing.assert_array_equal(preads, reads)
    np.testing.assert_array_equal(plens, lens)
    # the host's entropy gate, as compact_collect applies it
    ent_ok = entropy_pass_packed(packed.numpy(), 16, lens, 64 // 4)
    got["passed"] &= ent_ok
    got["needs_host"] &= ent_ok

    cfg = JAX.AlignFilterConfig(
        reference_genome_size=12, score_percent=0.25, score_threshold=40,
        num_mismatches=1, max_hits_to_report=10)
    want = DeviceAlignEngine(index, cfg).align_raw_compact_from_matrix(
        reads, lens)
    sel = want["passed"] | want["needs_host"]
    for key in ("passed", "needs_host"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("astart", "mask"):
        np.testing.assert_array_equal(got[key][sel], want[key][sel],
                                      err_msg=key)
    assert got["passed"].sum() == 16


def test_entry_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(2)


def test_paired_problem_matches_jax():
    want = _jax_graft_entry()._paired_problem(64, 6, 200, 11)
    got = graft_entry._paired_problem(64, 6, 200, 11)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert _plain(got[0]) == _plain(want[0])  # the k-mer index


def test_compare_compact_raises_on_divergence():
    class Engine:
        @staticmethod
        def decode_combo(astart, mask):
            return [astart, mask]

    ref = {"passed": np.array([True, False]),
           "needs_host": np.zeros(2, dtype=bool),
           "astart": np.array([5, 0]), "mask": np.array([3, 0])}
    graft_entry._compare_compact(dict(ref), ref, Engine, Engine, "same")
    for key, value in (("passed", np.array([True, True])),
                       ("needs_host", np.array([False, True])),
                       ("mask", np.array([1, 0]))):
        with pytest.raises(AssertionError, match="diverge"):
            graft_entry._compare_compact(dict(ref, **{key: value}), ref,
                                         Engine, Engine, "doctored")


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_on_gloo_processes(n):
    reports = graft_entry.dryrun_multichip(n, device="cpu", timeout=300)
    assert [r["rank"] for r in reports] == list(range(n))
    checks = reports[0]["checks"]
    assert checks["mesh"] == list(mesh_shape(n))
    assert checks["rows"] == 8192 and checks["passed"] > 0
    assert checks["multi_passed"][0] > 0
    for r in reports:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["leaked"] == [], r["leaked"][:5]


def test_dryrun_raises_when_a_rank_fails(monkeypatch):
    monkeypatch.setattr(sys, "executable", "/bin/false")
    with pytest.raises(RuntimeError, match="exited 1"):
        graft_entry.dryrun_multichip(2, device="cpu", timeout=60)


def test_graft_entry_main_runs_both_entries(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "nimble_tpu_torch.graft_entry", "--device",
         "cpu", "--ranks", "2"], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "entry ok: (16, 2)" in proc.stdout
    assert "dryrun_multichip ok on 2 ranks" in proc.stdout


def test_profiler_trace_without_a_directory_does_nothing(tmp_path):
    before = set(os.listdir(tmp_path))
    with profiler_trace(None):
        x = torch.arange(10).sum()
    assert int(x) == 45
    assert set(os.listdir(tmp_path)) == before
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiler_trace(str(log_dir)):
        torch.arange(1000).float().sum()
    trace = log_dir / "trace.json"
    assert trace.exists()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
