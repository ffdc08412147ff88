"""A run on the CPU (the look for a card skipped): its last line, its
check against the port, its traced metrics, and its refusals."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import run, spec

BENCH = spec.benchmark()


def _run(capsys, *argv):
    rc = run.main(list(argv), device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("cell", ["tiny_basic_fastq", "tiny_basic_bam"])
def test_the_reference_equals_the_ports_cpu_run(tiny, capsys, cell):
    rc, line = _run(capsys, "--workload", cell, "--seed", str(2**31 + 17),
                    "--seconds", "0.5", "--trace", "0")
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    rate = "fastq_reads_per_s" if "fastq" in cell else "bam_records_per_s"
    assert set(line["metrics"]) == {rate, "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert all(c["value"] == 0 == c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", ["tiny_basic_fastq", "tiny_basic_bam"])
def test_a_traced_run_reports_per_layer_metrics(tiny, capsys, cell):
    rc, line = _run(capsys, "--workload", cell, "--seed", "99",
                    "--seconds", "0.01", "--trace", "1")
    assert rc == 0 and line["correct"] is True
    dev = line["device"]
    assert dev["window_s"] > 0 and "busy_s" in dev
    kind = "fastq" if "fastq" in cell else "bam"
    timers = {m["name"] for m in BENCH["per_layer"]
              if m["name"].startswith(kind) and m["source"] ==
              "program_span"}
    assert timers <= set(line["metrics"])
    # no device on the CPU: the device readers find nothing to read
    assert not any(n.endswith(("idle_pct", "roofline", "ns_per_read",
                               "ns_per_rec")) for n in line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert list(line)[-1] == "checks"


def test_without_a_card_it_exits_nonzero_and_prints_nothing(capsys,
                                                             monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "basic_fastq_ontarget", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_alone_in_a_directory_it_exits_nonzero(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, *BENCH["command"], "--workload",
         "basic_fastq_ontarget", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_a_loaded_jax_package_refuses_the_result(tiny, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "nimble_tpu", object())
    rc = run.main(["--workload", "tiny_basic_fastq", "--seed", "3",
                   "--seconds", "0.01"], device="cpu")
    assert rc != 0
    assert capsys.readouterr().out == ""
    assert run.forbidden_modules() == ["nimble_tpu"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_device, tiny, capsys):
    rc = run.main(["--workload", "tiny_basic_fastq", "--seed", "5",
                   "--seconds", "1", "--trace", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
    assert 0 < line["metrics"]["fastq.probe_walk_filter_roofline"]["value"] \
        <= 100
