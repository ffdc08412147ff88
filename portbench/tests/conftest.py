"""Fixtures of the harness's own tests (``python -m pytest portbench/tests``).

Tests marked ``cuda`` need an NVIDIA card; they decide inside the
``cuda_device`` fixture, never at import, and skip elsewhere.  The
``tiny`` fixture puts small cells beside the real ones: the same
configurations and traffic mixes at a size a CPU test run holds.
"""

import copy
import json

import pytest

TINY = {
    "tiny_basic_fastq": {"config": "basic", "traffic": "ontarget",
                         "path": "fastq", "reads_per_pass": 2048},
    "tiny_basic_bam": {"config": "basic", "traffic": "tenx",
                       "path": "bam", "groups_per_pass": 96},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is False")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """Tiny cells in a temporary cells directory and BENCHMARK.json view;
    the run's work directory under ``tmp_path``."""
    from portbench import run, spec

    cells = tmp_path / "cells"
    cells.mkdir()
    for p in spec.CELLS.glob("*.json"):
        (cells / p.name).write_text(p.read_text())
    bench = copy.deepcopy(spec.benchmark())
    for name, cell in TINY.items():
        (cells / f"{name}.json").write_text(json.dumps(dict(name=name,
                                                            **cell)))
        bench["workloads"].append({"name": name, "config": cell["config"],
                                   "traffic": cell["traffic"], "chips": 1,
                                   "why": "test"})
        kind = "fastq" if cell["path"] == "fastq" else "bam"
        for group in ("end_to_end", "per_layer"):
            for m in bench[group]:
                if "workloads" in m and m["name"].startswith(
                        (kind, f"{kind}_")):
                    m["workloads"].append(name)
    monkeypatch.setattr(spec, "CELLS", cells)
    monkeypatch.setattr(spec, "benchmark", lambda: bench)
    monkeypatch.setattr(run, "WORK", tmp_path / "work")
    return bench
