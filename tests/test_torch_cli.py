"""The port's CLI: FASTQ counting on the CPU, refusals, and no jax.

``nimble_tpu_torch`` must never import jax: a subprocess imports the
package, runs its CPU slice end to end (FASTQ, and the BAM branch in both
walk modes), and checks ``sys.modules``.  The BAM branch's own cases are in
``tests/test_torch_bam.py``.
"""

import gzip
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from nimble_tpu_torch.cli import main

from conftest import library_path, reads_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASIC_LINES = [
    "feature\tscore",
    "A02-0\tA02-1\tA02-2\tA02-LC\t1",
    "A02-0\tA02-LC\t1",
    "A02-1\t1",
]


def test_cli_fastq_cpu(tmp_path, capsys):
    out = str(tmp_path / "out.tsv")
    rc = main(["-r", library_path("basic.json"), "-i", reads_path("basic.fastq"),
               "-o", out, "-f", "none", "--device", "cpu"])
    assert rc == 0
    assert open(out).read().splitlines() == BASIC_LINES
    assert "Alignment successful" in capsys.readouterr().out


def test_cli_two_libraries_run_one_after_another(tmp_path):
    outs = [str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")]
    rc = main(["-r", library_path("basic.json"), "-r",
               library_path("mismatch.json"), "-i", reads_path("mismatch.fastq"),
               "-o", outs[0], "-o", outs[1], "-f", "none", "--device", "cpu"])
    assert rc == 0
    single = str(tmp_path / "single.tsv")
    main(["-r", library_path("mismatch.json"), "-i",
          reads_path("mismatch.fastq"), "-o", single, "-f", "none",
          "--device", "cpu"])
    assert open(outs[1]).read() == open(single).read()
    assert open(outs[0]).read().splitlines()[0] == "feature\tscore"


def test_cli_cuda_without_cuda_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        main(["-r", library_path("basic.json"), "-i",
              reads_path("basic.fastq"), "-o", str(tmp_path / "o.tsv")])
    assert not (tmp_path / "o.tsv").exists()


@pytest.mark.parametrize("extra,match", [
    (["-i", "reads.bam", "-r", library_path("mismatch.json"), "-o",
      "o2.tsv.gz"], "BAM input with more than one library"),
    (["-i", "reads.fastq", "--engine", "mesh"], "mesh is not yet ported"),
    (["-i", "reads.txt"], "Unsupported file format"),
    (["-i", "reads.fastq", "-t", "40:0.9,50:0.5"], "number of trim options"),
])
def test_cli_refusals(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        main(["-r", library_path("basic.json"), "-o", str(tmp_path / "o.tsv"),
              "--device", "cpu", *extra])


def test_port_never_imports_jax(tmp_path):
    """The FASTQ run, then the BAM branch in both walk modes."""
    out = str(tmp_path / "out.tsv")
    bam_out = str(tmp_path / "bam_")
    code = textwrap.dedent(f"""
        import sys
        import nimble_tpu_torch
        import nimble_tpu_torch.cli, nimble_tpu_torch.workload
        from nimble_tpu_torch.ops import (
            _build, compact, device_tables, double_walk, full, hashing, probe,
            span_walk)
        from nimble_tpu_torch.models import aligner
        from nimble_tpu.pipeline import bam_fast
        assert "jax" not in sys.modules, "import pulled in jax"
        rc = nimble_tpu_torch.cli.main([
            "-r", {library_path("basic.json")!r},
            "-i", {reads_path("basic.fastq")!r},
            "-o", {out!r}, "-f", "none", "--device", "cpu"])
        assert rc == 0
        wl = nimble_tpu_torch.workload.write_bam_workload(
            {str(tmp_path / "bam")!r}, n_features=4, feat_len=200,
            n_groups=64, seed=2)
        for walk in ("fused", "double"):
            rc = nimble_tpu_torch.cli.main([
                "-r", wl.library, "-i", wl.inputs[0],
                "-o", {bam_out!r} + walk + ".tsv.gz", "--device", "cpu",
                "-c", "3", "--walk", walk])
            assert rc == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
        assert not leaked, leaked
        print("NO_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert open(out).read().splitlines() == BASIC_LINES
    runs = [gzip.open(bam_out + w + ".tsv.gz").read()
            for w in ("fused", "double")]
    assert runs[0] == runs[1] and runs[0].count(b"\n") > 100
