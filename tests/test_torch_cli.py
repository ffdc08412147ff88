"""The port's CLI: FASTQ counting on the CPU, refusals, and no jax.

Several libraries run in one pipeline call: the FASTQ input is parsed once,
whatever the number of libraries, and each library's TSV equals its
single-library run.  ``nimble_tpu_torch`` must never import jax nor the
JAX package (``nimble_tpu``): a subprocess imports the package, runs its
CPU slice end to end (FASTQ with one and two libraries, and the BAM branch
with one library in both walk modes and with two libraries), and checks
``sys.modules``.  The BAM
branch's own cases are in ``tests/test_torch_bam.py``.
"""

import gzip
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from nimble_tpu_torch.cli import main
from nimble_tpu_torch.pipeline import fastq_pipeline
from nimble_tpu_torch.workload import write_multi_bam_workload

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


@pytest.fixture
def parses(monkeypatch):
    """Counts the FASTQ parses (``iter_fastq_matrix_chunks`` calls) of the
    port's pipeline, by input file."""
    calls = []
    real = fastq_pipeline.iter_fastq_matrix_chunks

    def counting(path, *args, **kw):
        calls.append(os.path.basename(path))
        return real(path, *args, **kw)

    monkeypatch.setattr(fastq_pipeline, "iter_fastq_matrix_chunks", counting)
    return calls


def _single_library_tsv(tmp_path, lib, inputs, tag):
    out = str(tmp_path / f"single_{tag}.tsv")
    assert main(["-r", library_path(lib), *inputs, "-o", out, "-f", "none",
                 "--device", "cpu"]) == 0
    return open(out).read()


def test_cli_two_libraries_run_one_after_another(tmp_path, parses):
    """Two libraries over one FASTQ: the libraries no longer run one after
    another; one parse of the input serves both, and each TSV equals the
    library's single-library run."""
    libs = ["basic.json", "mismatch.json"]
    outs = [str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")]
    inputs = ["-i", reads_path("mismatch.fastq")]
    rc = main(["-r", library_path(libs[0]), "-r", library_path(libs[1]),
               *inputs, "-o", outs[0], "-o", outs[1], "-f", "none",
               "--device", "cpu"])
    assert rc == 0
    assert parses == ["mismatch.fastq"]
    for lib, out in zip(libs, outs):
        assert open(out).read() == _single_library_tsv(tmp_path, lib, inputs,
                                                       lib)
    assert len(open(outs[1]).read().splitlines()) > 1


def test_cli_three_libraries_paired_parse_each_file_once(tmp_path, parses):
    libs = ["basic.json", "basic-rev.json", "mismatch.json"]
    inputs = ["-i", reads_path("basic.fastq"), "-i", reads_path("basic.fastq")]
    outs = [str(tmp_path / f"o{i}.tsv") for i in range(3)]
    argv = [a for lib, out in zip(libs, outs)
            for a in ("-r", library_path(lib), "-o", out)]
    assert main([*argv, *inputs, "-f", "none", "--device", "cpu"]) == 0
    assert parses == ["basic.fastq", "basic.fastq"]
    for lib, out in zip(libs, outs):
        assert open(out).read() == _single_library_tsv(tmp_path, lib, inputs,
                                                       lib)


def test_cli_two_libraries_bam(tmp_path):
    """Two libraries over one BAM, one pipeline call: each forensic TSV
    equals the library's single-library run."""
    wl = write_multi_bam_workload(str(tmp_path / "wl"),
                                  libraries=[(4, 200), (3, 300)],
                                  n_groups=300, seed=5)
    outs = [str(tmp_path / f"m{i}.tsv.gz") for i in range(2)]
    rc = main(["-r", wl.libraries[0], "-r", wl.libraries[1], "-i",
               wl.inputs[0], "-o", outs[0], "-o", outs[1], "--device", "cpu",
               "-c", "3"])
    assert rc == 0
    for i, (lib, out) in enumerate(zip(wl.libraries, outs)):
        single = str(tmp_path / f"s{i}.tsv.gz")
        assert main(["-r", lib, "-i", wl.inputs[0], "-o", single,
                     "--device", "cpu", "-c", "3"]) == 0
        got = gzip.open(out).read()
        assert got == gzip.open(single).read()
        assert got.count(b"\n") > 100


def test_cli_cuda_without_cuda_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        main(["-r", library_path("basic.json"), "-i",
              reads_path("basic.fastq"), "-o", str(tmp_path / "o.tsv")])
    assert not (tmp_path / "o.tsv").exists()


@pytest.mark.parametrize("extra,match", [
    (["-i", "reads.bam", "-o", "o2.tsv.gz"], "number of output files"),
    (["-i", "reads.fastq", "--engine", "mesh"], "mesh is not yet ported"),
    (["-i", "reads.txt"], "Unsupported file format"),
    (["-i", "reads.fastq", "-t", "40:0.9,50:0.5"], "number of trim options"),
])
def test_cli_refusals(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        main(["-r", library_path("basic.json"), "-o", str(tmp_path / "o.tsv"),
              "--device", "cpu", *extra])


def test_cli_mesh_message_names_no_jax_module(tmp_path):
    """The mesh refusal sends no one to the JAX package's CLI."""
    with pytest.raises(SystemExit) as exc:
        main(["-r", library_path("basic.json"), "-i", "reads.fastq", "-o",
              str(tmp_path / "o.tsv"), "--device", "cpu", "--engine",
              "mesh"])
    msg = str(exc.value)
    assert "mesh is not yet ported" in msg
    assert "nimble_tpu." not in msg and "nimble_tpu " not in msg


def test_cli_bam_without_native_names_the_ports_source(tmp_path,
                                                       monkeypatch):
    """BAM input without the native host library exits, naming the C++
    source the port builds (not the JAX package's)."""
    from nimble_tpu_torch import cli

    monkeypatch.setattr(cli.native, "available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(["-r", library_path("basic.json"), "-i", "reads.bam", "-o",
              str(tmp_path / "o.tsv.gz"), "--device", "cpu"])
    msg = str(exc.value)
    assert "nimble_tpu_torch/csrc/nimble_host.cpp" in msg
    assert "native/nimble_host.cpp" not in msg.replace(
        "nimble_tpu_torch/csrc/", "")


def test_port_never_imports_jax(tmp_path):
    """The FASTQ run with one and two libraries, then the BAM branch in
    both walk modes and with two libraries, import neither jax nor the JAX
    package (``nimble_tpu``)."""
    out = str(tmp_path / "out.tsv")
    bam_out = str(tmp_path / "bam_")
    multi_out = str(tmp_path / "multi_")
    code = textwrap.dedent(f"""
        import sys
        import nimble_tpu_torch
        import nimble_tpu_torch.cli, nimble_tpu_torch.workload
        import nimble_tpu_torch.probe_gather
        from nimble_tpu_torch.ops import (
            _build, compact, device_tables, double_walk, full, gather,
            hashing, probe, span_walk)
        from nimble_tpu_torch.models import aligner, multi_aligner
        from nimble_tpu_torch.pipeline import bam_fast, fastq_pipeline
        def leaked():
            return sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "nimble_tpu"))
        assert not leaked(), "import pulled in " + repr(leaked()[:5])
        rc = nimble_tpu_torch.cli.main([
            "-r", {library_path("basic.json")!r},
            "-i", {reads_path("basic.fastq")!r},
            "-o", {out!r}, "-f", "none", "--device", "cpu"])
        assert rc == 0
        rc = nimble_tpu_torch.cli.main([
            "-r", {library_path("basic.json")!r},
            "-r", {library_path("mismatch.json")!r},
            "-i", {reads_path("basic.fastq")!r},
            "-o", {multi_out!r} + "a.tsv", "-o", {multi_out!r} + "b.tsv",
            "-f", "none", "--device", "cpu"])
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
        mwl = nimble_tpu_torch.workload.write_multi_bam_workload(
            {str(tmp_path / "mbam")!r}, libraries=[(4, 200), (3, 200)],
            n_groups=64, seed=2)
        rc = nimble_tpu_torch.cli.main([
            "-r", mwl.libraries[0], "-r", mwl.libraries[1],
            "-i", mwl.inputs[0], "-o", {multi_out!r} + "a.tsv.gz",
            "-o", {multi_out!r} + "b.tsv.gz", "--device", "cpu", "-c", "2"])
        assert rc == 0
        assert not leaked(), leaked()[:5]
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
    assert open(multi_out + "a.tsv").read().splitlines() == BASIC_LINES
    for name in ("a.tsv.gz", "b.tsv.gz"):
        assert gzip.open(multi_out + name).read().count(b"\n") > 20
