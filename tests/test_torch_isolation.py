"""The port stands alone: no jax and no ``nimble_tpu`` in its imports.

``nimble_tpu_torch`` keeps its own copy of every host module it runs, and
``chip_smoke.py`` (the run on the card) builds its oracles from those
copies.  A subprocess imports every module of the package and
``chip_smoke.py``, then checks ``sys.modules``; the import statements of the
same files are checked in their syntax trees.  The mesh's processes
(``parallel/*``, ``models/mesh_aligner.py``) are checked too: two gloo
ranks run a mesh launch, then report their ``sys.modules``; so are the
two host processes of a multi-host CLI run (``parallel/multihost.py``) and
the rank processes of ``graft_entry.dryrun_multichip``.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from torch_sides import MeshWorkers

REPO = pathlib.Path(__file__).resolve().parent.parent
MESH_MODULES = ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/sharded_fast.py", "parallel/sharded_index.py",
                "models/mesh_aligner.py", "parallel/multihost.py",
                "graft_entry.py")
FORBIDDEN = ("jax", "jaxlib", "nimble_tpu")


def _port_files():
    return sorted((REPO / "nimble_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_importing_the_port_loads_neither_jax_nor_nimble_tpu():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        import nimble_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            nimble_tpu_torch.__path__, "nimble_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {str(REPO / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in {FORBIDDEN!r})
        assert not bad, bad[:10]
        print("IMPORTED", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split("IMPORTED")[1]) > 30


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_statement_names_jax_or_nimble_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        bad = [r for r in roots if r in FORBIDDEN]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_the_mesh_modules_are_checked():
    files = {str(p.relative_to(REPO / "nimble_tpu_torch"))
             for p in _port_files()[:-1]}
    assert set(MESH_MODULES) <= files


def job_mesh_launch(ctx):
    """A (1, 2) mesh engine on the basic library: one compact launch."""
    import numpy as np

    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.mesh_aligner import TorchMeshAlignEngine

    data = REPO / "tests" / "data"
    cfg, ref = load_reference_library(str(data / "libraries" / "basic.json"),
                                      LibraryChemistry.NONE)
    engine = TorchMeshAlignEngine(
        build_index(get_reference_sequence_data(ref)[0]), cfg,
        mesh=ctx.meshes[(1, 2)])
    mat = np.zeros((4, 128), dtype=np.int8)
    lens = np.full(4, 100, dtype=np.int32)
    return lambda: int(engine.align_raw_compact_from_matrix(
        mat, lens)["passed"].sum())


def job_forbidden_modules(ctx):
    """Every rank's modules of FORBIDDEN packages, gathered to rank 0."""
    import torch.distributed as dist

    mods = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    got = [None] * ctx.runtime.world_size if ctx.rank == 0 else None
    dist.gather_object(mods, got, dst=0, group=ctx.runtime.control)
    return lambda: got


def test_mesh_processes_load_neither_jax_nor_nimble_tpu(tmp_path):
    workers = MeshWorkers(2, tmp_path, [(1, 2)])
    try:
        assert workers.run(__name__, "job_mesh_launch") == 0
        assert workers.run(__name__, "job_forbidden_modules") == [[], []]
    finally:
        workers.close()


_MULTIHOST_HOST = textwrap.dedent("""
    import sys
    from nimble_tpu_torch import cli
    rc = cli.main(sys.argv[1:])
    bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
    print("FORBIDDEN", bad)
    sys.exit(rc)
""").format(forbidden=FORBIDDEN)


def test_multihost_processes_load_neither_jax_nor_nimble_tpu(tmp_path):
    """Two host processes of the CLI's multi-host mode, end to end on the
    basic fixture."""
    data = REPO / "tests" / "data"
    out = tmp_path / "o.tsv"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIHOST_HOST, "-r",
         str(data / "libraries" / "basic.json"), "-i",
         str(data / "reads" / "basic.fastq"), "-o", str(out), "-f", "none",
         "--device", "cpu", "--num-processes", "2", "--process-id", str(r),
         "--init-method", f"file://{tmp_path / 'init'}"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-3000:]
        assert "(multi-host)" in stdout and "FORBIDDEN []" in stdout
    assert out.read_text().startswith("feature\tscore\n")


def test_dryrun_ranks_load_neither_jax_nor_nimble_tpu():
    from nimble_tpu_torch.graft_entry import dryrun_multichip

    reports = dryrun_multichip(2, device="cpu", timeout=300)
    assert [r["leaked"] for r in reports] == [[], []]
