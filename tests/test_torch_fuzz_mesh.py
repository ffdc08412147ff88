"""The port's fuzz campaigns' mesh trials on two gloo ranks of the CPU.

``torch_sides.MeshWorkers`` starts two rank processes with a (1, 2) mesh
(the table split over two model shards, so every launch runs on both
ranks).  Every rank runs the same campaign (``--mesh-only``: only the mesh
trials of the seeded schedule); rank 0 drives each trial while rank 1
serves it, and both must release each trial's mesh targets.  The campaign
holds every output to the host oracle (engine campaign) or to the slow
path's bytes (FASTQ campaign), so a passing run is exact equality.

This module runs in the mesh workers too (its ``job_*`` function): it
imports nothing of the JAX package.
"""

import importlib

import pytest

from torch_sides import MeshWorkers


def job_campaign(ctx, name, argv):
    """Every rank: the campaign ``name`` on the (1, 2) mesh.  Rank 1 runs
    it here, serving its mesh trials; rank 0's drive runs it and returns
    its summary and the mesh targets it left registered."""
    run = importlib.import_module(f"nimble_tpu_torch.fuzz.{name}").run
    mesh = ctx.meshes[(1, 2)]
    targets = ctx.runtime.targets

    def drive():
        before = sum(t is not None for t in targets)
        summary = run(argv, ctx.runtime, mesh)
        return summary, sum(t is not None for t in targets) - before

    if ctx.rank == 0:
        return drive
    left = drive()[1]
    if left:
        raise AssertionError(f"rank {ctx.rank} kept {left} mesh targets")
    return lambda: None


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    w = MeshWorkers(2, tmp_path_factory.mktemp("fuzz_mesh"), [(1, 2)])
    yield w
    w.close()


@pytest.mark.parametrize("name", ["differential", "fastq"])
def test_mesh_trials_on_two_ranks_agree(workers, name):
    summary, left = workers.run(__name__, "job_campaign", name=name, argv=[
        "--device", "cpu", "--walk", "both", "--mesh-only", "--trials", "2",
        "--seed", "0"])
    assert summary["trials"] == 2 and summary["items"] > 0
    assert left == 0
