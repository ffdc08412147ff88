"""The port's fuzz campaigns (``nimble_tpu_torch.fuzz``) on the CPU.

Short seeded blocks of each entry with both walks must end with the JAX
scripts' ``DONE: ... zero divergences`` line (the repeat-rate campaign
with its own); the planted-collision block must flag every forged read
``needs_host`` and must catch a probe that does not; an injected
divergence must exit non-zero with a reproducer whose child seed fails
again; ``--device cuda`` without a card must exit non-zero with a message;
and the colored-DBG oracle the port carries must be the tests' own.  Every
compared output is an integer or bytes: the tolerance is equality.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from nimble_tpu_torch.fuzz import differential
from nimble_tpu_torch.fuzz.campaign import Campaign, Divergence
from nimble_tpu_torch.ops import probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--walk", "both"]
ENTRIES = ("differential", "fastq", "bam")


def _run(capsys, name, argv):
    from importlib import import_module

    summary = import_module(f"nimble_tpu_torch.fuzz.{name}").run(argv)
    return summary, capsys.readouterr().out


@pytest.mark.parametrize("name, argv, done", [
    ("differential", ["--trials", "16", "--seed", "0"],
     "DONE: 16 trials, "),
    ("fastq", ["--trials", "12", "--seed", "0"], "DONE: 12 trials, "),
    ("bam", ["--trials", "8", "--seed", "0"], "DONE: 8 trials, "),
    ("differential", ["--repeat-rate", "--trials", "10", "--seed", "0"],
     "REPEAT-RATE DONE: 10 libraries"),
], ids=["differential", "fastq", "bam", "repeat-rate"])
def test_seeded_cpu_block_ends_with_zero_divergences(capsys, name, argv,
                                                     done):
    summary, out = _run(capsys, name, CPU + argv)
    last = out.strip().splitlines()[-1]
    assert last.startswith(done), out[-2000:]
    if "--repeat-rate" in argv:
        assert summary["anchored"] > 0
        return
    assert last.endswith("zero divergences")
    assert summary["trials"] == int(argv[1]) and summary["items"] > 0
    if name == "differential":
        # trials 4, 9 and 14 also plant collisions; trial 7 is the mesh's
        assert summary["planted_trials"] == 3
        assert summary["planted_reads"] > 0
        assert "every one flagged needs_host" in out


def _planted_campaign(walk="both"):
    args = differential.parser().parse_args(["--device", "cpu", "--walk",
                                             walk])
    runtime = types.SimpleNamespace(device=torch.device("cpu"),
                                    is_controller=True)
    return Campaign(args, "differential", runtime, None)


@pytest.mark.parametrize("seed", [0, 1])
def test_planted_block_flags_every_forged_read(seed):
    rng = np.random.default_rng([seed, differential.PLANTED_STREAM])
    assert differential.check_planted(_planted_campaign(), rng) > 10


def test_planted_block_catches_a_probe_that_does_not_flag(monkeypatch):
    """A probe that never flags a verify miss (as one that searched on
    past it would not) fails the block."""
    real = probe.select_lane

    def unflagged(*a, **k):
        bucket_sel, lane_sel, fp_bad = real(*a, **k)
        return bucket_sel, lane_sel, fp_bad & False

    monkeypatch.setattr(probe, "select_lane", unflagged)
    rng = np.random.default_rng([0, differential.PLANTED_STREAM])
    with pytest.raises(Divergence, match="not flagged needs_host"):
        differential.check_planted(_planted_campaign("fused"), rng)


INJECT = """
import sys
from nimble_tpu_torch.fuzz import differential
from nimble_tpu_torch.models.aligner import BucketedEngine

real = BucketedEngine.align_batch

def flipped(self, seqs):
    out = real(self, seqs)
    out[-1] = (None, None) if out[-1][0] is not None else (([0], 0.5, 40),
                                                          None)
    return out

BucketedEngine.align_batch = flipped
sys.exit(differential.main(sys.argv[1:]))
"""


def _inject(argv):
    return subprocess.run(
        [sys.executable, "-c", INJECT, *CPU, *argv], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240)


def test_injected_divergence_exits_non_zero_with_a_reproducer(capsys):
    first = _inject(["--trials", "3", "--seed", "5"])
    assert first.returncode != 0
    failed = [ln for ln in first.stdout.splitlines()
              if ln.startswith("FAILED")]
    assert len(failed) == 1, first.stdout + first.stderr[-2000:]
    line = failed[0]
    child = int(line.split("child_seed=")[1].split()[0])
    trial = int(line.split("FAILED at trial ")[1].split()[0])
    for part in ("seed=5", "walk=fused", "device=cpu", "Divergence"):
        assert part in line + first.stderr, part
    assert "DIVERGENCE" in first.stderr
    want = int(np.random.default_rng(5).integers(0, 2**63 - 1))
    assert (trial, child) == (0, want)
    again = _inject(["--child-seed", str(child), "--trial", str(trial)])
    assert again.returncode != 0
    assert f"child_seed={child}" in again.stdout
    # the same trial without the injected fault passes
    summary, out = _run(capsys, "differential",
                        CPU + ["--child-seed", str(child), "--trial",
                               str(trial)])
    assert summary["trials"] == 1 and "zero divergences" in out


@pytest.mark.parametrize("name", ENTRIES)
def test_cuda_without_a_card_exits_non_zero_with_a_message(name):
    proc = subprocess.run(
        [sys.executable, "-m", f"nimble_tpu_torch.fuzz.{name}", "--trials",
         "1"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "DONE" not in proc.stdout


def test_the_ports_cdbg_oracle_is_the_tests_own():
    """Byte for byte, but for the one docstring line that names where the
    reference keeps its crate list (a path outside the repository)."""
    with open(os.path.join(REPO, "tests", "cdbg_oracle.py"), "rb") as f:
        tests_lines = f.read().split(b"\n")
    with open(os.path.join(REPO, "nimble_tpu_torch", "fuzz",
                           "cdbg_oracle.py"), "rb") as f:
        port_lines = f.read().split(b"\n")
    assert len(port_lines) == len(tests_lines)
    differ = [i for i, (a, b) in enumerate(zip(port_lines, tests_lines))
              if a != b]
    assert differ == [7]
    tail = b"Cargo.toml:23`), NOT from `nimble_tpu/core/walk.py`."
    assert tests_lines[7].endswith(tail)
    assert port_lines[7] == b"the reference's `" + tail
