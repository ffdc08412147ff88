"""The check fails what it must: the control (the reference with the
configuration's num_mismatches broken: one more allowed) and a run whose timed path is
broken underneath, once for each fault a cell can have."""

import json

import numpy as np
import pytest

from portbench import control, run, spec


@pytest.mark.parametrize("cell", ["tiny_basic_fastq", "tiny_basic_bam"])
def test_the_control_is_not_correct(tiny, tmp_path, cell):
    got = control.readings(spec.load_cell(cell, tiny), 2**31 + 9, "cpu",
                           str(tmp_path))
    assert any(v > 0 for v in got.values()), got


def _altered_compact(orig):
    def collect(self, state, *a, **kw):
        res = orig(self, state, *a, **kw)
        res["passed"][::3] = False  # an answer altered where it is made
        return res
    return collect


def _half_chunks(orig):
    def chunks(path, n, *a, **kw):
        for mat, lens in orig(path, n, *a, **kw):
            half = mat.shape[0] // 2  # half of every batch left out
            yield mat[:half], lens[:half]
    return chunks


def _altered_full(orig):
    def collect(self, state):
        res = orig(self, state)
        res["score"][res["reason"] == -1] += 1  # an answer altered
        return res
    return collect


def _half_full(orig):
    def collect(self, state):
        res = orig(self, state)
        res["reason"][1::2] = 3  # half of the batch's alignments left out
        res["eq_key"][1::2] = -1
        res["score"][1::2] = 0
        res["norm"][1::2] = 0.0
        return res
    return collect


FAULTS = {
    "answer_altered_fastq": ("tiny_basic_fastq", "models.aligner",
                             "TorchAlignEngine.compact_collect",
                             _altered_compact),
    "half_left_out_fastq": ("tiny_basic_fastq", "pipeline.fastq_pipeline",
                            "iter_fastq_matrix_chunks", _half_chunks),
    "answer_altered_bam": ("tiny_basic_bam", "models.aligner",
                           "TorchAlignEngine.full_collect", _altered_full),
    "half_left_out_bam": ("tiny_basic_bam", "models.aligner",
                          "TorchAlignEngine.full_collect", _half_full),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, capsys, monkeypatch,
                                            fault):
    import importlib

    cell, module, attr, wrap = FAULTS[fault]
    owner = importlib.import_module(f"nimble_tpu_torch.{module}")
    *parents, name = attr.split(".")
    for p in parents:
        owner = getattr(owner, p)
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    rc = run.main(["--workload", cell, "--seed", "2147483711", "--seconds",
                   "0.01"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0


def test_the_half_batch_fault_code_is_no_match():
    from nimble_tpu_torch.config import FILTER_REASONS, FilterReason

    assert FILTER_REASONS[3] == FilterReason.NO_MATCH
    assert np.int16(3) == FILTER_REASONS.index(FilterReason.NO_MATCH)


def test_a_pass_unlike_the_last_is_wrong(tiny, capsys, monkeypatch):
    """A run whose passes disagree fails even when its last pass is right."""
    from portbench.paths import fastq

    calls = []
    orig = fastq.run_pass

    def first_pass_broken(state, inputs, output):
        orig(state, inputs, output)
        calls.append(output)
        if len(calls) == 2:  # the window's first pass (after the warm one)
            with open(output, "ab") as f:
                f.write(b"feature0\t1\n")

    monkeypatch.setattr(fastq, "run_pass", first_pass_broken)
    rc = run.main(["--workload", "tiny_basic_fastq", "--seed", "12",
                   "--seconds", "6"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and len(calls) > 2
    assert line["checks"]["passes_wrong"]["value"] == 1
    assert line["correct"] is False
