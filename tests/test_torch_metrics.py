"""``utils.metrics.device_ms``: which profiler traces it takes.

A trace must hold a record of every launch; one that misses records is
retaken (at most four times).  When every trace misses exactly one record
(as traces on the H100 under torch 2.11 did), the call is timed by the mean
of the records the last trace holds and ``device_ms.fallbacks`` counts it;
a trace missing more, or holding a record too many (another kernel of the
same name), raises.  The
profiler is replaced by a stand-in that reports chosen (total, count)
pairs, so no card is needed.
"""

import contextlib

import pytest
import torch

from nimble_tpu_torch.utils import metrics


@pytest.fixture
def traces(monkeypatch):
    """The (total us, records) each successive trace reports."""
    reports = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr("torch.profiler.profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(metrics, "device_us",
                        lambda prof, name="": reports.pop(0))
    return reports


@pytest.mark.parametrize("kernel", ["probe_walk_filter_kernel", ""],
                         ids=["named", "all kernels"])
def test_a_whole_trace_is_taken(traces, kernel):
    traces.extend([(49.0, 49), (100.0, 50)])
    assert metrics.device_ms(lambda: None, 50, kernel) == pytest.approx(
        100.0 / 50 / 1e3)
    assert not traces


@pytest.mark.parametrize("kernel", ["probe_walk_filter_kernel", ""],
                         ids=["named", "all kernels"])
def test_traces_missing_one_record_take_its_mean(traces, kernel):
    before = metrics.device_ms.fallbacks
    traces.extend([(98.0, 49)] * 5)
    assert metrics.device_ms(lambda: None, 50, kernel) == pytest.approx(
        98.0 / 49 / 1e3)
    assert metrics.device_ms.fallbacks == before + 1
    if kernel:  # two launches a call, one missed (all kernels: taken)
        traces.extend([(5 * 99.0, 99)] * 5)
        assert metrics.device_ms(lambda: None, 50, kernel) == pytest.approx(
            5.0 * 2 / 1e3)
        assert metrics.device_ms.fallbacks == before + 2


def test_traces_missing_more_raise(traces):
    traces.extend([(96.0, 48)] * 5)
    with pytest.raises(AssertionError, match="miss launches"):
        metrics.device_ms(lambda: None, 50, "probe_walk_filter_kernel")
    traces.extend([(0.0, 0)] * 5)
    with pytest.raises(AssertionError, match="miss launches"):
        metrics.device_ms(lambda: None, 50, "")


@pytest.mark.parametrize("records", [51, 101], ids=["one a call", "two a call"])
def test_traces_with_a_record_too_many_raise(traces, records):
    before = metrics.device_ms.fallbacks
    traces.extend([(float(records), records)] * 5)
    with pytest.raises(AssertionError, match=f"hold {records} records"):
        metrics.device_ms(lambda: None, 50, "probe_walk_filter_kernel")
    assert not traces and metrics.device_ms.fallbacks == before
