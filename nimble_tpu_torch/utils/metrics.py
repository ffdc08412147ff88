"""Observability: throughput counters and a profiler hook.

The reference's only observability is println! progress markers (per-1M-read
blocks, `src/parse/bam.rs:121-127`) plus the forensic TSV itself.  The port
keeps first-class counters (reads/s per stage), an optional
``torch.profiler`` trace hook (:func:`profiler_trace`) for on-device
analysis, and the card's own time of a call from such a trace
(:func:`device_ms`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ThroughputMeter:
    """Monotonic counter with rate reporting.

    >>> m = ThroughputMeter("align")
    >>> with m.measure(1024): pass   # times the block, counts 1024 items
    >>> m.rate()  # items/sec over total measured time
    """

    name: str
    items: int = 0
    seconds: float = 0.0
    calls: int = 0

    @contextlib.contextmanager
    def measure(self, n_items: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.items += n_items
            self.calls += 1

    def add(self, n_items: int, seconds: float) -> None:
        self.items += n_items
        self.seconds += seconds
        self.calls += 1

    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.name}: {self.items:,} items in {self.seconds:.2f}s "
            f"({self.rate():,.0f}/s over {self.calls} calls)"
        )


class MetricsRegistry:
    """Process-wide named meters (pipelines report at shutdown)."""

    def __init__(self) -> None:
        self.meters: Dict[str, ThroughputMeter] = {}

    def meter(self, name: str) -> ThroughputMeter:
        if name not in self.meters:
            self.meters[name] = ThroughputMeter(name)
        return self.meters[name]

    def report(self) -> str:
        return "\n".join(m.summary() for m in self.meters.values())


METRICS = MetricsRegistry()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a region in a ``torch.profiler`` trace when ``log_dir`` is set:
    the host's activity, and the card's when CUDA is available, written as
    a Chrome trace (``trace.json``, viewed in Perfetto or
    ``chrome://tracing``) into ``log_dir``.  No-op when log_dir is None.

    The counterpart of ``nimble_tpu.utils.metrics.profiler_trace`` (a JAX
    profiler trace).  It differs from that original by design, so the host
    modules' byte-equality test (``tests/test_torch_host.py``) does not
    cover it; ``tests/test_torch_graft_entry.py`` does.
    """
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_us(prof, name: str = "") -> tuple:
    """(summed device time in us, records) of a ``torch.profiler`` trace's
    CUDA kernels whose name contains ``name``."""
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and name in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    return total, count


def device_ms(fn, iters: int, kernel: str = "") -> float:
    """Device time per call of ``fn`` on the card from a torch.profiler
    (CUPTI) trace: the summed duration of the CUDA kernels whose name
    contains ``kernel`` (all kernels when empty), over ``iters`` calls
    after one warm-up call.  Unlike CUDA events around the calls it
    excludes the host's launch gaps between kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace is taken only when it holds a record of every launch: at
    # least one a call, and for a named kernel a whole number a call.
    # Traces on an H100 have come back missing a kernel's records (a
    # quarter of them, or, with torch 2.11, one record in most traces),
    # for no cause found yet; such a trace is retaken, at most four times,
    # and said so.  When every trace misses exactly one record, the call
    # is timed by the mean of the records the last trace holds (its
    # launches a call times the mean per launch), said so and counted in
    # ``device_ms.fallbacks``; a trace with a record too many or missing
    # more raises
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, count = device_us(prof, kernel)
        if count >= iters and (not kernel or count % iters == 0):
            return total_us / 1e3 / iters
        print(f"[profiler] trace {attempt + 1} of {kernel or 'all kernels'!r}"
              f" holds {count} kernel records for {iters} calls; retaken")
    per_call = max(1, round(count / iters))
    if count == per_call * iters - 1:
        print(f"[profiler] {kernel or 'all kernels'!r}: the mean of {count} "
              f"records, {per_call} a call")
        device_ms.fallbacks += 1
        return total_us / count * per_call / 1e3
    raise AssertionError(f"profiler traces of {kernel!r} miss launches or "
                         f"hold {count} records for {iters} calls")


device_ms.fallbacks = 0
