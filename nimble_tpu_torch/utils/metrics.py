"""Observability: throughput counters and a profiler hook.

The reference's only observability is println! progress markers (per-1M-read
blocks, `src/parse/bam.rs:121-127`) plus the forensic TSV itself.  The port
keeps first-class counters (reads/s per stage) and an optional
``torch.profiler`` trace hook (:func:`profiler_trace`) for on-device
analysis.
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
