"""The traced run's readings: the program's ``NIMBLE_TIMING`` sums, the
profiler's device intervals, and spans around the calls into each layer.

``NIMBLE_TIMING`` makes the program print, per pass, its host stages'
seconds on standard error (``[fastq loop] parse-wait 0.1s submit 0.2s
drain 0.3s``; ``[bam_fast producer] read``, ``[bam_fast consumer N]
prepare / collect-wait / finish / queue-wait``, ``[bam_fast logger]
gzip-write``); :func:`parse_timing` sums them over passes and consumers as
``fastq.<stage>`` and ``bam.<stage>``.  The spans are
``torch.profiler.record_function`` labels put around program functions
named by a path module's ``SPANS`` (module, attribute path), for the
traced run only: they name what the host was doing in the device's idle
gaps.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import io
import json
import re
import threading
from typing import Dict, List, Sequence, Tuple

_LINE = re.compile(r"^\[(fastq loop|bam_fast producer|bam_fast consumer \d+|"
                   r"bam_fast logger)\] (.*)$")
_PAIR = re.compile(r"([a-z][a-z-]*) ([0-9.]+)s\b")


def parse_timing(text: str) -> Dict[str, float]:
    sums: Dict[str, float] = {}
    for line in text.splitlines():
        m = _LINE.match(line.strip())
        if not m:
            continue
        prefix = "fastq" if m.group(1).startswith("fastq") else "bam"
        for stage, secs in _PAIR.findall(m.group(2)):
            key = f"{prefix}.{stage}"
            sums[key] = sums.get(key, 0.0) + float(secs)
    return sums


class _Capture(io.TextIOBase):
    """A stderr stand-in that keeps what is written (any thread)."""

    def __init__(self):
        self.parts: List[str] = []
        self._lock = threading.Lock()

    def write(self, s: str) -> int:
        with self._lock:
            self.parts.append(s)
        return len(s)

    def text(self) -> str:
        return "".join(self.parts)


@contextlib.contextmanager
def capture_stderr():
    cap = _Capture()
    with contextlib.redirect_stderr(cap):
        yield cap


@contextlib.contextmanager
def spans(targets: Sequence[Tuple[str, str]]):
    """Wrap each (module, "Class.method" or "function") in a profiler
    label named after it, and restore it on exit; a target the program no
    longer has is skipped."""
    from torch.profiler import record_function

    undo = []
    for mod_name, attr_path in targets:
        try:
            owner = importlib.import_module(mod_name)
            *parents, attr = attr_path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            fn = getattr(owner, attr)
        except (ImportError, AttributeError):
            continue

        def wrapped(*a, __fn=fn, __label=attr_path, **kw):
            with record_function(__label):
                return __fn(*a, **kw)

        functools.update_wrapper(wrapped, fn)
        setattr(owner, attr, wrapped)
        undo.append((owner, attr, fn))
    try:
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Device intervals and host spans of a Chrome trace, in seconds."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.device: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, end = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat in _DEVICE_CATS:
                self.device.append((start, end, e.get("name", cat)))
            elif cat in ("cpu_op", "user_annotation"):
                self.host.append((start, end, e.get("name", cat)))
        self.device.sort()

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for start, end, _ in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_s(self, fragment: str) -> Tuple[float, int]:
        """(seconds, records) of the device records whose name holds
        ``fragment``."""
        hits = [b - a for a, b, n in self.device if fragment in n]
        return sum(hits), len(hits)

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for a, b, n in self.device:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                ][:top]

    def spans_named(self, name: str) -> List[Tuple[float, float]]:
        return sorted((a, b) for a, b, n in self.host if n == name)

    def idle_gaps(self, within: Sequence[Tuple[float, float]],
                  top: int = 10) -> List[list]:
        """The longest gaps between device intervals inside the intervals
        ``within`` (the passes), each named by the innermost other host
        span or op open at its middle."""
        busy = self.busy_intervals()
        gaps = []
        for t0, t1 in within:
            cursor = t0
            for a, b in busy:
                if b <= t0 or a >= t1:
                    continue
                if a > cursor:
                    gaps.append((a - cursor, cursor, a))
                cursor = max(cursor, b)
            if t1 > cursor:
                gaps.append((t1 - cursor, cursor, t1))
        gaps.sort(reverse=True)
        outer = set(within)
        out = []
        for length, a, b in gaps[:top]:
            mid = (a + b) / 2
            open_ = [(s, e, n) for s, e, n in self.host
                     if s <= mid <= e and (s, e) not in outer]
            name = (min(open_, key=lambda x: x[1] - x[0])[2] if open_
                    else "host code outside the spans")
            out.append([name, length])
        return out
