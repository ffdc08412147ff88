"""Arithmetic shared by the per-layer metric readers of ``metrics/``.

A reader's ``read(ctx)`` gets the traced run's readings: ``items`` (reads
or records the window's passes took in), ``window_s`` (the passes'
seconds), ``busy_s`` (the union of the card's kernel, copy and set
intervals in them), ``timers`` (the program's ``NIMBLE_TIMING`` sums),
``trace`` (the window's :class:`portbench.trace.Trace`) and ``replay``
(the path's kernel replay: its bytes and operations and its trace).  It
returns None where it finds nothing to read.
"""

from __future__ import annotations

from typing import Optional

from portbench import roofline


def timer_per_item(ctx: dict, key: str, scale: float) -> Optional[float]:
    """A ``NIMBLE_TIMING`` stage's seconds per item, times ``scale``."""
    secs = ctx["timers"].get(key)
    if secs is None or not ctx["items"]:
        return None
    return secs / ctx["items"] * scale


def kernel_per_item(ctx: dict, fragment: str, scale: float) -> Optional[float]:
    """Device seconds of the window's kernels named with ``fragment`` per
    item, times ``scale``."""
    secs, records = ctx["trace"].kernel_s(fragment)
    if not records or not ctx["items"]:
        return None
    return secs / ctx["items"] * scale


def idle_pct(ctx: dict) -> Optional[float]:
    if not ctx["window_s"] or not ctx["trace"].device:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def roofline_pct(ctx: dict, fragment: str) -> Optional[float]:
    """The replayed launches' least time (bytes or operations at the
    card's peak) as a share of their device time: a launch's mean device
    time over the records the trace holds, times the launches of one
    replay."""
    replay = ctx["replay"]
    if not replay:
        return None
    secs, records = replay["trace"].kernel_s(fragment)
    if not records:
        return None
    device = secs / records * replay["launches"]
    return 100.0 * roofline.least_seconds(replay["bytes"],
                                          replay["ops"]) / device
