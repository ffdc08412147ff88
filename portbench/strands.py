"""Readings of the program's 10x 5′ BAM pass, for the per-layer metrics of
``metrics/`` named ``bam_5p.*``.

A program that records the 5′ pass names the counters
``bam.records_clipped`` and ``bam.pairs_oriented_out`` in
``bam_fast.COUNTERS`` (the ``[bam_fast counts]`` line) and opens the span
``bam.orient`` on every batch.  Where it does, a traced window of BAM
passes reads them, 0 where nothing was clipped or oriented out.  A program
that does not record them gives nothing to read: every function here
returns None and raises nothing.
"""

from __future__ import annotations

import importlib
from typing import Optional

from portbench import program_spans, stacked

COUNTERS = ("bam.records_clipped", "bam.pairs_oriented_out")


def recorded():
    """The program's recorder where it records the 5′ pass and traced a BAM
    pass (``stacked.recorded``), else None."""
    rec = stacked.recorded("bam")
    if rec is None:
        return None
    pipeline = importlib.import_module(stacked.PIPELINES["bam"])
    return rec if set(COUNTERS) <= set(pipeline.COUNTERS) else None


def counter_pct(ctx: dict, part: str, per_record: float) -> Optional[float]:
    """100 x the counter ``part`` over the window's records in, times
    ``per_record`` (2 to count over pairs); None where no record came in."""
    rec = recorded()
    if rec is None:
        return None
    counters = dict(rec.counters)
    whole = counters.get("bam.records_in", 0)
    if not whole:
        return None
    return 100.0 * counters.get(part, 0) * per_record / whole


def span_per_item(ctx: dict, name: str, scale: float) -> Optional[float]:
    """The window's wall seconds in spans ``name`` per item, times
    ``scale`` (``program_spans.span_per_item``); 0 where the program records
    the 5′ pass and no such span opened."""
    if recorded() is None or not ctx["items"]:
        return None
    value = program_spans.span_per_item(ctx, name, scale)
    return 0.0 if value is None else value
