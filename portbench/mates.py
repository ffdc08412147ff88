"""Readings of the program's paired-end FASTQ pass, for the per-layer metrics
of ``metrics/`` named ``fastq_pair.*``.

A program that records the pair names the counter ``fastq.pairs_in`` in
``fastq_pipeline.COUNTERS`` (the ``[fastq counts]`` line).  Where it does,
a traced window of single-end passes reads 0 for the pair's spans (no mate
waited for, no pair stacked) and nothing for the pairs' outcomes.  A
program that does not record it gives nothing to read: every function here
returns None and raises nothing.
"""

from __future__ import annotations

import importlib
from typing import Optional

from portbench import program_spans, stacked


def recorded():
    """The program's recorder where it records the pair and traced a FASTQ
    pass (``stacked.recorded``), else None."""
    rec = stacked.recorded("fastq")
    if rec is None:
        return None
    pipeline = importlib.import_module(stacked.PIPELINES["fastq"])
    return rec if "fastq.pairs_in" in pipeline.COUNTERS else None


def span_per_item(ctx: dict, name: str, scale: float) -> Optional[float]:
    """The window's wall seconds in spans ``name`` per item, times
    ``scale`` (``program_spans.span_per_item``); 0 where the program records
    the pair and no such span opened."""
    if recorded() is None or not ctx["items"]:
        return None
    value = program_spans.span_per_item(ctx, name, scale)
    return 0.0 if value is None else value


def both_mates_pct(ctx: dict) -> Optional[float]:
    """100 x the pairs counted with a call on both mates over those counted
    with a call on one or both (the counters ``fastq.pairs_both`` and
    ``fastq.pairs_one_mate``); None where no pair was counted."""
    rec = recorded()
    if rec is None:
        return None
    counters = dict(rec.counters)
    both = counters.get("fastq.pairs_both", 0)
    whole = both + counters.get("fastq.pairs_one_mate", 0)
    if not whole:
        return None
    return 100.0 * both / whole
