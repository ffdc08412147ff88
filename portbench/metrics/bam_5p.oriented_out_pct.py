"""pipeline.bam_fast finish: the pairs with a call on at least one mate
whose orientation ends in a triage (counter ``bam.pairs_oriented_out``,
each pair counted) over the pairs in (half of ``bam.records_in``),
percent."""

from portbench.strands import counter_pct


def read(ctx):
    return counter_pct(ctx, "bam.pairs_oriented_out", 2.0)
