"""pipeline.bam_fast finish: the orientation memo's look-ups and misses over
a batch's distinct admitted combinations (the span ``bam.orient``, inside
``bam.finish``), microseconds a record."""

from portbench.strands import span_per_item


def read(ctx):
    return span_per_item(ctx, "bam.orient", 1e6)
