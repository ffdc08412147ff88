"""pipeline.bam_fast finish: the forensic rows, microseconds a record
(consumers summed)."""

from portbench.readers import timer_per_item


def read(ctx):
    return timer_per_item(ctx, "bam.finish", 1e6)
