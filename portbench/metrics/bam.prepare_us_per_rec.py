"""pipeline.bam_fast prepare: orient, trim, dedupe, pack and launch,
microseconds a record (consumers summed)."""

from portbench.readers import timer_per_item


def read(ctx):
    return timer_per_item(ctx, "bam.prepare", 1e6)
