"""the gzip logger thread's write time, microseconds a record."""

from portbench.readers import timer_per_item


def read(ctx):
    return timer_per_item(ctx, "bam.gzip-write", 1e6)
