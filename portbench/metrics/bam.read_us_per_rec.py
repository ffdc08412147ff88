"""io.bam_columnar: the reader thread's read time, microseconds a record."""

from portbench.readers import timer_per_item


def read(ctx):
    return timer_per_item(ctx, "bam.read", 1e6)
