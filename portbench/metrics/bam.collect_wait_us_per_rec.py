"""collect: device wait, fetch, gates and host rescue, microseconds a
record (consumers summed)."""

from portbench.readers import timer_per_item


def read(ctx):
    return timer_per_item(ctx, "bam.collect-wait", 1e6)
