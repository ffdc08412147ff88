"""models.aligner collect and count: device wait, fetch, entropy gate, host
rescue and counting, microseconds a read (the drain sum)."""

from portbench.readers import timer_per_item


def read(ctx):
    return timer_per_item(ctx, "fastq.drain", 1e6)
