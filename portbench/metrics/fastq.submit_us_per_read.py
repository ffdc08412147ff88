"""core.fast_count dispatch: dedupe, pack, upload and launch, microseconds
a read (the program's submit sum)."""

from portbench.readers import timer_per_item


def read(ctx):
    return timer_per_item(ctx, "fastq.submit", 1e6)
