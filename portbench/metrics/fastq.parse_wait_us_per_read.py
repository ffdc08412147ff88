"""io.fastq: the main loop's wait for the parsed chunks, microseconds a
read (the program's parse-wait sum)."""

from portbench.readers import timer_per_item


def read(ctx):
    return timer_per_item(ctx, "fastq.parse-wait", 1e6)
