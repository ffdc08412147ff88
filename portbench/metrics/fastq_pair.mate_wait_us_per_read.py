"""io.fastq: the main loop's wait for R2's chunk once R1's has come (the
span ``fastq.parse_wait.mate``, inside ``fastq.parse_wait``), microseconds a
read of either file; 0 on single-end input."""

from portbench.mates import span_per_item


def read(ctx):
    return span_per_item(ctx, "fastq.parse_wait.mate", 1e6)
