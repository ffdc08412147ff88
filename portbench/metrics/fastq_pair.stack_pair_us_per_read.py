"""core.fast_count dispatch: the stack of a chunk's distinct R1 and R2 rows
into one launch's batch (the span ``fastq.stack_pair``, inside
``fastq.dispatch``), microseconds a read of either file; 0 on single-end
input."""

from portbench.mates import span_per_item


def read(ctx):
    return span_per_item(ctx, "fastq.stack_pair", 1e6)
