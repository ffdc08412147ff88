"""io.bam_columnar: the records whose SEQ the 10x 124-base rule clipped
(counter ``bam.records_clipped``, counted on the reader a batch) over the
records in (``bam.records_in``), percent; 50 on a 5′ BAM of 124-base R1s
and 150-base R2s, 0 on one without 124-base records."""

from portbench.strands import counter_pct


def read(ctx):
    return counter_pct(ctx, "bam.records_clipped", 1.0)
