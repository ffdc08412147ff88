"""models.aligner collect and count: the pairs counted with a call on both
mates over those counted with a call on either (the counters
``fastq.pairs_both`` and ``fastq.pairs_one_mate``), percent."""

from portbench.mates import both_mates_pct


def read(ctx):
    return both_mates_pct(ctx)
