"""The program's NIMBLE_TIMING lines, as recorded, parse into stage sums."""

import pytest

from portbench import trace

RECORDED = """\
fastq_align: 32,768 items in 0.75s (43,690/s over 1 calls)
[fastq loop] parse-wait 0.009s submit 0.101s drain 1.890s
[fastq loop] parse-wait 0.011s submit 0.099s drain 1.810s
[bam_fast wall] producer joined @ 3.570s
[bam_fast producer] read 0.78s
[bam_fast consumer 0] prepare 1.28s collect-wait 1.20s finish 6.71s queue-wait 0.02s
[bam_fast consumer 1] prepare 0.72s collect-wait 0.80s finish 0.29s queue-wait 0.10s
[bam_fast logger] gzip-write 0.17s (12.3 MB raw)
"""


def test_timing_lines_sum_over_passes_and_consumers():
    sums = trace.parse_timing(RECORDED)
    assert sums == pytest.approx({
        "fastq.parse-wait": 0.020, "fastq.submit": 0.200,
        "fastq.drain": 3.700, "bam.read": 0.78, "bam.prepare": 2.00,
        "bam.collect-wait": 2.00, "bam.finish": 7.00, "bam.queue-wait": 0.12,
        "bam.gzip-write": 0.17})


def test_other_lines_are_ignored():
    assert trace.parse_timing("warning: 1.0s\n[other] drain 2s\n") == {}
