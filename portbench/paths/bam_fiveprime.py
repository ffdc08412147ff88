"""The 10x 5′ BAM path: the CLI's ``bam_fast.process_fast`` with its default
core count (one consumer), from a 5′ BAM on disk (124-base R1s, 150-base
R2s) to the gzipped forensic TSV, against one library on the card under
the ``fiveprime`` strand filter.

A cell on this path names a configuration whose ``strand_filter`` is
``fiveprime`` and ``groups_per_pass``: the UMI groups of the BAM, which
every pass reads whole.  Its output is checked whole: every line of the
decompressed TSV against the 5′ reference's
(:mod:`portbench.reference.fiveprime`).
"""

from __future__ import annotations

import os

from portbench import fiveprime, generate
from portbench.paths.bam import (  # noqa: F401
    ITEMS, RATE, SPANS, compare, digest, run_pass, write_output)
from portbench.paths.fastq import setup  # noqa: F401  (the same CLI set-up)
from portbench.reference import fiveprime as reference


def make_inputs(cell: dict, seed: int, work: str) -> dict:
    strand = cell["config_file"].get("strand_filter")
    if strand != "fiveprime":
        raise SystemExit(f"configuration {cell['config']!r} runs strand "
                         f"filter {strand!r}, not fiveprime")
    lib = generate.library(cell["config_file"])
    recs = fiveprime.records(lib, cell["traffic_file"],
                             cell["groups_per_pass"], seed)
    library = os.path.join(work, "library.json")
    bam = os.path.join(work, "reads.bam")
    generate.write_library(library, lib)
    fiveprime.write_bam(bam, recs)
    return {"library": library, "input": bam, "records": recs,
            "items": recs.n_records,
            "output": os.path.join(work, "out.tsv.gz"),
            "strand_filter": strand}


def check(inputs: dict, device, overrides=None) -> dict:
    """The decompressed TSV the reference says every pass had to write,
    and the pass's count of pairs whose orientation ends in a triage."""
    tsv, oriented_out = reference.bam_tsv(
        inputs["library"], inputs["strand_filter"], inputs["records"],
        device, overrides)
    return {"tsv": tsv, "pairs_oriented_out": oriented_out}
