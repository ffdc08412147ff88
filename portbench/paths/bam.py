"""The BAM path: the CLI's ``bam_fast.process_fast`` with its default core
count (one consumer), from the 10x BAM on disk to the gzipped forensic TSV,
against one library on the card.

A cell on this path names ``groups_per_pass``: the UMI groups of the BAM,
which every pass reads whole.  Its output is checked whole: every line of
the decompressed TSV against the reference's, which works out every group
the program writes (all but the BAM's final one).
"""

from __future__ import annotations

import gzip
import hashlib
import os

from portbench import generate
from portbench.paths.fastq import lines_differing
from portbench.paths.fastq import setup  # noqa: F401  (the same CLI set-up)
from portbench.reference import expected

ITEMS = "records"
RATE = "bam_records_per_s"  # its end-to-end rate
SPANS = (
    ("nimble_tpu_torch.pipeline.bam_fast", "_prepare_batch"),
    ("nimble_tpu_torch.pipeline.bam_fast", "_finish_batch"),
)


def make_inputs(cell: dict, seed: int, work: str) -> dict:
    lib = generate.library(cell["config_file"])
    recs = generate.tenx_records(lib, cell["traffic_file"],
                                 cell["groups_per_pass"], seed)
    library = os.path.join(work, "library.json")
    bam = os.path.join(work, "reads.bam")
    generate.write_library(library, lib)
    generate.write_bam(bam, recs)
    return {"library": library, "input": bam, "records": recs,
            "items": len(recs.seq),
            "output": os.path.join(work, "out.tsv.gz"),
            "strand_filter": cell["config_file"]["strand_filter"]}


def run_pass(state: dict, inputs: dict, output: str) -> None:
    from nimble_tpu_torch.pipeline.bam_fast import process_fast

    process_fast([inputs["input"]], [state["engine"]], [state["reference"]],
                 [state["config"]], [output], 1, False)


def check(inputs: dict, device, overrides=None) -> dict:
    """The decompressed TSV the reference says every pass had to write."""
    return {"tsv": expected.bam_tsv(inputs["library"],
                                    inputs["strand_filter"],
                                    inputs["records"], device, overrides)}


def _content(output: str) -> bytes:
    with gzip.open(output, "rb") as f:
        return f.read()


def digest(output: str) -> str:
    """The decompressed content's: the gzip header holds the time."""
    return hashlib.sha256(_content(output)).hexdigest()


def write_output(want: dict, output: str) -> None:
    """Write what ``check`` returned as the program would have."""
    with gzip.open(output, "wb") as f:
        f.write(want["tsv"])


def compare(inputs: dict, output: str, want: dict) -> list:
    """(name, count) of what the output gets wrong: all 0 if right."""
    return [("tsv_lines_differing",
             lines_differing(_content(output), want["tsv"]))]
