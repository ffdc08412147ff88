"""The FASTQ path: the CLI's ``fastq_pipeline.process``, from the FASTQ file
on disk to the count TSV, against one library on the card.

A cell on this path names ``reads_per_pass``: the reads of its FASTQ file,
which every pass of the window reads whole.  Its output is checked whole:
every byte of the TSV against the reference's.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from portbench import generate
from portbench.reference import expected

ITEMS = "reads"
RATE = "fastq_reads_per_s"  # its end-to-end rate
# calls into each layer, labelled in the traced run
SPANS = (
    ("nimble_tpu_torch.pipeline.fastq_pipeline", "_drain_pending"),
    ("nimble_tpu_torch.core.fast_count", "FastCounter.dispatch_async"),
    ("nimble_tpu_torch.pipeline.fastq_pipeline", "write_to_tsv"),
)


def make_inputs(cell: dict, seed: int, work: str) -> dict:
    lib = generate.library(cell["config_file"])
    reads = generate.fastq_reads(lib, cell["traffic_file"],
                                 cell["reads_per_pass"], seed)
    library = os.path.join(work, "library.json")
    fastq = os.path.join(work, "reads.fastq")
    generate.write_library(library, lib)
    generate.write_fastq(fastq, reads)
    return {"library": library, "input": fastq, "reads": reads,
            "items": len(reads), "output": os.path.join(work, "out.tsv"),
            "strand_filter": cell["config_file"]["strand_filter"]}


def setup(inputs: dict, device: str) -> dict:
    """The CLI's set-up: library, index, engine (tables on the card)."""
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.aligner import TorchAlignEngine

    cfg, ref = load_reference_library(
        inputs["library"], LibraryChemistry.from_cli(inputs["strand_filter"]))
    seqs, _names = get_reference_sequence_data(ref)
    engine = TorchAlignEngine(build_index(seqs, num_threads=1), cfg,
                              device=device, walk="fused")
    return {"engine": engine, "reference": ref, "config": cfg}


def run_pass(state: dict, inputs: dict, output: str) -> None:
    from nimble_tpu_torch.pipeline.fastq_pipeline import process

    if os.path.exists(output):
        os.remove(output)  # the TSV writer appends
    process([inputs["input"]], [state["engine"]], [state["reference"]],
            [state["config"]], [output])


def replay(state: dict, inputs: dict) -> dict:
    """The cell's distinct reads in the engine's full launches (8,192 reads
    at their bucket; the remainder left out, so every launch is alike):
    ``run`` replays them once; ``bytes`` and ``ops`` are what one replay's
    launches need, by the frozen count."""
    import torch

    from portbench import roofline

    engine = state["engine"]
    reads = np.unique(inputs["reads"], axis=0)
    batch = engine.launch_batch
    if len(reads) >= batch:
        reads = reads[: len(reads) // batch * batch]
    lens = np.full(len(reads), reads.shape[1], dtype=np.int32)
    bucket = min(b for b in engine.buckets if b >= reads.shape[1])
    n_bytes = n_ops = 0
    packed = torch.from_numpy(roofline.pack_reads(reads, lens, bucket))
    packed = packed.to(engine.device)
    for i in range(0, len(reads), batch):
        b, o = roofline.probe_walk_work(packed[i: i + batch], engine.tables,
                                        bucket, engine.c_max, full=False)
        n_bytes, n_ops = n_bytes + b, n_ops + o

    def run() -> None:
        engine.compact_collect(engine.compact_dispatch(reads, lens))

    return {"bytes": n_bytes, "ops": n_ops,
            "launches": -(-len(reads) // batch), "run": run}


def check(inputs: dict, device, overrides=None) -> dict:
    """The bytes the reference says the last pass had to write."""
    return {"tsv": expected.fastq_tsv(inputs["library"],
                                      inputs["strand_filter"],
                                      inputs["reads"], device, overrides)}


def digest(output: str) -> str:
    with open(output, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def write_output(want: dict, output: str) -> None:
    """Write what ``check`` returned as the program would have."""
    with open(output, "wb") as f:
        f.write(want["tsv"])


def compare(inputs: dict, output: str, want: dict) -> list:
    """(name, count) of what the output gets wrong: all 0 if right."""
    with open(output, "rb") as f:
        got = f.read()
    return [("tsv_lines_differing", lines_differing(got, want["tsv"]))]


def lines_differing(got: bytes, want: bytes) -> int:
    a, b = got.split(b"\n"), want.split(b"\n")
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
