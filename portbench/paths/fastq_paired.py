"""The paired-end FASTQ path: the CLI's ``fastq_pipeline.process`` with R1
and R2 files, from both files on disk to the count TSV, against one library
on the card.

A cell on this path names a configuration whose ``input`` is ``paired`` (a
job of two ``-i`` files, R1 then R2) and ``pairs_per_pass``: the pairs of its
two FASTQ files, which every pass of the window reads whole; a pass counts
the reads of both files.  Its output is checked whole: every byte of the TSV against
the paired reference's (:mod:`portbench.reference.paired`).
"""

from __future__ import annotations

import os

import numpy as np

from portbench import generate, paired
from portbench.paths.fastq import (  # noqa: F401
    ITEMS, RATE, SPANS, compare, digest, setup, write_output)
from portbench.reference import paired as reference


def make_inputs(cell: dict, seed: int, work: str) -> dict:
    if cell["config_file"].get("input") != "paired":
        raise SystemExit(f"configuration {cell['config']!r} is no paired job")
    lib = generate.library(cell["config_file"])
    pairs = paired.fastq_pairs(lib, cell["traffic_file"],
                               cell["pairs_per_pass"], seed)
    library = os.path.join(work, "library.json")
    r1, r2 = os.path.join(work, "r1.fastq"), os.path.join(work, "r2.fastq")
    generate.write_library(library, lib)
    generate.write_fastq(r1, pairs.r1)
    generate.write_fastq(r2, pairs.r2)
    return {"library": library, "inputs": [r1, r2], "r1": pairs.r1,
            "r2": pairs.r2, "items": 2 * len(pairs.r1),
            "output": os.path.join(work, "out.tsv"),
            "strand_filter": cell["config_file"]["strand_filter"]}


def run_pass(state: dict, inputs: dict, output: str) -> None:
    from nimble_tpu_torch.pipeline.fastq_pipeline import process

    if os.path.exists(output):
        os.remove(output)  # the TSV writer appends
    process(inputs["inputs"], [state["engine"]], [state["reference"]],
            [state["config"]], [output])


def stacked_rows(inputs: dict) -> np.ndarray:
    """The rows the program sends to the card: the distinct pairs (keyed by
    R1 + R2), R1 rows then R2 rows, as ``fast_count.stack_pair`` stacks
    them."""
    width = inputs["r1"].shape[1]
    uniq = reference.distinct_pairs(inputs["r1"], inputs["r2"])
    return np.ascontiguousarray(np.concatenate([uniq[:, :width],
                                                uniq[:, width:]]))


def replay(state: dict, inputs: dict) -> dict:
    """The cell's stacked distinct rows in the engine's full launches
    (8,192 rows at their bucket; the remainder left out, so every launch is
    alike): ``run`` replays them once; ``bytes`` and ``ops`` are what one
    replay's launches need, by the frozen count."""
    import torch

    from portbench import roofline

    engine = state["engine"]
    rows = stacked_rows(inputs)
    batch = engine.launch_batch
    if len(rows) >= batch:
        rows = rows[: len(rows) // batch * batch]
    lens = np.full(len(rows), rows.shape[1], dtype=np.int32)
    bucket = min(b for b in engine.buckets if b >= rows.shape[1])
    n_bytes = n_ops = 0
    packed = torch.from_numpy(roofline.pack_reads(rows, lens, bucket))
    packed = packed.to(engine.device)
    for i in range(0, len(rows), batch):
        b, o = roofline.probe_walk_work(packed[i: i + batch], engine.tables,
                                        bucket, engine.c_max, full=False)
        n_bytes, n_ops = n_bytes + b, n_ops + o

    def run() -> None:
        engine.compact_collect(engine.compact_dispatch(rows, lens))

    return {"bytes": n_bytes, "ops": n_ops, "bucket": bucket,
            "launches": -(-len(rows) // batch), "run": run}


def check(inputs: dict, device, overrides=None) -> dict:
    """The bytes the reference says the last pass had to write."""
    return {"tsv": reference.fastq_pair_tsv(
        inputs["library"], inputs["strand_filter"], inputs["r1"],
        inputs["r2"], device, overrides)}
