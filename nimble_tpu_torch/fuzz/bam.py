"""The BAM campaign: the columnar fast BAM path must write the object
pipeline's decompressed forensic bytes on anarchic record streams.

    python -m nimble_tpu_torch.fuzz.bam [--device cuda|cpu]
        [--walk fused|double|both] [--trials N | --minutes M] [--seed S]
        [--child-seed C [--trial T]]

The port of ``scripts/fuzz_bam.py`` (``campaign`` has the options the
three campaigns share).  Each trial draws a library, a config and a record
stream with missing CB tags, whitelist UMIs, the UB->UR fallback, unpaired
reads, orphan mates, 124 bp clip reads and mixed lengths and strands
(``corpus.draw_bam_trial``), writes it with ``io.bam.write_bam``, and for
each walk of ``--walk`` runs ``pipeline.bam_fast.process_fast`` and
``pipeline.bam_pipeline.process`` with one ``TorchAlignEngine`` on the
chosen device, in both quirk modes.  Both must leave the same decompressed
bytes, or both no file, and raise errors of the same type with the same
message.  No trial runs on the mesh.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import os
import sys
import tempfile
import zlib
from dataclasses import dataclass

import numpy as np

from nimble_tpu_torch.fuzz import corpus
from nimble_tpu_torch.fuzz.campaign import (
    Campaign,
    build_parser,
    require,
    run_entry,
)
from nimble_tpu_torch.index.build import build_index
from nimble_tpu_torch.io.bam import write_bam
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.pipeline import bam_pipeline
from nimble_tpu_torch.pipeline.bam_fast import process_fast


def run_both(bam, engine, ref, cfg, quirks, td, tag):
    """(fast, slow): each pipeline's error line (empty when it ran to its
    end) and the bytes of its output, decompressed (empty when it left no
    file or an unreadable one).  The script compares any exception; here
    only ``ValueError``, the pipelines' input errors, is compared."""
    outs = []
    for name, fn in (("fast", process_fast), ("slow", bam_pipeline.process)):
        out = f"{td}/{tag}_{name}.tsv.gz"
        if os.path.exists(out):
            os.unlink(out)
        err = ""
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                fn([bam], [engine], [ref], [cfg], [out], 2, False,
                   parity_quirks=quirks)
        except ValueError as e:
            # error parity: the input errors both pipelines raise (a kept
            # record with no UMI) are compared, not failures; any other
            # exception, a kernel's among them, ends the campaign
            err = f"{type(e).__name__}: {e}"
        try:
            with gzip.open(out, "rb") as f:
                body = f.read()
        except (OSError, EOFError, zlib.error):
            body = b""
        outs.append((err + "\n").encode() + body)
    return outs


@dataclass
class Trial:
    campaign: Campaign
    trial: corpus.BamTrial
    number: int
    td: str
    mesh = False

    def build(self):
        c, t = self.campaign, self.trial
        index = build_index(t.doubled)
        return [(w, TorchAlignEngine(index, t.config, device=c.device,
                                     walk=w)) for w in c.walks]

    def drive(self, engines) -> int:
        c, t = self.campaign, self.trial
        bam = f"{self.td}/fuzz.bam"
        write_bam(bam, corpus.BAM_HEADER, t.records)
        for walk, engine in engines:
            for quirks in (True, False):
                c.where = {"walk": walk, "quirks": quirks}
                fast, slow = run_both(bam, engine, t.reference, t.config,
                                      quirks, self.td, f"t{self.number}")
                heads = [out.split(b"\n", 1)[0] for out in (fast, slow)]
                require(fast == slow, "fast/slow BAM outputs diverge "
                        f"(walk={walk}, quirks={quirks}): fast {heads[0]!r}, "
                        f"{len(fast)} bytes; slow {heads[1]!r}, {len(slow)} "
                        "bytes")
        return len(t.records)


def parser():
    return build_parser("python -m nimble_tpu_torch.fuzz.bam",
                        __doc__.splitlines()[0], default_minutes=20.0,
                        mesh_trials=False)


def _campaign(args, runtime, mesh) -> dict:
    campaign = Campaign(args, "bam", runtime, mesh)
    with tempfile.TemporaryDirectory() as td:
        def draw(number, child):
            return Trial(campaign,
                         corpus.draw_bam_trial(np.random.default_rng(child)),
                         number, td)

        summary = campaign.run(draw, block=10, agree="byte-identical",
                               unit="records")
    if not runtime.is_controller:
        return {}
    print(f"DONE: {summary.trials} trials, {summary.items} records, zero "
          "divergences", flush=True)
    return summary.as_dict()


def run(argv=None, runtime=None, mesh=None) -> dict:
    """Run the campaign of ``argv``; returns what it checked (empty on a
    rank other than the controller)."""
    return run_entry(argv, parser(), _campaign, runtime, mesh)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
