"""The FASTQ campaign: the streaming counting path on the port's engines
must write the slow path's ``feature\\tscore`` TSV byte for byte.

    python -m nimble_tpu_torch.fuzz.fastq [--device cuda|cpu]
        [--walk fused|double|both] [--trials N | --minutes M] [--seed S]
        [--mesh-only] [--child-seed C [--trial T]]

The port of ``scripts/fuzz_fastq.py`` (``campaign`` has the options the
three campaigns share).  Each trial draws a library (sometimes two), a
config across the whole surface (chemistry, intersect levels, group_on
rollup, discard_multi_hits, require_valid_pair, multi-hit caps), single or
paired reads, gzip or not, often duplicate-heavy
(``corpus.draw_fastq_trial``), writes the FASTQ files, and runs
``pipeline.fastq_pipeline.process`` once per library with
``core.calls.HostAlignEngine`` (the slow ``call`` path) and, for each walk
of ``--walk``, once with the port's engines:

- two libraries: two ``TorchAlignEngine`` in one call, which the pipeline
  serves through ``TorchMultiLibraryDispatcher``'s stacked pass;
- one library: a ``TorchAlignEngine``, or in 12% of the trials a
  ``TorchMeshAlignEngine`` on the mesh of the process group.

Each library's TSV must equal its slow run's.  The chunk size of a run
follows its output tag, as in the script.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile
from dataclasses import dataclass

import numpy as np

from nimble_tpu_torch.core.calls import HostAlignEngine
from nimble_tpu_torch.fuzz import corpus
from nimble_tpu_torch.fuzz.campaign import (
    Campaign,
    build_parser,
    require,
    run_entry,
)
from nimble_tpu_torch.index.build import build_index
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.models.mesh_aligner import TorchMeshAlignEngine
from nimble_tpu_torch.pipeline import fastq_pipeline


def run_pipeline(files, engines, refs, cfgs, td, tag):
    """Each library's TSV bytes of one ``fastq_pipeline.process`` call."""
    paths = [f"{td}/{tag}_{i}.tsv" for i in range(len(engines))]
    for p in paths:
        if os.path.exists(p):
            os.unlink(p)  # writer is append-mode
    with contextlib.redirect_stdout(io.StringIO()):
        fastq_pipeline.process(files, engines, refs, cfgs, paths,
                               chunk_reads=1 << int(np.random.default_rng(
                                   len(tag)).integers(4, 8)))
    outs = []
    for p in paths:
        with open(p, "rb") as f:
            outs.append(f.read())
    return outs


@dataclass
class Trial:
    campaign: Campaign
    trial: corpus.FastqTrial
    number: int
    td: str

    @property
    def mesh(self) -> bool:
        return self.trial.use_mesh

    def build(self):
        c, t = self.campaign, self.trial
        indexes = [build_index(lib.doubled) for lib in t.libraries]
        if self.mesh:
            lib = t.libraries[0]
            engines = {w: [TorchMeshAlignEngine(indexes[0], lib.config,
                                                mesh=c.mesh, walk=w)]
                       for w in c.walks}
        else:
            engines = {w: [TorchAlignEngine(index, lib.config,
                                            device=c.device, walk=w)
                           for index, lib in zip(indexes, t.libraries)]
                       for w in c.walks}
        return indexes, engines

    def _write(self):
        t, n = self.trial, self.number
        ext = ".fastq.gz" if t.gz else ".fastq"
        files = [f"{self.td}/r1_{n}{ext}"]
        corpus.write_fastq(files[0], t.r1s, t.gz)
        if t.paired:
            files.append(f"{self.td}/r2_{n}{ext}")
            corpus.write_fastq(files[1], t.r2s, t.gz)
        return files

    def drive(self, built) -> int:
        c, t, n = self.campaign, self.trial, self.number
        indexes, engines = built
        files = self._write()
        refs = [lib.reference for lib in t.libraries]
        cfgs = [lib.config for lib in t.libraries]
        tags = ["slow"] if len(refs) == 1 else ["slowA", "slowB"]
        slow = [run_pipeline(files, [HostAlignEngine(index, cfg)], [ref],
                             [cfg], self.td, f"{tag}{n}")[0]
                for tag, index, ref, cfg in zip(tags, indexes, refs, cfgs)]
        for walk in c.walks:
            c.where = {"walk": walk, "mesh": self.mesh,
                       "libraries": len(refs)}
            fast = run_pipeline(files, engines[walk], refs, cfgs, self.td,
                                f"fast{n}")
            for i, (a, b) in enumerate(zip(fast, slow)):
                if a != b:
                    sys.stderr.write(f"library {i} diverges\nFAST:\n"
                                     f"{a.decode()}\nSLOW:\n{b.decode()}\n")
            require(fast == slow, "fast/slow FASTQ outputs diverge "
                    f"(trial={n}, walk={walk}, paired={t.paired}, "
                    f"libraries={len(refs)}, mesh={self.mesh}, "
                    f"cfg={cfgs[0].__dict__})")
        return len(t.r1s)


def parser():
    return build_parser("python -m nimble_tpu_torch.fuzz.fastq",
                        __doc__.splitlines()[0], default_minutes=20.0)


def _campaign(args, runtime, mesh) -> dict:
    campaign = Campaign(args, "fastq", runtime, mesh)
    with tempfile.TemporaryDirectory() as td:
        def draw(number, child):
            t = corpus.draw_fastq_trial(np.random.default_rng(child))
            return None if t is None else Trial(campaign, t, number, td)

        summary = campaign.run(draw, block=10, agree="byte-identical")
    if not runtime.is_controller:
        return {}
    print(f"DONE: {summary.trials} trials, {summary.items} reads, zero "
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
