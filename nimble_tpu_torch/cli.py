"""Command line interface of the torch port: FASTQ counting and BAM input.

The surface of ``nimble_tpu.cli`` (the reference CLI's flags):

  nimble-tpu-torch -r lib.json [-r lib2.json ...] -i reads.fastq[.gz]
                   [-i mates.fastq] -o out.tsv [-o out2.tsv ...]
                   [-c CORES] [-f STRAND_FILTER] [-t LEN:STRICT,...]
                   [--engine device|host|mesh] [--device cuda|cpu]
                   [--walk fused|double]
  nimble-tpu-torch -r lib.json [-r lib2.json ...] -i reads.bam
                   -o out.tsv.gz [-o out2.tsv.gz ...]
                   [-c CORES] [-p] [--no-parity-quirks] [...]
  torchrun --nproc-per-node N -m nimble_tpu_torch.cli ... --engine mesh
  nimble-tpu-torch ... --num-processes N --process-id I
                   (--coordinator HOST:PORT | --init-method file://PATH)

``--engine`` picks each library's engine, as in the JAX package's CLI:

- ``device`` (default): a ``TorchAlignEngine`` on ``--device`` (default
  ``cuda``) with the walk kernel ``--walk`` (the reference's
  ``NIMBLE_PALLAS=fused|walk``);
- ``host``: the NumPy oracle ``core.calls.HostAlignEngine``, which needs no
  card and ignores ``--device``;
- ``mesh``: a ``TorchMeshAlignEngine`` over the ranks that ``torchrun``
  starts, one process each (``parallel.mesh``: ``model = 2`` when the
  world size is even and above 1, ``data = N / model``).  Every rank loads
  the libraries; rank 0 runs the pipeline, alone prints and writes the
  outputs, and stops the other ranks, which serve its launches.  Without a
  ``torchrun`` environment the world is one rank, a (1, 1) mesh, which
  runs the single-device engine.  ``--init-method`` overrides ``env://``.

``--num-processes N`` (N > 1) runs one CLI per host, each with its own
``--process-id`` (``parallel.multihost``, the JAX CLI's multi-host mode):
every host joins a gloo process group at ``tcp://{--coordinator}``
(host:port of process 0), or at ``--init-method`` when given, and runs its
own pipeline over its share of the input.  FASTQ (one
``process_fastq_multihost`` per library): each host parses ~1/N of the
reads, routes them to their owner host by content hash, counts the reads
it owns and merges the counts; BAM (``process_bam_multihost``, needs the
native host library): each host aligns a contiguous range of UMI groups and
writes a gzip part that process 0 joins.  Process 0 alone writes each
output.  With ``--device cuda`` host process I takes card ``LOCAL_RANK %
cards`` (``I % cards`` without ``LOCAL_RANK``).  ``--engine device`` only:
the mesh is one controller over its own process group, and the host engine
has no compact or full interface.

All libraries go through one pipeline call.  FASTQ input runs through the
port's ``pipeline.fastq_pipeline.process``: the input is parsed once, and
several libraries share one stacked device pass per chunk (on a mesh, its
data-parallel stacked pass); host engines take the reference's per-library
``call`` path.  BAM input (10x scRNA-seq, written as gzipped forensic TSVs)
runs through the port's ``pipeline.bam_fast.process_fast`` with ``CORES -
1`` consumer threads, several libraries sharing one stacked pass when their
trim settings agree; when the native host library is missing or an engine
has no full interface (``--engine host``) it runs the slow
``pipeline.bam_pipeline.process`` over ``align_batch``.  Asking for CUDA on
a machine without it is an error, never a silent CPU run.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import torch

from nimble_tpu_torch import native
from nimble_tpu_torch.config import LibraryChemistry
from nimble_tpu_torch.core.calls import HostAlignEngine
from nimble_tpu_torch.index.build import build_index
from nimble_tpu_torch.library import get_reference_sequence_data, load_reference_library
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.models.mesh_aligner import TorchMeshAlignEngine
from nimble_tpu_torch.ops.compact import WALKS
from nimble_tpu_torch.parallel import multihost
from nimble_tpu_torch.parallel.mesh import Mesh, init_runtime, mesh_shape
from nimble_tpu_torch.pipeline import bam_pipeline
from nimble_tpu_torch.pipeline.bam_fast import process_fast
from nimble_tpu_torch.pipeline.fastq_pipeline import process


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nimble-tpu-torch",
        description=(
            "Fast, configurable sequence alignment tool on arbitrary "
            "reference libraries (PyTorch + CUDA)"
        ),
    )
    p.add_argument("-r", "--reference", action="append", required=True,
                   help="Reference library .json file(s)")
    p.add_argument("-o", "--output", action="append", required=True,
                   help="Output TSV file name(s)")
    p.add_argument("-i", "--input", action="append", required=True,
                   help=".fastq.gz/.fastq file(s), or a single .bam file")
    p.add_argument("-c", "--cores", type=int, default=1, dest="num_cores",
                   help="Number of cores to use during alignment")
    p.add_argument("-f", "--strand_filter", default="unstranded",
                   help='One of "unstranded" (default), "fiveprime", '
                        '"threeprime", "none"')
    p.add_argument("-t", "--trim", default=None,
                   help="TARGET_LENGTH:STRICTNESS per library, comma-separated")
    p.add_argument("-p", "--force_bam_paired", action="store_true",
                   help="Skip alignment of unpaired reads in a .bam")
    p.add_argument("--no-parity-quirks", action="store_true",
                   help="Disable reproduction of reference output quirks "
                        "(e.g. dropping the final UMI group of a BAM)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the alignment engine (default cuda)")
    p.add_argument("--walk", choices=WALKS, default="fused",
                   help="walk kernel: fused span walk (default) or the "
                        "double walk over precomputed masks")
    p.add_argument("--engine", choices=("device", "host", "mesh"),
                   default="device",
                   help="alignment engine: single-device on --device "
                        "(default); host, the NumPy oracle, which needs no "
                        "card and ignores --device; or mesh, the data x "
                        "model mesh over the ranks torchrun starts")
    p.add_argument("--init-method", default=None,
                   help="torch.distributed init method of --engine mesh "
                        "(default env://, as torchrun sets it) or of a "
                        "multi-host run (default tcp://COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-host mode: total processes; run one CLI per "
                        "host with matching --process-id")
    p.add_argument("--process-id", type=int, default=None,
                   help="This host's process index (multi-host mode)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for torch.distributed "
                        "(multi-host mode)")
    return p


def main(argv: List[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if (args.engine != "host" and args.device == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit(
            "--device cuda was requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU")
    if len(args.output) != len(args.reference):
        raise SystemExit(
            "The number of output files does not match the number of "
            "reference libraries")

    trim_pairs = []
    if args.trim:
        for part in args.trim.split(","):
            length_s, strict_s = part.split(":")
            trim_pairs.append((int(length_s), float(strict_s)))
        if len(trim_pairs) != len(args.reference):
            raise SystemExit(
                "The number of trim options does not match the number of "
                "reference libraries"
            )

    first = args.input[0].lower()
    is_bam = first.endswith(".bam")
    if not (is_bam or first.endswith(".fastq") or first.endswith(".fastq.gz")):
        ext = first.rsplit(".", 1)[-1] if "." in first else ""
        raise SystemExit(f"Unsupported file format: {ext}")

    if args.num_processes is not None and args.num_processes > 1:
        return _run_multihost(args, trim_pairs, is_bam)
    if args.engine != "mesh":
        return _run(args, trim_pairs, is_bam, None)
    runtime = init_runtime(args.device,
                           init_method=args.init_method or "env://")
    ok = False
    try:
        rc = _run(args, trim_pairs, is_bam,
                  Mesh(runtime, *mesh_shape(runtime.world_size)))
        ok = True
        return rc
    finally:
        runtime.close(ok)


def _run_multihost(args, trim_pairs, is_bam: bool) -> int:
    """One host of a multi-host run: join the hosts' process group, build
    every library's engine on this host's device and run the multi-host
    pipeline (``nimble_tpu.cli``'s ``--num-processes`` branches)."""
    n = args.num_processes
    if args.process_id is None or not 0 <= args.process_id < n:
        raise SystemExit(f"--num-processes {n} needs --process-id in "
                         f"[0, {n})")
    if args.coordinator is None and args.init_method is None:
        raise SystemExit("--num-processes needs --coordinator HOST:PORT (or "
                         "--init-method)")
    if args.engine == "mesh":
        raise SystemExit(
            "--engine mesh cannot run with --num-processes > 1: the mesh is "
            "one controller over every rank of its own process group, while "
            "a multi-host run is one pipeline per host; use --engine device")
    if is_bam and not (native.available() and args.engine == "device"):
        raise SystemExit(
            "multi-host BAM mode requires the native host library "
            "(nimble_tpu_torch/csrc/nimble_host.cpp, built with g++ at first "
            "use) and a device engine (got --engine host or no native build)")
    if args.engine == "host":
        raise SystemExit(
            "multi-host FASTQ mode requires a device engine: --engine host "
            "has no compact interface to count the owned reads with")
    device = torch.device(args.device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", args.process_id))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    multihost.initialize(args.coordinator, n, args.process_id,
                         init_method=args.init_method)
    try:
        engines, references, configs = _libraries(
            args, trim_pairs, lambda index, cfg: TorchAlignEngine(
                index, cfg, device=device, walk=args.walk), print)
        print("Loading read sequences and aligning")
        if is_bam:
            print("Processing as BAM file (multi-host)")
            multihost.process_bam_multihost(
                args.input[0], engines, references, configs, args.output,
                args.force_bam_paired, n_hosts=n, host_id=args.process_id,
                parity_quirks=not args.no_parity_quirks)
        else:
            print("Processing as FASTQ file (multi-host)")
            mate = args.input[1] if len(args.input) > 1 else None
            for engine, reference, cfg, out in zip(engines, references,
                                                   configs, args.output):
                multihost.process_fastq_multihost(
                    args.input[0], engine, reference, cfg, out,
                    mate_path=mate, n_hosts=n, host_id=args.process_id)
    finally:
        multihost.shutdown()
    print("Alignment successful, terminating.")
    return 0


def _libraries(args, trim_pairs, make_engine, say):
    """(engines, references, configs) of every ``-r`` library, in order,
    each engine ``make_engine(index, config)``."""
    strand_filter = LibraryChemistry.from_cli(args.strand_filter)
    engines, references, configs = [], [], []
    for i, path in enumerate(args.reference):
        say(f"Loading and preprocessing reference data for {path}")
        aligner_config, reference = load_reference_library(path, strand_filter)
        if i < len(trim_pairs):
            length, strictness = trim_pairs[i]
            aligner_config.trim_target_length = length
            aligner_config.trim_strictness = strictness
            say(
                f"Manually setting trim settings for library {path} | "
                f"target length: {length}, strictness: {strictness}"
            )
        seqs, _names = get_reference_sequence_data(reference)
        index = build_index(seqs, num_threads=args.num_cores)
        engines.append(make_engine(index, aligner_config))
        references.append(reference)
        configs.append(aligner_config)
    return engines, references, configs


def _run(args, trim_pairs, is_bam: bool, mesh) -> int:
    """Build every library's engine; then, on the controller (every rank
    but a mesh's serving ones), run the pipeline."""
    serving = mesh is not None and not mesh.runtime.is_controller

    def make_engine(index, cfg):
        if args.engine == "host":
            return HostAlignEngine(index, cfg)
        if args.engine == "mesh":
            return TorchMeshAlignEngine(index, cfg, mesh=mesh, walk=args.walk)
        return TorchAlignEngine(index, cfg, device=args.device,
                                walk=args.walk)

    engines, references, configs = _libraries(
        args, trim_pairs, make_engine,
        (lambda *a, **k: None) if serving else print)
    if serving:
        mesh.runtime.serve()
        return 0

    print("Loading read sequences and aligning")
    if not is_bam:
        print("Processing as FASTQ file")
        process(args.input, engines, references, configs, args.output)
    elif native.available() and all(hasattr(e, "full_dispatch")
                                    for e in engines):
        print("Processing as BAM file")
        process_fast(args.input, engines, references, configs, args.output,
                     args.num_cores, args.force_bam_paired,
                     parity_quirks=not args.no_parity_quirks)
    else:
        print("Processing as BAM file")
        if not native.available():
            print("The native host library (nimble_tpu_torch/csrc/"
                  "nimble_host.cpp, built with g++ at first use) is not "
                  "available: running the slow BAM pipeline")
        bam_pipeline.process(args.input, engines, references, configs,
                             args.output, args.num_cores,
                             args.force_bam_paired,
                             parity_quirks=not args.no_parity_quirks)

    print("Alignment successful, terminating.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
