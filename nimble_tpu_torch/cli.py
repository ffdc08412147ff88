"""Command line interface of the torch port: FASTQ counting and BAM input.

The surface of ``nimble_tpu.cli`` (the reference CLI's flags):

  nimble-tpu-torch -r lib.json [-r lib2.json ...] -i reads.fastq[.gz]
                   [-i mates.fastq] -o out.tsv [-o out2.tsv ...]
                   [-c CORES] [-f STRAND_FILTER] [-t LEN:STRICT,...]
                   [--device cuda|cpu] [--walk fused|double]
  nimble-tpu-torch -r lib.json [-r lib2.json ...] -i reads.bam
                   -o out.tsv.gz [-o out2.tsv.gz ...]
                   [-c CORES] [-p] [--no-parity-quirks] [...]

Every library gets a ``TorchAlignEngine`` on ``--device`` (default
``cuda``) with the walk kernel ``--walk`` (the reference's
``NIMBLE_PALLAS=fused|walk``), and all libraries go through one pipeline
call, as in the JAX package's CLI.  FASTQ input runs through the port's
``pipeline.fastq_pipeline.process``: the input is parsed once, and several
libraries share one stacked device pass per chunk.  BAM input (10x
scRNA-seq, written as gzipped forensic TSVs) runs through the port's
``pipeline.bam_fast.process_fast`` with ``CORES - 1`` consumer threads;
several libraries share one stacked pass when their trim settings agree.
BAM input needs the native host library.  Asking for CUDA on a machine
without it is an error, never a silent CPU run.  ``--engine mesh``
(multi-device) is not ported yet and exits with a message.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import torch

from nimble_tpu_torch import native
from nimble_tpu_torch.config import LibraryChemistry
from nimble_tpu_torch.index.build import build_index
from nimble_tpu_torch.library import get_reference_sequence_data, load_reference_library
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.ops.compact import WALKS
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
    p.add_argument("--engine", choices=("device", "mesh"), default="device",
                   help="single-device engine (default); mesh is not yet "
                        "ported")
    return p


def main(argv: List[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.engine == "mesh":
        raise SystemExit("--engine mesh is not yet ported to nimble_tpu_torch")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda was requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU")
    if len(args.output) != len(args.reference):
        raise SystemExit(
            "The number of output files does not match the number of "
            "reference libraries")

    strand_filter = LibraryChemistry.from_cli(args.strand_filter)
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
    if is_bam and not native.available():
        raise SystemExit(
            "BAM input needs the native host library "
            "(nimble_tpu_torch/csrc/nimble_host.cpp, built with g++ at first "
            "use), which is not available; the "
            "slow BAM pipeline is not yet ported to nimble_tpu_torch")

    engines, references, configs = [], [], []
    for i, path in enumerate(args.reference):
        print(f"Loading and preprocessing reference data for {path}")
        aligner_config, reference = load_reference_library(path, strand_filter)
        if i < len(trim_pairs):
            length, strictness = trim_pairs[i]
            aligner_config.trim_target_length = length
            aligner_config.trim_strictness = strictness
            print(
                f"Manually setting trim settings for library {path} | "
                f"target length: {length}, strictness: {strictness}"
            )
        seqs, _names = get_reference_sequence_data(reference)
        index = build_index(seqs, num_threads=args.num_cores)
        engines.append(TorchAlignEngine(index, aligner_config,
                                        device=args.device, walk=args.walk))
        references.append(reference)
        configs.append(aligner_config)

    print("Loading read sequences and aligning")
    if is_bam:
        print("Processing as BAM file")
        process_fast(args.input, engines, references, configs, args.output,
                     args.num_cores, args.force_bam_paired,
                     parity_quirks=not args.no_parity_quirks)
    else:
        print("Processing as FASTQ file")
        process(args.input, engines, references, configs, args.output)

    print("Alignment successful, terminating.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
