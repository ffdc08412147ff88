"""nimble_tpu_torch — the PyTorch + CUDA port of nimble_tpu.

Everything ``nimble_tpu`` runs, on a torch device: FASTQ counting and the
BAM forensic path over one library or several in one stacked pass, the
``align_batch`` interface, the data x model mesh and multi-host runs on
``torch.distributed``, the ``__graft_entry__.py`` hooks, the bench and the
differential fuzz campaigns.  The device compute (anchor probe, span walk,
on-device filters, packed results) runs as hand-written CUDA kernels for
Hopper (``csrc/*.cu``; on one device the whole pass is one launch of
``csrc/probe_walk_filter.cu``) and torch ops around them, each kernel with a
plain torch version that the CPU runs.  Everything around it — library
loading, the host index build, FASTQ and BAM parsing, the dedupe/count tail,
host rescue, the forensic row assembly and the writers, and the C++ host
library (``csrc/nimble_host.cpp``, built by ``native``) — is the port's own
copy of the JAX package's host code, held to it byte for byte by the tests.
This package imports neither jax nor ``nimble_tpu``.

Package layout:
  ops/hashing        — uint32 hash, fingerprint and rolling k-mer keys
  ops/device_index   — the bucketed index as numpy arrays (host build)
  ops/device_tables  — the bucketed index and filter scalars as torch
                       tensors, one library or several stacked
  ops/probe          — the fingerprint anchor probe (torch ops)
  ops/probe_walk     — the whole pass in one kernel: probe, candidates,
                       walk, filter and pack (kernel wrapper of
                       csrc/probe_walk_filter.cu and its plain twin)
  ops/span_walk      — word gather + the fused span walk (kernel wrapper
                       of csrc/fused_span_walk.cu and its plain version)
  ops/double_walk    — the walk over precomputed masks (kernel wrapper of
                       csrc/double_walk.cu and its plain version)
  ops/compact        — packed reads -> probe -> walk -> filters -> (B, 2)
                       (the kernel's plain twin is its chain)
  ops/full           — packed reads -> probe -> walk -> (B, 3), the BAM
                       path's full-output pass (likewise)
  ops/gather         — the gather-probe kernels of csrc/gather_rows.cu
                       (take, taa, lane) and their plain versions
  ops/_build         — nvcc build-at-first-use + ctypes loading
  models/aligner     — TorchAlignEngine: the compact and full interfaces
                       and align_batch
  models/multi_aligner — the stacked multi-library dispatcher
  models/mesh_aligner — TorchMeshAlignEngine over a data x model mesh
  parallel/mesh      — the mesh of ranks on torch.distributed, one
                       controller ordering every collective
  parallel/sharded_index, parallel/sharded_fast — the table split over the
                       model axis, and one rank's step on its shard
  parallel/multihost — multi-host runs: one pipeline per host, meeting on
                       a gloo group
  pipeline           — FASTQ counting, the BAM forensic path (fast and the
                       reference-shaped slow pipeline)
  config, library, index, core, io, utils, native — host code: settings,
                       library JSON, k-mer index, alignment semantics and
                       the NumPy oracle, readers and writers, C++ host ops
  cli                — command line interface: FASTQ and BAM, on one
                       device, on a mesh (--engine mesh) or multi-host
                       (--num-processes)
  bench              — the throughput benchmark (the root bench.py's modes)
  graft_entry        — entry() and dryrun_multichip(), the hooks of
                       __graft_entry__.py
  probe_gather       — the gather probe (scripts/probe_mosaic_gather.py)
  workload           — seeded library, FASTQ and BAM workloads on disk
  fuzz               — the differential fuzz campaigns (engine, FASTQ,
                       BAM), each an entry: python -m
                       nimble_tpu_torch.fuzz.{differential,fastq,bam}
"""

__version__ = "0.1.0"

from nimble_tpu_torch.config import (  # noqa: F401
    AlignFilterConfig,
    FilterReason,
    IntersectLevel,
    LibraryChemistry,
    PairState,
    AlignmentOrientation,
)
from nimble_tpu_torch.library import Reference, load_reference_library  # noqa: F401
