"""The full-output device pass: packed reads -> probe -> walk -> (B, 3).

Counterpart: ``engine_fast._probe_walk_full_impl`` (reached through
``probe_walk_full_packed_chunked``, the BAM path's kernel) and
``unpack_full_packed``.  No filter gate runs on the device: the host applies
the exact f64 gates at collect (``TorchAlignEngine.full_collect``).  The
result layout is the JAX engine's:

  column 0: the anchor's postings start
  column 1: live-lane mask | has_anchor << 16 | overflow << 17
  column 2: score << 16 | mismatches (both < 2^16: reads cap at 1024 bp)

where overflow is the host-rescue flag: more anchor postings than ``c_max``,
or a fingerprint collision.  ``walk="fused"`` is one launch of the
``probe_walk_filter`` kernel in its full mode (``ops.probe_walk.probe_walk``
without gates, ``csrc/probe_walk_filter.cu``); its plain twin
:func:`probe_walk_full_plain` is this module's chain of torch ops, which the
kernel's wrapper runs for CPU tensors.  ``walk="double"`` runs the chain
around the double-walk kernel.  :func:`probe_walk_full_multi` serves
stacked libraries in one pass (``probe_walk_full_packed_multi_chunked``).
"""

from __future__ import annotations

import numpy as np
import torch

from nimble_tpu_torch.ops.compact import (
    check_c_max,
    check_walk,
    every_library,
    live_mask,
    probe_candidates,
    walk_candidates,
)
from nimble_tpu_torch.ops.device_tables import IndexTables, StackedTables
from nimble_tpu_torch.ops.probe_walk import probe_walk


def probe_walk_full(packed: torch.Tensor, t: IndexTables, *, bucket: int,
                    c_max: int, walk: str = "fused") -> torch.Tensor:
    """One launch of (B, ceil(bucket/4) + 2) uint8 packed reads -> (B, 3)
    int32 full results.  ``walk="fused"`` launches the ``probe_walk_filter``
    kernel (on CPU tensors its plain twin :func:`probe_walk_full_plain`);
    ``walk="double"`` runs the chain around the double walk
    (``compact.walk_candidates``).  Stacked tables serve every row against
    every library, ``(L*B, 3)`` library major."""
    check_c_max(c_max)
    check_walk(walk)
    if walk == "fused":
        return probe_walk(packed, t, bucket=bucket, c_max=c_max)
    return _full_chain(packed, t, bucket=bucket, c_max=c_max, walk=walk)


def probe_walk_full_plain(packed: torch.Tensor, t: IndexTables, *,
                          bucket: int, c_max: int) -> torch.Tensor:
    """The ``probe_walk_filter`` kernel's plain twin in its full mode:
    :func:`probe_walk_full` with ``walk="fused"`` as a chain of torch ops
    that launches no kernel on any device."""
    check_c_max(c_max)
    return _full_chain(packed, t, bucket=bucket, c_max=c_max, walk="plain")


def _full_chain(packed, t, *, bucket, c_max, walk):
    """Probe, walk (``compact.walk_candidates``), pack."""
    packed, lib = every_library(packed, t)
    cand = probe_candidates(packed, t, bucket=bucket, c_max=c_max, lib=lib)
    live, score, mm = walk_candidates(cand, t, bucket=bucket, walk=walk)
    col1 = (live_mask(live)
            | (cand.has_anchor.to(torch.int64) << 16)
            | (cand.needs_host.to(torch.int64) << 17))
    col2 = (score.to(torch.int64) << 16) | mm
    return torch.stack([cand.astart.to(torch.int32), col1.to(torch.int32),
                        col2.to(torch.int32)], dim=1)


def probe_walk_full_multi(packed: torch.Tensor, st: StackedTables, *,
                          bucket: int, c_max: int,
                          walk: str = "fused") -> torch.Tensor:
    """One launch of packed reads against every stacked library -> (L, B, 3)
    int32: one kernel launch for all libraries with ``walk="fused"``, one
    chain over the rows repeated per library with ``walk="double"``."""
    out = probe_walk_full(packed, st, bucket=bucket, c_max=c_max, walk=walk)
    return out.reshape(st.n_libraries, packed.shape[0], 3)


def unpack_full_packed(packed: np.ndarray) -> dict:
    """Host-side unpack of the (B, 3) int32 full result."""
    col1 = packed[:, 1]
    col2 = packed[:, 2]
    return {
        "astart": packed[:, 0].astype(np.int64),
        "mask": (col1 & 0xFFFF).astype(np.int32),
        "has_anchor": (col1 & (1 << 16)) != 0,
        "overflow": (col1 & (1 << 17)) != 0,
        "score": (col2 >> 16).astype(np.int32),
        "mismatches": (col2 & 0xFFFF).astype(np.int32),
    }
