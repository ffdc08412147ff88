"""The compact device pass: packed reads -> probe -> walk -> filters -> (B, 2).

Counterpart: ``engine_fast._probe_walk_filter_impl`` (the candidate-major
branch that ``use_pallas="fused"`` and ``use_pallas=True`` run, selected
here by ``walk="fused"`` / ``walk="double"``), the packed-row unpack of
``probe_walk_filter_packed_chunked``, and ``unpack_compact`` with its
``COMPACT_*`` bits.  The result layout is the JAX engine's: column 0 is the
anchor's postings start, column 1 the live-lane mask | passed << 16 |
needs_host << 17 | has_anchor << 18.  The entropy gate is not applied here:
the host evaluates it in exact f64 at collect.

``walk="fused"`` is one launch of the ``probe_walk_filter`` kernel
(``ops.probe_walk.probe_walk``, ``csrc/probe_walk_filter.cu``: probe,
candidates, walk, filter and pack); its plain twin
:func:`probe_walk_filter_plain` is this module's chain of torch ops
(:func:`probe_candidates`, the fused walk's plain version, the filter and
the pack), which the kernel's wrapper runs for CPU tensors.
``walk="double"`` runs the same chain around the double-walk kernel.

Stacked libraries (``device_tables.StackedTables``) run through the same
functions, every row against every library (L*B results, library major):
:func:`probe_walk_filter_multi` serves one launch's packed reads against
all L libraries in one launch (the counterpart of
``probe_walk_filter_packed_multi_chunked``'s vmap).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from nimble_tpu_torch.ops.device_tables import (
    FilterScalars,
    IndexTables,
    StackedTables,
    take,
)
from nimble_tpu_torch.ops.probe import probe_bucketed
from nimble_tpu_torch.ops.probe_walk import probe_walk
from nimble_tpu_torch.ops.span_walk import (
    fused_span_walk,
    span_walk_plain,
    span_walk_rel,
    unpack_reads,
)

WALKS = ("fused", "double")
# walk_candidates also takes "plain": the fused walk's plain version, which
# launches no kernel on any device (the chain of probe_walk_filter_plain)
_CANDIDATE_WALKS = WALKS + ("plain",)
COMPACT_MASK_BITS = 16
COMPACT_PASSED_BIT = 1 << 16
COMPACT_NEEDS_HOST_BIT = 1 << 17
COMPACT_HAS_ANCHOR_BIT = 1 << 18


@dataclass(frozen=True)
class Candidates:
    """What the probe hands the walk, per read of one launch."""

    packed: torch.Tensor       # (B, ceil(bucket/4) + 2) uint8 read rows
    reads: torch.Tensor        # (B, bucket) int32 codes
    read_lens: torch.Tensor    # (B,) int32
    has_anchor: torch.Tensor   # (B,) bool
    anchor: torch.Tensor       # (B,) int64 read position of the anchor
    astart: torch.Tensor       # (B,) int32 anchor postings start
    needs_host: torch.Tensor   # (B,) bool: postings overflow or fp_bad
    rows: torch.Tensor         # (B, c_max) int64 candidate row ids
    offs: torch.Tensor         # (B, c_max) int64 anchor offset in the row
    live0: torch.Tensor        # (B, c_max) bool real candidate lanes
    lib: Optional[torch.Tensor] = None  # (B,) int64 library (stacked tables)


def live_mask(live: torch.Tensor) -> torch.Tensor:
    """(B, C) bool live lanes -> (B,) int64 bit mask (lane c at bit c)."""
    c_idx = torch.arange(live.shape[1], device=live.device)
    return torch.where(live, 1 << c_idx, 0).sum(dim=1)


def probe_candidates(packed: torch.Tensor, t: IndexTables, *, bucket: int,
                     c_max: int, lib=None) -> Candidates:
    """Unpack, probe, and gather up to ``c_max`` postings per anchor.  With
    stacked tables, ``lib`` (B,) int64 names each row's library; postings
    indices clamp to the padded common extent, as under the JAX vmap, and
    ``astart`` stays in the row's own library's postings."""
    reads, read_lens = unpack_reads(packed, bucket)
    has_anchor, anchor, bucket_sel, lane_sel, fp_bad = probe_bucketed(
        reads, read_lens, t, p_limit=bucket - t.k + 1, lib=lib)
    astart = take(t.bstart, lib, bucket_sel, lane_sel)
    acnt = torch.where(has_anchor, take(t.bcount, lib, bucket_sel, lane_sel),
                       0)
    c_idx = torch.arange(c_max, device=packed.device)
    pidx = (astart.to(torch.int64)[:, None] + c_idx).clamp(
        0, t.postings_row.shape[-1] - 1)
    return Candidates(
        packed=packed, reads=reads, read_lens=read_lens, has_anchor=has_anchor,
        anchor=anchor, astart=astart,
        needs_host=(has_anchor & (acnt > c_max)) | fp_bad,
        rows=take(t.postings_row, lib, pidx).to(torch.int64),
        offs=take(t.postings_off, lib, pidx).to(torch.int64),
        live0=c_idx[None, :] < acnt.clamp(max=c_max)[:, None],
        lib=lib,
    )


def check_walk(walk: str) -> None:
    if walk not in WALKS:
        raise ValueError(f"walk={walk!r} is not one of {WALKS}")


def check_c_max(c_max: int) -> None:
    if not 1 <= c_max <= COMPACT_MASK_BITS:
        raise ValueError(f"c_max={c_max} must be in [1, {COMPACT_MASK_BITS}]: "
                         "the results pack the live lanes in 16 bits")


def walk_candidates(cand: Candidates, t: IndexTables, *, bucket: int,
                    walk: str):
    """Span walk of the probed candidates; returns (live (B, c_max) bool,
    score, mm (B,) int32) with ``score`` counting the anchor k-mer and both
    zero for reads without an anchor.

    ``walk="fused"`` is the fused span-walk kernel (``use_pallas="fused"``
    in the JAX engine; the mesh's shard step); ``walk="plain"`` its plain
    version ``span_walk_plain`` on any device; ``walk="double"`` builds the
    relative-coordinate masks and runs the double-walk kernel
    (``use_pallas=True``), with ``l_steps = min(p_limit - 1, bucket - k)``
    as the JAX engine sets it.  All give the same bits.
    """
    if walk not in _CANDIDATE_WALKS:
        raise ValueError(f"walk={walk!r} is not one of {_CANDIDATE_WALKS}")
    if walk in ("fused", "plain"):
        walker = fused_span_walk if walk == "fused" else span_walk_plain
        live, walk_score, walk_mm = walker(
            cand.packed, cand.anchor, cand.rows, cand.offs, cand.live0, t,
            bucket=bucket, lib=cand.lib)
    else:
        p_limit = bucket - t.k + 1
        live, walk_score, walk_mm = span_walk_rel(
            cand.reads, cand.read_lens, cand.anchor, cand.rows, cand.offs,
            cand.live0, t, l_steps=min(p_limit - 1, bucket - t.k),
            lib=cand.lib)
    score = torch.where(cand.has_anchor, walk_score + t.k, 0)
    mm = torch.where(cand.has_anchor, walk_mm, 0)
    return live, score, mm


def probe_walk_filter(packed: torch.Tensor, t: IndexTables,
                      scalars: FilterScalars, s_min: torch.Tensor, *,
                      bucket: int, c_max: int,
                      walk: str = "fused") -> torch.Tensor:
    """One launch of packed reads -> (B, 2) int32 compact results.

    ``s_min`` is the device copy of ``device_tables.s_min_table(...,
    bucket)``; ``c_max`` candidate lanes (<= 16) are walked per read and
    reads whose anchor has more postings go to host rescue.  ``walk="fused"``
    launches the ``probe_walk_filter`` kernel (``ops.probe_walk``; on CPU
    tensors its plain twin :func:`probe_walk_filter_plain`);
    ``walk="double"`` runs the chain around the double walk.  With stacked
    tables, ``scalars`` holds ``(L,)`` gates, ``s_min`` is ``(L, bucket +
    1)`` and every row is served against every library, ``(L*B, 2)``
    library major.
    """
    check_c_max(c_max)
    check_walk(walk)
    if walk == "fused":
        return probe_walk(packed, t, bucket=bucket, c_max=c_max,
                          scalars=scalars, s_min=s_min)
    return _filter_chain(packed, t, scalars, s_min, bucket=bucket,
                         c_max=c_max, walk=walk)


def probe_walk_filter_plain(packed: torch.Tensor, t: IndexTables,
                            scalars: FilterScalars, s_min: torch.Tensor, *,
                            bucket: int, c_max: int) -> torch.Tensor:
    """The ``probe_walk_filter`` kernel's plain twin: :func:`probe_walk_filter`
    with ``walk="fused"`` as a chain of torch ops that launches no kernel
    on any device."""
    check_c_max(c_max)
    return _filter_chain(packed, t, scalars, s_min, bucket=bucket,
                         c_max=c_max, walk="plain")


def every_library(packed: torch.Tensor, t: IndexTables):
    """(rows, lib) of a pass: with stacked tables, the rows repeated once
    per library with their (L*B,) library index (library major); with one
    library's tables, the rows and None."""
    if t.bkey_fp.dim() == 3:
        L, B = t.bkey_fp.shape[0], packed.shape[0]
        return packed.repeat(L, 1), library_rows(L, B, packed.device)
    return packed, None


def _filter_chain(packed, t, scalars, s_min, *, bucket, c_max, walk):
    """Probe, walk (``walk_candidates``), distinct count, gates, pack."""
    packed, lib = every_library(packed, t)
    cand = probe_candidates(packed, t, bucket=bucket, c_max=c_max, lib=lib)
    has_anchor, rows = cand.has_anchor, cand.rows
    live, score, mm = walk_candidates(cand, t, bucket=bucket, walk=walk)

    # distinct live rows: a live lane counts unless an earlier live lane
    # holds the same row
    c_idx = torch.arange(c_max, device=packed.device)
    earlier = c_idx[:, None] > c_idx[None, :]
    dup = ((rows[:, :, None] == rows[:, None, :])
           & live[:, :, None] & live[:, None, :] & earlier).any(dim=2)
    distinct = (live & ~dup).sum(dim=1)
    mask = live_mask(live)

    read_lens = cand.read_lens
    s_min_len = take(s_min, lib,
                     read_lens.clamp(0, s_min.shape[-1] - 1).to(torch.int64))
    gates = (scalars.score_threshold, scalars.num_mismatches,
             scalars.discard_multiple, scalars.discard_nonzero)
    if lib is not None:
        gates = tuple(g[lib] for g in gates)
    threshold, mismatches, discard_multiple, discard_nonzero = gates
    passed = (
        has_anchor
        & (score >= threshold)
        & (score >= s_min_len)
        & (mm <= mismatches)
        & ((distinct <= 1) | ~torch.as_tensor(discard_multiple))
        & ((mm == 0) | ~torch.as_tensor(discard_nonzero))
    )
    needs_host = cand.needs_host

    flags = (
        mask
        | ((passed & ~needs_host).to(torch.int64) << 16)
        | (needs_host.to(torch.int64) << 17)
        | (has_anchor.to(torch.int64) << 18)
    )
    return torch.stack(
        [cand.astart.to(torch.int32), flags.to(torch.int32)], dim=1)


def library_rows(n_libraries: int, B: int, device) -> torch.Tensor:
    """(L*B,) int64 library index of L copies of a B-row launch, library
    major: rows ``l*B .. l*B + B - 1`` belong to library ``l``."""
    return torch.arange(n_libraries, device=device).repeat_interleave(B)


def probe_walk_filter_multi(packed: torch.Tensor, st: StackedTables, *,
                            bucket: int, c_max: int,
                            walk: str = "fused") -> torch.Tensor:
    """One launch of (B, ceil(bucket/4) + 2) packed reads against every
    stacked library -> (L, B, 2) int32, library l's rows in its own combo-id
    space: ``probe_walk_filter_packed_multi_chunked``.  One kernel launch
    for all libraries with ``walk="fused"``, one chain over the rows
    repeated per library with ``walk="double"``."""
    out = probe_walk_filter(packed, st, st.scalars, st.s_min(bucket),
                            bucket=bucket, c_max=c_max, walk=walk)
    return out.reshape(st.n_libraries, packed.shape[0], 2)


def unpack_compact(packed: np.ndarray) -> dict:
    """Host-side unpack of the (B, 2) int32 compact result."""
    flags = packed[:, 1]
    return {
        "astart": packed[:, 0].astype(np.int64),
        "mask": (flags & (COMPACT_PASSED_BIT - 1)).astype(np.int32),
        "passed": (flags & COMPACT_PASSED_BIT) != 0,
        "needs_host": (flags & COMPACT_NEEDS_HOST_BIT) != 0,
        "has_anchor": (flags & COMPACT_HAS_ANCHOR_BIT) != 0,
    }
