"""The whole device pass in one kernel: probe, candidates, walk, filter.

Counterpart: ``engine_fast.probe_walk_filter_packed_chunked`` (body
``_probe_walk_filter_impl``) and ``probe_walk_full_packed_chunked`` (body
``_probe_walk_full_impl``), each one device program per launch in the JAX
package: the XLA probe, the postings gather, ``pallas_fused_span_walk`` and
the XLA distinct / gate / pack epilogue.  :func:`probe_walk` launches
``csrc/probe_walk_filter.cu``, which does all of it for one launch of packed
reads: the compact ``(B, 2)`` int32 of ``ops.compact`` with ``scalars`` and
``s_min``, or the full ``(B, 3)`` of ``ops.full`` without them.  Its plain
version :func:`probe_walk_plain` is the torch chain of those modules
(``compact.probe_walk_filter_plain``, ``full.probe_walk_full_plain``:
``probe_candidates``, ``span_walk_plain``, the filter and the pack), bit for
bit.

Stacked tables (``device_tables.StackedTables``) serve the B packed rows
against every one of the L libraries: L*B results, library major (row
``l*B + b`` is packed row b against library l), without copying the rows.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import torch

from nimble_tpu_torch.ops import _build
from nimble_tpu_torch.ops.device_tables import (
    FilterScalars,
    IndexTables,
    TableLayout,
    check_tensor,
)

MAX_CANDIDATES = 16  # the results pack the live lanes in 16 bits
MAX_K = 32           # a key half of k/2 or k - k/2 bases fits 32 bits
MAX_INDEX = 2**31    # the kernel indexes in 32 bits
MAX_LIBRARIES = 65535  # the grid's y extent

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


class _ProbeTables(ctypes.Structure):
    """``struct ProbeTables`` of ``csrc/probe_walk_tables.h``, field for
    field: the kernel's argument block."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount",
            "postings_row", "postings_off", "ref", "row_starts",
            "row_lengths", "s_min", "threshold", "mismatches",
            "discard_multiple", "discard_nonzero")]
        + [("threshold0", ctypes.c_int64), ("mismatches0", ctypes.c_int64)]
        + [(name, ctypes.c_int32) for name in (
            "discard_multiple0", "discard_nonzero0", "L", "n_buckets", "W",
            "max_probe", "n_postings", "n_rows", "n_words", "s_len", "Lmax",
            "k", "ref_pad", "full")])


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load_library("probe_walk_filter")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.nimble_probe_walk_filter.argtypes = [
                ctypes.POINTER(_ProbeTables), vp, vp, ci, ci, vp]
            lib.nimble_probe_walk_filter.restype = ci
            lib.nimble_cuda_error_string.argtypes = [ci]
            lib.nimble_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


_TABLES = ("bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount",
           "postings_row", "postings_off", "ref_codes_packed", "row_starts",
           "row_lengths")


def _check_packed(packed, bucket: int) -> None:
    if packed.dim() != 2 or packed.dtype != torch.uint8 \
            or packed.shape[1] != (bucket + 3) // 4 + 2:
        raise ValueError(
            f"packed: expected (B, {(bucket + 3) // 4 + 2}) torch.uint8, got "
            f"{tuple(packed.shape)} {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")


def _check_c_max(c_max: int) -> None:
    if not 1 <= c_max <= MAX_CANDIDATES:
        raise ValueError(f"c_max={c_max} not in [1, {MAX_CANDIDATES}]")


def _block(layout: TableLayout, t: IndexTables, scalars, s_min,
           bucket: int):
    """The kernel's argument block for (bucket, mode) with these gates,
    checked and built on first use and kept in the tables' ``layout``
    (built anew for other gate objects).  Raises ValueError on what the
    kernel does not take."""
    full = scalars is None
    key = (bucket, full)
    cached = layout.blocks.get(key)
    if cached is not None and cached[1] is scalars and cached[2] is s_min:
        return cached[0]
    if not 2 <= t.k <= MAX_K or t.k >= bucket:
        raise ValueError(f"k={t.k} must lie in [2, {MAX_K}] and below "
                         f"bucket={bucket}")
    lead = (layout.n_libraries,) if layout.stacked else ()
    if (scalars is None) != (s_min is None):
        raise ValueError("scalars and s_min come together (compact mode) "
                         "or not at all (full mode)")
    nw = (bucket + 15) // 16 + 1
    if t.ref_codes_packed.shape[-1] < nw:
        raise ValueError(f"ref_codes_packed {tuple(t.ref_codes_packed.shape)}"
                         f": want >= {nw} words")
    if s_min is not None:
        if s_min.dim() != len(lead) + 1 or s_min.shape[-1] < 1:
            raise ValueError(f"s_min: {tuple(s_min.shape)}, want "
                             f"{lead + ('n',)}")
        check_tensor("s_min", s_min, tuple(s_min.shape), torch.int32,
                     layout.device)
        if layout.stacked:
            for name, dtype in (("score_threshold", torch.int32),
                                ("num_mismatches", torch.int32),
                                ("discard_multiple", torch.bool),
                                ("discard_nonzero", torch.bool)):
                x = getattr(scalars, name)
                if not isinstance(x, torch.Tensor):
                    raise ValueError(f"scalars.{name}: stacked tables take "
                                     f"(L,) tensors, got {type(x).__name__}")
                check_tensor(f"scalars.{name}", x, (layout.n_libraries,),
                             dtype, layout.device)
    block = _ProbeTables()
    if layout.device.type == "cuda":
        _fill_block(block, layout, t, scalars, s_min, bucket)
    layout.blocks[key] = (block, scalars, s_min)
    return block


def _fill_block(block, layout: TableLayout, t: IndexTables, scalars, s_min,
                bucket: int) -> None:
    """The kernel's own refusals (ValueError), then the block's fields."""
    n_buckets, W = layout.n_buckets, layout.lanes
    if W % 4 or not 4 <= W <= 32 or t.bkey_fp.data_ptr() % 16:
        raise ValueError(
            f"bkey_fp: the kernel loads a bucket row as 16-byte vectors: "
            f"want W a multiple of 4 in [4, 32] and a 16-byte aligned "
            f"table, got W={W} at {t.bkey_fp.data_ptr():#x}")
    big = [name for name in _TABLES if getattr(t, name).numel() >= MAX_INDEX]
    if s_min is not None and s_min.numel() >= MAX_INDEX:
        big.append("s_min")
    if big:
        raise ValueError(f"{', '.join(big)}: 2^31 elements or more; the "
                         f"kernel indexes in 32 bits")
    if layout.n_libraries > MAX_LIBRARIES:
        raise ValueError(f"{layout.n_libraries} libraries: the kernel takes "
                         f"at most {MAX_LIBRARIES}")
    for name in _TABLES:
        setattr(block, "ref" if name == "ref_codes_packed" else name,
                getattr(t, name).data_ptr())
    if s_min is not None:
        block.s_min = s_min.data_ptr()
        block.s_len = s_min.shape[-1]
        if layout.stacked:
            block.threshold = scalars.score_threshold.data_ptr()
            block.mismatches = scalars.num_mismatches.data_ptr()
            block.discard_multiple = scalars.discard_multiple.data_ptr()
            block.discard_nonzero = scalars.discard_nonzero.data_ptr()
        else:
            block.threshold0 = int(scalars.score_threshold)
            block.mismatches0 = int(scalars.num_mismatches)
            block.discard_multiple0 = int(bool(scalars.discard_multiple))
            block.discard_nonzero0 = int(bool(scalars.discard_nonzero))
    block.L = layout.n_libraries
    block.n_buckets = n_buckets
    block.W = W
    block.max_probe = t.max_probe
    block.n_postings = t.postings_row.shape[-1]
    block.n_rows = t.row_starts.shape[-1]
    block.n_words = t.ref_codes_packed.shape[-1]
    block.Lmax = bucket
    block.k = t.k
    block.ref_pad = t.ref_pad
    block.full = int(s_min is None)


def probe_walk_plain(packed, t: IndexTables, *, bucket: int, c_max: int,
                     scalars: Optional[FilterScalars] = None,
                     s_min=None) -> torch.Tensor:
    """Plain torch version of :func:`probe_walk` (same arguments and
    result): the chain of ``ops.compact`` / ``ops.full`` with the fused
    walk's plain version; it launches no kernel on any device."""
    # the chain's modules import this one: imported here, not at the top
    from nimble_tpu_torch.ops.compact import probe_walk_filter_plain
    from nimble_tpu_torch.ops.full import probe_walk_full_plain

    if scalars is None:
        return probe_walk_full_plain(packed, t, bucket=bucket, c_max=c_max)
    return probe_walk_filter_plain(packed, t, scalars, s_min, bucket=bucket,
                                   c_max=c_max)


def probe_walk(packed, t: IndexTables, *, bucket: int, c_max: int,
               scalars: Optional[FilterScalars] = None,
               s_min=None) -> torch.Tensor:
    """One launch of (B, ceil(bucket/4) + 2) uint8 packed reads through the
    probe, the candidate gather, the fused walk and the filter.

    With ``scalars`` and ``s_min`` (``device_tables.s_min_table(...,
    bucket)`` on the device) the compact ``(B, 2)`` int32 results of
    ``ops.compact``; without, the full ``(B, 3)`` of ``ops.full``.  Up to
    ``c_max`` (<= 16) candidates are walked per read.  Stacked tables take
    ``(L,)`` gate tensors and an ``(L, bucket + 1)`` ``s_min``, and serve
    every row against every library: ``(L*B, .)``, library major.

    The tables are checked once per tables object (``t.layout``), the
    gates and ``s_min`` on their first call with it, the packed rows and
    ``c_max`` on every call; anything the kernel does not take raises
    ValueError.  CUDA tensors launch ``csrc/probe_walk_filter.cu`` (or
    raise); CPU tensors take :func:`probe_walk_plain`.
    ``probe_walk.launches`` counts kernel launches.
    """
    _check_packed(packed, bucket)
    _check_c_max(c_max)
    dev = packed.device
    layout = t.layout
    if dev != layout.device:
        raise ValueError(f"packed is on {dev}, the tables on "
                         f"{layout.device}")
    block = _block(layout, t, scalars, s_min, bucket)
    if dev.type == "cpu":
        return probe_walk_plain(packed, t, bucket=bucket, c_max=c_max,
                                scalars=scalars, s_min=s_min)
    if dev.type != "cuda":
        raise ValueError(f"probe_walk: unsupported device {dev}")
    B0 = packed.shape[0]
    B = B0 * layout.n_libraries
    width = 3 if scalars is None else 2
    if B * width >= MAX_INDEX or packed.numel() >= MAX_INDEX:
        raise ValueError(f"{B0} packed rows: the results or the rows reach "
                         f"2^31 elements; the kernel indexes in 32 bits")
    out = packed.new_empty((B, width), dtype=torch.int32)
    if B == 0:
        return out
    kernel = _kernel_lib()
    # a device context only for a card other than the current one
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = kernel.nimble_probe_walk_filter(
            block, packed.data_ptr(), out.data_ptr(), B0, c_max,
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = kernel.nimble_cuda_error_string(err).decode()
        raise RuntimeError(f"probe_walk kernel launch failed: {msg}")
    with _count_lock:
        probe_walk.launches += 1
    return out


probe_walk.launches = 0
