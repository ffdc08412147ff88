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

import ctypes
import threading
from typing import Optional

import torch

from nimble_tpu_torch.ops import _build
from nimble_tpu_torch.ops.device_tables import FilterScalars, IndexTables

MAX_CANDIDATES = 16  # the results pack the live lanes in 16 bits
MAX_K = 32           # a key half of k/2 or k - k/2 bases fits 32 bits

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load_library("probe_walk_filter")
            vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.nimble_probe_walk_filter.argtypes = (
                [vp] * 17 + [i64] * 7 + [ci] * 11 + [vp])
            lib.nimble_probe_walk_filter.restype = ci
            lib.nimble_cuda_error_string.argtypes = [ci]
            lib.nimble_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


_TABLES = ("bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount",
           "postings_row", "postings_off", "ref_codes_packed", "row_starts",
           "row_lengths")


def _check_args(packed, t: IndexTables, scalars, s_min, bucket: int,
                c_max: int) -> tuple:
    """Raises ValueError on anything the kernel does not take; returns
    (B results, L libraries, stacked)."""
    if packed.dim() != 2 or packed.dtype != torch.uint8 \
            or packed.shape[1] != (bucket + 3) // 4 + 2:
        raise ValueError(
            f"packed: expected (B, {(bucket + 3) // 4 + 2}) torch.uint8, got "
            f"{tuple(packed.shape)} {packed.dtype}")
    if not 1 <= c_max <= MAX_CANDIDATES:
        raise ValueError(f"c_max={c_max} not in [1, {MAX_CANDIDATES}]")
    if not 2 <= t.k <= MAX_K or t.k >= bucket:
        raise ValueError(f"k={t.k} must lie in [2, {MAX_K}] and below "
                         f"bucket={bucket}")
    if (scalars is None) != (s_min is None):
        raise ValueError("scalars and s_min come together (compact mode) "
                         "or not at all (full mode)")
    if t.bkey_fp.dim() not in (2, 3):
        raise ValueError(f"bkey_fp: {tuple(t.bkey_fp.shape)}, want (n_buckets,"
                         " W) or stacked (L, n_buckets, W)")
    stacked = t.bkey_fp.dim() == 3
    L = t.bkey_fp.shape[0] if stacked else 1
    lead = (L,) if stacked else ()
    n_buckets, W = t.bkey_fp.shape[-2:]
    if n_buckets != t.bucket_mask + 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"{n_buckets} buckets: want a power of two, "
                         f"bucket_mask + 1 = {t.bucket_mask + 1}")
    nw = (bucket + 15) // 16 + 1
    if t.ref_codes_packed.shape[-1] < nw:
        raise ValueError(f"ref_codes_packed {tuple(t.ref_codes_packed.shape)}"
                         f": want >= {nw} words")
    extent = {name: lead + (getattr(t, name).shape[-1],) for name in (
        "postings_row", "ref_codes_packed", "row_starts")}
    expect = {"packed": (packed, tuple(packed.shape), torch.uint8)}
    for name in _TABLES:
        shape = (lead + (n_buckets, W) if name.startswith("b") else
                 extent[{"postings_off": "postings_row",
                         "row_lengths": "row_starts"}.get(name, name)])
        expect[name] = (getattr(t, name), shape, torch.int32)
    if s_min is not None:
        expect["s_min"] = (s_min, lead + tuple(s_min.shape[len(lead):]),
                           torch.int32)
        if s_min.dim() != len(lead) + 1 or s_min.shape[-1] < 1:
            raise ValueError(f"s_min: {tuple(s_min.shape)}, want "
                             f"{lead + ('n',)}")
        if stacked:
            for name, dtype in (("score_threshold", torch.int32),
                                ("num_mismatches", torch.int32),
                                ("discard_multiple", torch.bool),
                                ("discard_nonzero", torch.bool)):
                x = getattr(scalars, name)
                if not isinstance(x, torch.Tensor):
                    raise ValueError(f"scalars.{name}: stacked tables take "
                                     f"(L,) tensors, got {type(x).__name__}")
                expect[f"scalars.{name}"] = (x, (L,), dtype)
    for name, (x, shape, dtype) in expect.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != packed.device:
            raise ValueError(f"{name} is on {x.device}, packed on "
                             f"{packed.device}")
    return packed.shape[0] * L, L, stacked


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

    CUDA tensors launch ``csrc/probe_walk_filter.cu`` (or raise); CPU
    tensors take :func:`probe_walk_plain`.  ``probe_walk.launches`` counts
    kernel launches.
    """
    B, L, stacked = _check_args(packed, t, scalars, s_min, bucket, c_max)
    dev = packed.device
    if dev.type == "cpu":
        return probe_walk_plain(packed, t, bucket=bucket, c_max=c_max,
                                scalars=scalars, s_min=s_min)
    if dev.type != "cuda":
        raise ValueError(f"probe_walk: unsupported device {dev}")
    full = scalars is None
    out = packed.new_empty((B, 3 if full else 2), dtype=torch.int32)
    if B == 0:
        return out
    kernel = _kernel_lib()
    gates = (None, None, None, None) if full or not stacked else (
        scalars.score_threshold.data_ptr(), scalars.num_mismatches.data_ptr(),
        scalars.discard_multiple.data_ptr(),
        scalars.discard_nonzero.data_ptr())
    values = (0, 0, 0, 0) if full or stacked else (
        int(scalars.score_threshold), int(scalars.num_mismatches),
        int(bool(scalars.discard_multiple)),
        int(bool(scalars.discard_nonzero)))
    n_buckets, W = t.bkey_fp.shape[-2:]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel.nimble_probe_walk_filter(
            packed.data_ptr(),
            *(getattr(t, name).data_ptr() for name in _TABLES),
            None if full else s_min.data_ptr(), *gates, out.data_ptr(),
            n_buckets, t.postings_row.shape[-1], t.row_starts.shape[-1],
            t.ref_codes_packed.shape[-1],
            0 if full else s_min.shape[-1], *values,
            B, packed.shape[0], c_max, W, t.max_probe, bucket, t.k,
            t.ref_pad, int(full), stream,
        )
    if err:
        msg = kernel.nimble_cuda_error_string(err).decode()
        raise RuntimeError(f"probe_walk kernel launch failed: {msg}")
    with _count_lock:
        probe_walk.launches += 1
    return out


probe_walk.launches = 0
