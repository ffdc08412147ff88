"""Row gathers from a table held on chip: the gather-probe kernels.

Counterparts of the three Pallas kernels of ``scripts/probe_mosaic_gather.py``
(``pallas_take``, ``pallas_taa``, ``pallas_lane``), which ask whether a row
gather from a table resident in on-chip memory beats the gather from device
memory.  The kernels are ``csrc/gather_rows.cu``; the wrappers here check
the arguments, launch on the calling thread's current stream and count
launches, and take the plain torch version for CPU tensors:

- :func:`gather_take` ``(tab (N, W), idx (M,)) -> tab[idx]`` (M, W);
- :func:`gather_taa` ``(tab (N, W), idx2 (M, W)) -> tab.gather(0, idx2)``,
  with ``idx2`` contiguous or ``k_taa``'s own broadcast index
  ``idx[:, None].expand(M, W)`` (strides ``(1, 0)``), which the kernel
  reads as one index per row;
- :func:`gather_lane` ``(tab_t (W, N), idx2 (W, M)) -> tab_t.gather(1,
  idx2)``.

Values are int32 (uint32 bit patterns); indices are int32 in [0, N).  The
kernels clamp indices into the table, the plain versions do not: in-range
indices are the contract, as in the probe.  ``gather_take`` and
``gather_taa`` share one kernel entry, which picks its design from the
index's form and the table's size (:func:`rows_design`): a table copied
into each block's shared memory where that measured faster on an H100
(PERF.md section 6), else rows read straight from global memory through
L1.  So they refuse no table.  ``gather_lane`` stages one table row per
block, and refuses with ``ValueError`` a row (N * 4 bytes) over the shared
memory a block can opt in to.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from nimble_tpu_torch.ops import _build

_ERR_TABLE_TOO_LARGE = -1
_DESIGNS = ("unstaged", "per-block")  # nimble_gather_rows_design's codes


def gather_take_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tab[idx.to(torch.int64)]


def gather_taa_plain(tab: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    return tab.gather(0, idx2.to(torch.int64))


def gather_lane_plain(tab_t: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    return tab_t.gather(1, idx2.to(torch.int64))


_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load_library("gather_rows")
            vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.nimble_gather_rows.argtypes = [vp, vp, vp, ci, ci, i64, i64,
                                               i64, vp]
            lib.nimble_gather_rows.restype = ci
            lib.nimble_gather_rows_design.argtypes = [
                ci, ci, i64, i64, ctypes.POINTER(i64)]
            lib.nimble_gather_rows_design.restype = ci
            lib.nimble_gather_lane.argtypes = [vp, vp, vp, ci, ci, i64, vp]
            lib.nimble_gather_lane.restype = ci
            lib.nimble_gather_smem_optin.argtypes = []
            lib.nimble_gather_smem_optin.restype = ci
            lib.nimble_gather_error_string.argtypes = [ci]
            lib.nimble_gather_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(name, table, index, table_shape, index_shape,
           broadcast=False):
    """Shapes, int32, a non-empty table on the index's device; contiguous
    tensors, or with ``broadcast`` an index of strides ``(1, 0)``."""
    for label, t, shape in (("table", table, table_shape),
                            ("index", index, index_shape)):
        if t.dim() != len(shape) or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape)):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {label} must be int32, got {t.dtype}")
    if not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")
    if not index.is_contiguous() and not (broadcast
                                          and index.stride() == (1, 0)):
        raise ValueError(
            f"{name}: index must be contiguous"
            + (" or idx[:, None].expand(M, W) (strides (1, 0)), got strides "
               f"{index.stride()}" if broadcast else ""))
    if table.numel() == 0:
        raise ValueError(f"{name}: the table is empty")
    if index.device != table.device:
        raise ValueError(f"{name}: index on {index.device}, table on "
                         f"{table.device}")


def _launch(wrapper, entry: str, table, index, out, args, refused):
    """``entry(table, index, out, *args, stream)`` on the table's device
    and current stream, counted on ``wrapper.launches`` once it has
    launched; no launch (and no count) when ``out`` is empty.  A table the
    entry refuses raises ValueError with the text ``refused(optin)``, any
    other error RuntimeError."""
    name = wrapper.__name__
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(table.data_ptr(), index.data_ptr(),
                                  out.data_ptr(), *args, stream)
        if err == _ERR_TABLE_TOO_LARGE and refused is not None:
            raise ValueError(f"{name}: "
                             f"{refused(lib.nimble_gather_smem_optin())}")
    if err:
        msg = lib.nimble_gather_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")
    with _count_lock:
        wrapper.launches += 1
    return out


def _strides(tab: torch.Tensor, index: torch.Tensor) -> tuple:
    """The kernel's (s0, s1) of a checked index: ``out[m, w] = tab[index[m
    * s0 + w * s1], w]``."""
    if index.dim() == 1 or not index.is_contiguous():
        return 1, 0  # take's (M,) index, or taa's broadcast index
    return tab.shape[1], 1


def gather_rows(wrapper, tab: torch.Tensor,
                index: torch.Tensor) -> torch.Tensor:
    """The kernel of :func:`gather_take` and :func:`gather_taa` on a
    checked (N, W) table and index (an (M,) index, or an (M, W) one,
    contiguous or of strides ``(1, 0)``), counted on ``wrapper``."""
    (N, W), M = tab.shape, index.shape[0]
    out = torch.empty((M, W), dtype=torch.int32, device=tab.device)
    return _launch(wrapper, "nimble_gather_rows", tab, index, out,
                   (N, W, M, *_strides(tab, index)), None)


def rows_design(tab: torch.Tensor, index: torch.Tensor) -> tuple:
    """(design, shared-memory bytes a block holds) that :func:`gather_rows`
    runs for this CUDA table and index: ``"per-block"`` (the table copied
    into each block) or ``"unstaged"`` (0 bytes)."""
    lib = _kernel_lib()
    smem = ctypes.c_int64(0)
    with torch.cuda.device(tab.device):
        code = lib.nimble_gather_rows_design(*tab.shape,
                                             *_strides(tab, index),
                                             ctypes.byref(smem))
    if code < 0:
        msg = lib.nimble_gather_error_string(-code).decode()
        raise RuntimeError(f"gather_rows design on {tab.device}: {msg}")
    return _DESIGNS[code], smem.value


def gather_take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx]``: rows of an (N, W) table by (M,) indices -> (M, W).

    CUDA tensors launch ``csrc/gather_rows.cu`` (``pallas_take``'s
    counterpart) or raise; CPU tensors take :func:`gather_take_plain`.
    ``gather_take.launches`` counts kernel launches.
    """
    _check("gather_take", tab, idx, (None, None), (None,))
    if tab.device.type == "cpu":
        return gather_take_plain(tab, idx)
    return gather_rows(gather_take, tab, idx)


def gather_taa(tab: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(tab, idx2, axis=0)``: ``out[m, w] = tab[idx2[m, w],
    w]`` for an (N, W) table and an (M, W) index -> (M, W).

    ``idx2`` is contiguous, or ``pallas_taa``'s own broadcast index
    ``idx[:, None].expand(M, W)`` (strides ``(1, 0)``): the kernel then
    reads one index per row, as ``tab[idx]`` does.  CUDA tensors launch the
    kernel (``pallas_taa``'s counterpart) or raise; CPU tensors take
    :func:`gather_taa_plain`.
    """
    _check("gather_taa", tab, idx2, (None, None),
           (None, tab.shape[1] if tab.dim() == 2 else None), broadcast=True)
    if tab.device.type == "cpu":
        return gather_taa_plain(tab, idx2)
    return gather_rows(gather_taa, tab, idx2)


def gather_lane(tab_t: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(tab_t, idx2, axis=1)``: ``out[w, m] = tab_t[w,
    idx2[w, m]]`` for a (W, N) table and a (W, M) index -> (W, M).

    CUDA tensors launch the kernel (``pallas_lane``'s counterpart) or raise;
    CPU tensors take :func:`gather_lane_plain`.
    """
    _check("gather_lane", tab_t, idx2, (None, None),
           (tab_t.shape[0] if tab_t.dim() == 2 else None, None))
    if tab_t.device.type == "cpu":
        return gather_lane_plain(tab_t, idx2)
    (W, N), M = tab_t.shape, idx2.shape[1]
    out = torch.empty((W, M), dtype=torch.int32, device=tab_t.device)
    return _launch(gather_lane, "nimble_gather_lane", tab_t, idx2, out,
                   (N, W, M),
                   lambda optin: (f"a table row of {N * 4} bytes exceeds the "
                                  f"{optin} bytes of shared memory a block can "
                                  "opt in to on this card"))


gather_take.launches = 0
gather_taa.launches = 0
gather_lane.launches = 0
