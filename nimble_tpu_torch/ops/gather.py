"""Row gathers from a table staged in shared memory: the gather-probe kernels.

Counterparts of the three Pallas kernels of ``scripts/probe_mosaic_gather.py``
(``pallas_take``, ``pallas_taa``, ``pallas_lane``), which ask whether a row
gather from a table resident in on-chip memory beats the gather from device
memory.  The kernels are ``csrc/gather_rows.cu``; the wrappers here check
the arguments, launch on the calling thread's current stream and count
launches, and take the plain torch version for CPU tensors:

- :func:`gather_take` ``(tab (N, W), idx (M,)) -> tab[idx]`` (M, W);
- :func:`gather_taa` ``(tab (N, W), idx2 (M, W)) -> tab.gather(0, idx2)``;
- :func:`gather_lane` ``(tab_t (W, N), idx2 (W, M)) -> tab_t.gather(1,
  idx2)``.

Values are int32 (uint32 bit patterns); indices are int32 in [0, N).  The
kernels clamp indices into the table, the plain versions do not: in-range
indices are the contract, as in the probe.  ``gather_take`` and
``gather_taa`` stage the whole table in each block, and refuse with
``ValueError`` a table larger than the shared memory a block can opt in to;
``gather_lane`` stages one table row per block, and refuses only a row
(N * 4 bytes) over that limit.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from nimble_tpu_torch.ops import _build

_ERR_TABLE_TOO_LARGE = -1


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
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for name in ("nimble_gather_take", "nimble_gather_taa",
                         "nimble_gather_lane"):
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, vp, ci, ci, ctypes.c_int64, vp]
                fn.restype = ci
            lib.nimble_gather_smem_optin.argtypes = []
            lib.nimble_gather_smem_optin.restype = ci
            lib.nimble_gather_error_string.argtypes = [ci]
            lib.nimble_gather_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(name, table, index, table_shape, index_shape):
    for label, t, shape in (("table", table, table_shape),
                            ("index", index, index_shape)):
        if t.dim() != len(shape) or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape)):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {label} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if table.numel() == 0:
        raise ValueError(f"{name}: the table is empty")
    if index.device != table.device:
        raise ValueError(f"{name}: index on {index.device}, table on "
                         f"{table.device}")


def _launch(wrapper, entry: str, table, index, out, N: int, W: int, M: int,
            staged: str):
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {dev}")
    if M == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(table.data_ptr(), index.data_ptr(),
                                  out.data_ptr(), N, W, M, stream)
        if err == _ERR_TABLE_TOO_LARGE:
            raise ValueError(
                f"{wrapper.__name__}: {staged} exceeds "
                f"the {lib.nimble_gather_smem_optin()} bytes of shared "
                "memory a block can opt in to on this card")
    if err:
        msg = lib.nimble_gather_error_string(err).decode()
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: {msg}")
    with _count_lock:
        wrapper.launches += 1
    return out


def gather_take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx]``: rows of an (N, W) table by (M,) indices -> (M, W).

    CUDA tensors launch ``csrc/gather_rows.cu`` (``pallas_take``'s
    counterpart) or raise; CPU tensors take :func:`gather_take_plain`.
    ``gather_take.launches`` counts kernel launches.
    """
    _check("gather_take", tab, idx, (None, None), (None,))
    if tab.device.type == "cpu":
        return gather_take_plain(tab, idx)
    (N, W), M = tab.shape, idx.shape[0]
    out = torch.empty((M, W), dtype=torch.int32, device=tab.device)
    return _launch(gather_take, "nimble_gather_take", tab, idx, out, N, W, M,
                   f"a table of {N * W * 4} bytes")


def gather_taa(tab: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(tab, idx2, axis=0)``: ``out[m, w] = tab[idx2[m, w],
    w]`` for an (N, W) table and an (M, W) index -> (M, W).

    CUDA tensors launch the kernel (``pallas_taa``'s counterpart) or raise;
    CPU tensors take :func:`gather_taa_plain`.
    """
    _check("gather_taa", tab, idx2, (None, None),
           (None, tab.shape[1] if tab.dim() == 2 else None))
    if tab.device.type == "cpu":
        return gather_taa_plain(tab, idx2)
    (N, W), M = tab.shape, idx2.shape[0]
    out = torch.empty((M, W), dtype=torch.int32, device=tab.device)
    return _launch(gather_taa, "nimble_gather_taa", tab, idx2, out, N, W, M,
                   f"a table of {N * W * 4} bytes")


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
    return _launch(gather_lane, "nimble_gather_lane", tab_t, idx2, out, N, W,
                   M, f"a table row of {N * 4} bytes")


gather_take.launches = 0
gather_taa.launches = 0
gather_lane.launches = 0
