"""The walk recurrence over precomputed masks: the double-walk kernel.

Counterpart: ``ops/pallas_walk.pallas_double_walk`` (the kernel:
``csrc/double_walk.cu``, wrapped by :func:`double_walk`, with
:func:`double_walk_plain` as its plain torch version) and the step rule of
``engine_fast._walk_scan_t``.  The masks come from
``ops.span_walk.rel_walk_masks``.

One step over a read's C candidate lanes: ``la = live & alive``, ``lm =
live & match``, ``act = active & any(la)``; ``live`` becomes ``lm`` when
``act & any(lm)``, else ``la`` when ``act``, else stays; ``score`` counts
the steps with ``act & any(lm)``, ``mm`` those with ``act & !any(lm)``.
The forward walk runs first, then the left walk, with ``live`` carried.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from nimble_tpu_torch.ops import _build

MAX_CANDIDATES = 32  # candidate lanes of one read share one warp


def double_walk_plain(f_alive, f_match, f_active, l_alive, l_match, l_active,
                      live0):
    """Plain torch version of the double walk (same arguments and results
    as :func:`double_walk`)."""
    B = live0.shape[0]
    dev = live0.device
    live = live0 != 0
    score = torch.zeros(B, dtype=torch.int32, device=dev)
    mm = torch.zeros(B, dtype=torch.int32, device=dev)
    for alive, match, active in ((f_alive, f_match, f_active),
                                 (l_alive, l_match, l_active)):
        alive, match, active = alive != 0, match != 0, active != 0
        for t in range(alive.shape[2]):
            la = live & alive[:, :, t]
            lm = live & match[:, :, t]
            any_match = lm.any(dim=1)
            act = active[:, t] & la.any(dim=1)
            act_match = act & any_match
            live = torch.where(act_match[:, None], lm,
                               torch.where(act[:, None], la, live))
            score += act_match.to(torch.int32)
            mm += (act & ~any_match).to(torch.int32)
    return live.to(torch.int8), score, mm


_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load_library("double_walk")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.nimble_double_walk.argtypes = [vp] * 10 + [ci] * 4 + [vp]
            lib.nimble_double_walk.restype = ci
            lib.nimble_double_walk_error_string.argtypes = [ci]
            lib.nimble_double_walk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_args(f_alive, f_match, f_active, l_alive, l_match, l_active,
                live0):
    if live0.dim() != 2:
        raise ValueError(f"live0 must be (B, C), got {tuple(live0.shape)}")
    B, C = live0.shape
    if not 1 <= C <= MAX_CANDIDATES:
        raise ValueError(f"candidate count {C} not in [1, {MAX_CANDIDATES}]")
    if f_alive.dim() != 3 or l_alive.dim() != 3:
        raise ValueError("f_alive and l_alive must be (B, C, steps)")
    T, Tl = f_alive.shape[2], l_alive.shape[2]
    expect = {
        "f_alive": (f_alive, (B, C, T)),
        "f_match": (f_match, (B, C, T)),
        "f_active": (f_active, (B, T)),
        "l_alive": (l_alive, (B, C, Tl)),
        "l_match": (l_match, (B, C, Tl)),
        "l_active": (l_active, (B, Tl)),
        "live0": (live0, (B, C)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.int8:
            raise ValueError(
                f"{name}: expected {shape} torch.int8, got "
                f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != live0.device:
            raise ValueError(f"{name} is on {t.device}, live0 on "
                             f"{live0.device}")
    return B, C, T, Tl


def double_walk(f_alive, f_match, f_active, l_alive, l_match, l_active,
                live0):
    """Forward then left walk over int8 0/1 masks.

    f_alive, f_match (B, C, T); f_active (B, T); l_alive, l_match
    (B, C, Tl); l_active (B, Tl); live0 (B, C).  Returns (live (B, C) int8,
    score (B,) int32, mm (B,) int32), as ``pallas_double_walk``.

    CUDA tensors launch ``csrc/double_walk.cu`` (or raise); CPU tensors take
    :func:`double_walk_plain`.  ``double_walk.launches`` counts kernel
    launches.
    """
    args = (f_alive, f_match, f_active, l_alive, l_match, l_active, live0)
    B, C, T, Tl = _check_args(*args)
    dev = live0.device
    if dev.type == "cpu":
        return double_walk_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"double_walk: unsupported device {dev}")
    lib = _kernel_lib()
    live = torch.empty((B, C), dtype=torch.int8, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    mm = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nimble_double_walk(
            *(a.data_ptr() for a in args),
            live.data_ptr(), score.data_ptr(), mm.data_ptr(),
            B, C, T, Tl, stream,
        )
    if err:
        msg = lib.nimble_double_walk_error_string(err).decode()
        raise RuntimeError(f"double_walk kernel launch failed: {msg}")
    with _count_lock:
        double_walk.launches += 1
    return live, score, mm


double_walk.launches = 0
