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
The masks are int8 0/1 values (the Pallas kernel multiplies them; the
CUDA kernel reads bit 0 of each byte).  On the card the wrapper picks the
kernel's tile (:func:`tile_reads`): up to 32 reads whose masks the kernel
stages in shared memory, within ``SMEM_TARGET``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from nimble_tpu_torch.ops import _build

MAX_CANDIDATES = 32  # a read's live candidates are one 32-bit word
MAX_TILE = 32  # reads per tile: the kernel's walkers are one warp
# shared memory a launch aims at (several blocks on each SM); one read is
# always allowed up to the card's opt-in maximum
SMEM_TARGET = 80 * 1024
_SLACK = 48  # bytes per staged range: 16-byte envelope and funnel over-read


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
            lib.nimble_double_walk.argtypes = [vp] * 10 + [ci] * 5 + [vp]
            lib.nimble_double_walk.restype = ci
            lib.nimble_double_walk_smem.argtypes = [ci] * 4
            lib.nimble_double_walk_smem.restype = ctypes.c_int64
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


def smem_bytes(R: int, C: int, T: int, Tl: int) -> int:
    """Shared memory of one kernel launch with tiles of R reads: two
    mbarriers; two staging buffers of one walk's alive and match (R*C*S
    bytes each) and active (R*S) masks, S = max(T, Tl); and two sets of
    packed words, ceil(C/8) byte planes of alive and of match, 4 bytes per
    read and 4 steps at an odd read stride.  Mirrors ``Layout`` in
    ``csrc/double_walk.cu``."""
    S = max(T, Tl)
    odd_g = (S + 3) // 4 | 1
    planes = (C + 7) // 8

    def r16(n):
        return (n + 15) // 16 * 16

    buffer = 2 * r16(R * C * S + _SLACK) + r16(R * S + _SLACK)
    return 16 + 2 * buffer + 2 * 2 * planes * R * odd_g * 4


def tile_reads(B: int, C: int, T: int, Tl: int, optin: int) -> int:
    """Reads per kernel tile: the largest R <= min(B, MAX_TILE) whose
    launch fits SMEM_TARGET, and at least 1.  Raises ``ValueError`` when a
    tile of one read needs more than ``optin`` bytes, the shared memory a
    block can opt in to."""
    need = smem_bytes(1, C, T, Tl)
    if need > optin:
        raise ValueError(
            f"double_walk: one read's walk (C={C}, T={T}, Tl={Tl}) needs "
            f"{need} bytes of shared memory, over the {optin} a block can "
            "opt in to on this card")
    R = max(1, min(B, MAX_TILE))
    while R > 1 and smem_bytes(R, C, T, Tl) > SMEM_TARGET:
        R -= 1
    return R


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
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    R = tile_reads(B, C, T, Tl, optin)
    lib = _kernel_lib()
    live = torch.empty((B, C), dtype=torch.int8, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    mm = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nimble_double_walk(
            *(a.data_ptr() for a in args),
            live.data_ptr(), score.data_ptr(), mm.data_ptr(),
            B, C, T, Tl, R, stream,
        )
    if err:
        msg = lib.nimble_double_walk_error_string(err).decode()
        raise RuntimeError(f"double_walk kernel launch failed: {msg}")
    with _count_lock:
        double_walk.launches += 1
    return live, score, mm


double_walk.launches = 0
