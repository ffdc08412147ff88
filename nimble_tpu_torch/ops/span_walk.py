"""Candidate span walk: reference-word gather + the two walk kernels.

Counterparts: ``engine_fast._gather_span_words`` and
``_span_walk_abs_fused`` (the torch glue here), and
``ops/pallas_fused.pallas_fused_span_walk`` (the kernel:
``csrc/fused_span_walk.cu``, wrapped by :func:`fused_span_walk`, with
:func:`fused_span_walk_plain` as its plain torch version).  The
relative-coordinate form ``engine_fast._span_walk_rel`` builds its masks
here (:func:`rel_walk_masks`) and runs them through
``ops.double_walk.double_walk`` (:func:`span_walk_rel`).

The walk works in READ-absolute coordinates: candidate c of read b compares
reference base ``base_off[b, c] + p`` of its row with read base p.  Forward
steps run p = k..Lmax-1 (alive while ``base_off + p < r_len``, active for
``anchor + k <= p < read_len``); left steps run p = P-2..0 with
P = Lmax - k + 1 (alive while ``base_off + p >= 0``, active for
``p < anchor``).  One step: if an active candidate matches, ``live &=
match``; else if any is alive, ``live &= alive``; ``score`` counts matched
active steps, ``mm`` active steps where no live candidate matched.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from nimble_tpu_torch.ops import _build
from nimble_tpu_torch.ops.device_tables import IndexTables, take
from nimble_tpu_torch.ops.double_walk import double_walk

M32 = 0xFFFFFFFF
MAX_CANDIDATES = 32  # candidate lanes of one read share one warp


def gather_span_words(ref_codes_packed: torch.Tensor, starts: torch.Tensor,
                      NW: int, lib=None):
    """NW consecutive packed words per span start (any shape ``S``).

    Returns (words ``S + (NW,)`` int32 bits, phase ``S`` int32): the span's
    2-bit codes sit at bit offsets ``2 * (phase + p)`` of its window.  The
    window index is clamped like the JAX sliding-window gather.  With
    stacked ``(L, n_words)`` words, ``lib`` (``S`` or a leading prefix of
    it) names each span's library and the clamp is to the padded common
    extent, as under the JAX package's vmap over libraries.
    """
    n_words = ref_codes_packed.shape[-1]
    w0 = (starts >> 4).clamp(0, n_words - NW)
    idx = w0[..., None] + torch.arange(NW, device=starts.device)
    return take(ref_codes_packed, lib, idx), (starts & 15).to(torch.int32)


def fused_span_walk_plain(reads, read_lens, anchor, base_off, r_len, live0,
                          words, phase, *, k: int):
    """Plain torch version of the fused span-walk (same arguments and
    results as :func:`fused_span_walk`)."""
    B, Lmax = reads.shape
    NW = words.shape[2]
    dev = reads.device
    w = words.to(torch.int64) & M32
    s = (phase.to(torch.int64) * 2)[..., None]
    lo = w[..., : NW - 1] >> s
    hi = (((w[..., 1:] << (31 - s)) & M32) << 1) & M32
    aligned = lo | hi                                   # (B, C, NW-1)
    p = torch.arange(Lmax, device=dev)
    codes = (aligned[..., p >> 4] >> (2 * (p & 15))) & 3   # (B, C, Lmax)
    match = codes == reads.to(torch.int64)[:, None, :]

    base = base_off.to(torch.int64)
    rlen = r_len.to(torch.int64)
    anc = anchor.to(torch.int64)
    rdl = read_lens.to(torch.int64)
    live = live0.clone()
    score = torch.zeros(B, dtype=torch.int32, device=dev)
    mm = torch.zeros(B, dtype=torch.int32, device=dev)

    def step(pp, alive, active):
        nonlocal live, score, mm
        la = live & alive
        lm = la & match[:, :, pp]
        any_alive = la.any(dim=1)
        any_match = lm.any(dim=1)
        act = active & any_alive
        act_match = act & any_match
        live = torch.where(act_match[:, None], lm,
                           torch.where(act[:, None], la, live))
        score += act_match.to(torch.int32)
        mm += (act & ~any_match).to(torch.int32)

    for pp in range(k, Lmax):
        step(pp, (base + pp) < rlen, (pp >= anc + k) & (pp < rdl))
    P = Lmax - k + 1
    for pp in range(P - 2, -1, -1):
        step(pp, (base + pp) >= 0, pp < anc)
    return live, score, mm


_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load_library("fused_span_walk")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.nimble_fused_span_walk.argtypes = (
                [vp] * 11 + [ci] * 5 + [vp]
            )
            lib.nimble_fused_span_walk.restype = ci
            lib.nimble_cuda_error_string.argtypes = [ci]
            lib.nimble_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_args(reads, read_lens, anchor, base_off, r_len, live0, words,
                phase):
    if reads.dim() != 2:
        raise ValueError(f"reads must be (B, Lmax), got {tuple(reads.shape)}")
    B, Lmax = reads.shape
    if base_off.dim() != 2 or base_off.shape[0] != B:
        raise ValueError(f"base_off must be (B, C), got {tuple(base_off.shape)}")
    C = base_off.shape[1]
    if not 1 <= C <= MAX_CANDIDATES:
        raise ValueError(f"candidate count {C} not in [1, {MAX_CANDIDATES}]")
    if words.dim() != 3 or tuple(words.shape[:2]) != (B, C):
        raise ValueError(f"words must be (B, C, NW), got {tuple(words.shape)}")
    NW = words.shape[2]
    if NW < (Lmax + 15) // 16 + 1:
        raise ValueError(f"NW={NW} words cannot cover Lmax={Lmax}")
    expect = {
        "reads": (reads, (B, Lmax), torch.int32),
        "read_lens": (read_lens, (B,), torch.int32),
        "anchor": (anchor, (B,), torch.int32),
        "base_off": (base_off, (B, C), torch.int32),
        "r_len": (r_len, (B, C), torch.int32),
        "live0": (live0, (B, C), torch.bool),
        "words": (words, (B, C, NW), torch.int32),
        "phase": (phase, (B, C), torch.int32),
    }
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name}: expected {shape} {dtype}, got "
                f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != reads.device:
            raise ValueError(
                f"{name} is on {t.device}, reads on {reads.device}")
    return B, Lmax, C, NW


def fused_span_walk(reads, read_lens, anchor, base_off, r_len, live0, words,
                    phase, *, k: int):
    """The fused span-walk over gathered reference words.

    reads (B, Lmax) int32 codes; read_lens, anchor (B,) int32; base_off
    (= off - anchor), r_len (B, C) int32; live0 (B, C) bool; words
    (B, C, NW) int32 (uint32 bits) from :func:`gather_span_words` with
    NW >= (Lmax + 15) // 16 + 1; phase (B, C) int32 in [0, 16).  Returns
    (live (B, C) bool, score (B,) int32, mm (B,) int32).

    CUDA tensors launch ``csrc/fused_span_walk.cu`` (or raise); CPU tensors
    take :func:`fused_span_walk_plain`.  ``fused_span_walk.launches``
    counts kernel launches.
    """
    B, Lmax, C, NW = _check_args(reads, read_lens, anchor, base_off, r_len,
                                 live0, words, phase)
    dev = reads.device
    if dev.type == "cpu":
        return fused_span_walk_plain(reads, read_lens, anchor, base_off,
                                     r_len, live0, words, phase, k=k)
    if dev.type != "cuda":
        raise ValueError(f"fused_span_walk: unsupported device {dev}")
    if not 0 < k < Lmax:
        raise ValueError(f"k={k} must lie in (0, Lmax={Lmax})")
    lib = _kernel_lib()
    live = torch.empty((B, C), dtype=torch.bool, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    mm = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nimble_fused_span_walk(
            reads.data_ptr(), read_lens.data_ptr(), anchor.data_ptr(),
            base_off.data_ptr(), r_len.data_ptr(), live0.data_ptr(),
            words.data_ptr(), phase.data_ptr(),
            live.data_ptr(), score.data_ptr(), mm.data_ptr(),
            B, C, Lmax, NW, k, stream,
        )
    if err:
        msg = lib.nimble_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_span_walk kernel launch failed: {msg}")
    with _count_lock:
        fused_span_walk.launches += 1
    return live, score, mm


fused_span_walk.launches = 0


def unpack_span(words: torch.Tensor, phase: torch.Tensor, L: int):
    """(M, NW) word windows + (M,) phases -> (M, L) int32 2-bit codes
    (``engine_fast._unpack_span``)."""
    j = phase.to(torch.int64)[:, None] + torch.arange(L, device=words.device)
    acc = words.gather(1, j >> 4)
    return (acc >> ((j & 15) * 2).to(torch.int32)) & 3


def rel_walk_masks(reads, read_lens, anchor, rows, offs, live0,
                   t: IndexTables, *, l_steps: int, lib=None) -> dict:
    """Arguments of :func:`double_walk` for (B, C) candidates: the
    relative-coordinate glue of ``engine_fast._span_walk_rel`` (the
    ``use_pallas=True`` branch).

    The read span around the anchor and each candidate's reference span
    cover ``W = l_steps + k + T`` bases (T = Lmax - k): the forward masks
    take columns ``l_steps + k ..``, the left masks the first ``l_steps``
    columns reversed (step j = 1..l_steps compares read position
    ``anchor - j``).  With ``l_steps == 0`` the left walk is one step of
    all-zero masks.  ``lib`` (B,): each read's library in stacked tables.
    """
    B, Lmax = reads.shape
    C = rows.shape[1]
    k = t.k
    T = Lmax - k
    W = l_steps + k + T
    dev = reads.device
    anchor = anchor.to(torch.int64)
    offs = offs.to(torch.int64)

    reads_padded = torch.nn.functional.pad(reads.to(torch.int32), (l_steps, T))
    x_w = torch.arange(W, device=dev)
    read_span = reads_padded.gather(1, anchor[:, None] + x_w)     # (B, W)

    starts = take(t.row_starts, lib, rows).to(torch.int64) + offs - l_steps \
        + t.ref_pad
    words, phase = gather_span_words(
        t.ref_codes_packed, starts.reshape(-1), (W + 15) // 16 + 1,
        None if lib is None else lib[:, None].expand(B, C).reshape(-1))
    ref_span = unpack_span(words, phase, W).reshape(B, C, W)
    match_full = ref_span == read_span[:, None, :]              # (B, C, W)

    r_len = take(t.row_lengths, lib, rows).to(torch.int64)
    t_idx = torch.arange(T, device=dev)
    f_alive = (offs[:, :, None] + k + t_idx) < r_len[:, :, None]
    f_match = match_full[:, :, l_steps + k:] & f_alive
    f_active = (anchor[:, None] + k + t_idx) < read_lens[:, None]
    if l_steps > 0:
        j_idx = torch.arange(1, l_steps + 1, device=dev)
        l_alive = (offs[:, :, None] - j_idx) >= 0
        l_match = match_full[:, :, :l_steps].flip(2) & l_alive
        l_active = (anchor[:, None] - j_idx) >= 0
    else:
        l_alive = l_match = torch.zeros((B, C, 1), dtype=torch.bool,
                                        device=dev)
        l_active = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    i8 = torch.int8
    return dict(
        f_alive=f_alive.to(i8), f_match=f_match.to(i8),
        f_active=f_active.to(i8).contiguous(),
        l_alive=l_alive.to(i8).contiguous(), l_match=l_match.to(i8),
        l_active=l_active.to(i8).contiguous(), live0=live0.to(i8).contiguous(),
    )


def span_walk_rel(reads, read_lens, anchor, rows, offs, live0,
                  t: IndexTables, *, l_steps: int, lib=None):
    """``engine_fast._span_walk_rel(use_pallas=True)``: the masks of
    :func:`rel_walk_masks` through :func:`double_walk`.  Returns (live
    (B, C) bool, score (B,) int32, mm (B,) int32)."""
    live, score, mm = double_walk(**rel_walk_masks(
        reads, read_lens, anchor, rows, offs, live0, t, l_steps=l_steps,
        lib=lib))
    return live != 0, score, mm


def walk_args(reads, read_lens, anchor, rows, offs, live0,
              t: IndexTables, lib=None) -> dict:
    """Arguments of :func:`fused_span_walk` for (B, C) candidates given as
    row ids and anchor offsets in those rows: the torch glue of
    ``_span_walk_abs_fused`` (the word gather stays a torch op).  ``lib``
    (B,): each read's library in stacked tables."""
    Lmax = reads.shape[1]
    starts = take(t.row_starts, lib, rows).to(torch.int64) + offs \
        - anchor[:, None] + t.ref_pad
    words, phase = gather_span_words(
        t.ref_codes_packed, starts, (Lmax + 15) // 16 + 1, lib)
    i32 = torch.int32
    return dict(
        reads=reads.to(i32).contiguous(),
        read_lens=read_lens.to(i32).contiguous(),
        anchor=anchor.to(i32).contiguous(),
        base_off=(offs - anchor[:, None]).to(i32).contiguous(),
        r_len=take(t.row_lengths, lib, rows).contiguous(),
        live0=live0.contiguous(),
        words=words.contiguous(),
        phase=phase.contiguous(),
    )
