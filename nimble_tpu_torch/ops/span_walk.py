"""Candidate span walk: the fused span-walk kernel, its plain version, and
the relative-coordinate masks of the double walk.

Counterparts: ``engine_fast._span_walk_abs_fused`` (``_gather_span_words``
followed by ``ops/pallas_fused.pallas_fused_span_walk``) is
:func:`fused_span_walk`, which launches ``csrc/fused_span_walk.cu``: the
kernel reads the uploaded packed reads and gathers the reference words
itself.  Its plain version :func:`span_walk_plain` is the same steps in
torch: :func:`unpack_reads`, :func:`walk_args` (:func:`gather_span_words`)
and :func:`fused_span_walk_plain`, the walk over gathered words.  The
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
    """The fused span-walk over gathered reference words: reads (B, Lmax)
    int32 codes; read_lens, anchor (B,); base_off (= off - anchor), r_len
    (B, C); live0 (B, C) bool; words (B, C, NW) int32 (uint32 bits) from
    :func:`gather_span_words`; phase (B, C) in [0, 16).  Returns (live
    (B, C) bool, score (B,) int32, mm (B,) int32)."""
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


def unpack_reads(packed: torch.Tensor, bucket: int):
    """(B, ceil(bucket/4) + 2) uint8 rows -> ((B, bucket) int32 codes,
    (B,) int32 lengths): base j at bits 2*(j%4) of byte j//4, then the
    little-endian uint16 read length."""
    nb = (bucket + 3) // 4
    by = packed[:, :nb].to(torch.int32)
    j = torch.arange(bucket, device=packed.device)
    reads = (by[:, j >> 2] >> ((j & 3) * 2)) & 3
    read_lens = packed[:, nb].to(torch.int32) \
        | (packed[:, nb + 1].to(torch.int32) << 8)
    return reads, read_lens


def span_walk_plain(packed, anchor, rows, offs, live0, t: IndexTables, *,
                    bucket: int, lib=None):
    """Plain torch version of :func:`fused_span_walk` (same arguments and
    results): the read unpack, the word gather of :func:`walk_args` and
    :func:`fused_span_walk_plain`."""
    reads, read_lens = unpack_reads(packed, bucket)
    return fused_span_walk_plain(**walk_args(
        reads, read_lens, anchor, rows, offs, live0, t, lib), k=t.k)


_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load_library("fused_span_walk")
            vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.nimble_fused_span_walk.argtypes = (
                [vp] * 12 + [i64] * 2 + [ci] * 5 + [vp]
            )
            lib.nimble_fused_span_walk.restype = ci
            lib.nimble_cuda_error_string.argtypes = [ci]
            lib.nimble_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_args(packed, anchor, rows, offs, live0, t, bucket, lib):
    if packed.dim() != 2:
        raise ValueError(f"packed must be (B, row bytes), got "
                         f"{tuple(packed.shape)}")
    B = packed.shape[0]
    if rows.dim() != 2 or rows.shape[0] != B:
        raise ValueError(f"rows must be (B, C), got {tuple(rows.shape)}")
    C = rows.shape[1]
    if not 1 <= C <= MAX_CANDIDATES:
        raise ValueError(f"candidate count {C} not in [1, {MAX_CANDIDATES}]")
    if not 0 < t.k < bucket:
        raise ValueError(f"k={t.k} must lie in (0, bucket={bucket})")
    tdim = 1 if lib is None else 2
    ref = t.ref_codes_packed
    nw = (bucket + 15) // 16 + 1
    if ref.dim() != tdim or ref.shape[-1] < nw:
        raise ValueError(f"ref_codes_packed {tuple(ref.shape)}: want {tdim} "
                         f"dims and >= {nw} words")
    L = ref.shape[0] if lib is not None else 1
    n_rows = t.row_starts.shape[-1]
    lead = (L,) if lib is not None else ()
    expect = {
        "packed": (packed, (B, (bucket + 3) // 4 + 2), torch.uint8),
        "anchor": (anchor, (B,), torch.int64),
        "rows": (rows, (B, C), torch.int64),
        "offs": (offs, (B, C), torch.int64),
        "live0": (live0, (B, C), torch.bool),
        "row_starts": (t.row_starts, lead + (n_rows,), torch.int32),
        "row_lengths": (t.row_lengths, lead + (n_rows,), torch.int32),
        "ref_codes_packed": (ref, lead + (ref.shape[-1],), torch.int32),
    }
    if lib is not None:
        expect["lib"] = (lib, (B,), torch.int64)
    if ref.numel() >= 2**31 or t.row_starts.numel() >= 2**31:
        raise ValueError("ref_codes_packed or row_starts: 2^31 elements or "
                         "more; the kernel indexes the tables in 32 bits")
    for name, (x, shape, dtype) in expect.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"{name}: expected {shape} {dtype}, got "
                f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != packed.device:
            raise ValueError(
                f"{name} is on {x.device}, packed on {packed.device}")
    return B, C, n_rows, ref.shape[-1]


def fused_span_walk(packed, anchor, rows, offs, live0, t: IndexTables, *,
                    bucket: int, lib=None):
    """The fused span-walk, gathering its reference words itself.

    packed (B, ceil(bucket/4) + 2) uint8 read rows (as uploaded); anchor
    (B,) int64; rows, offs (B, C) int64 candidate row ids and anchor
    offsets; live0 (B, C) bool; the tables ``t.row_starts``,
    ``t.row_lengths``, ``t.ref_codes_packed`` (``(L, .)`` when ``lib``
    (B,) int64 names each row's library), ``t.k`` and ``t.ref_pad``.
    Returns (live (B, C) bool, score (B,) int32, mm (B,) int32), the
    results of :func:`span_walk_plain`.

    CUDA tensors launch ``csrc/fused_span_walk.cu`` (or raise); CPU tensors
    take :func:`span_walk_plain`.  ``fused_span_walk.launches`` counts
    kernel launches.
    """
    B, C, n_rows, n_words = _check_args(packed, anchor, rows, offs, live0,
                                        t, bucket, lib)
    dev = packed.device
    if dev.type == "cpu":
        return span_walk_plain(packed, anchor, rows, offs, live0, t,
                               bucket=bucket, lib=lib)
    if dev.type != "cuda":
        raise ValueError(f"fused_span_walk: unsupported device {dev}")
    kernel = _kernel_lib()
    live = torch.empty((B, C), dtype=torch.bool, device=dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    mm = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel.nimble_fused_span_walk(
            packed.data_ptr(), anchor.data_ptr(), rows.data_ptr(),
            offs.data_ptr(), live0.data_ptr(),
            None if lib is None else lib.data_ptr(),
            t.row_starts.data_ptr(), t.row_lengths.data_ptr(),
            t.ref_codes_packed.data_ptr(),
            live.data_ptr(), score.data_ptr(), mm.data_ptr(),
            n_rows, n_words, B, C, bucket, t.k, t.ref_pad, stream,
        )
    if err:
        msg = kernel.nimble_cuda_error_string(err).decode()
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
    """Arguments of :func:`fused_span_walk_plain` for (B, C) candidates
    given as row ids and anchor offsets in those rows: the torch glue of
    ``_span_walk_abs_fused`` (the word gather), which the CUDA kernel does
    itself.  ``lib`` (B,): each read's library in stacked tables."""
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
