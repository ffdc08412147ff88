"""The port's double walk vs the JAX package's, bit for bit.

``double_walk_plain`` (and the ``double_walk`` wrapper, which takes it for
CPU tensors) must reproduce ``pallas_double_walk`` (the Pallas kernel, in
interpret mode on the CPU) and two passes of ``engine_fast._walk_scan_t``
on random masks, including a left walk with another step count and the
one-step all-zero left walk.  ``span_walk_rel`` (mask glue + double walk)
must reproduce ``engine_fast._span_walk_rel(use_pallas=True)`` and, with the
main path's ``l_steps``, the fused walk; the compact pass with
``walk="double"`` must equal the JAX engine's ``use_pallas=True`` pass.
Every output is an integer or a bool: exact equality.  The wrapper's tile
plan (reads per tile against the shared memory) is checked on the CPU.
The CUDA cases hold the kernel to the plain version where a card is present,
at the edges of its tiling and staging (step counts around its 4-step
words, 1 to 32 candidates, batches that are not a multiple of the tile,
masks that are contiguous slices not aligned to 16 bytes); they need no jax
(``python -m pytest --noconftest -m cuda tests/test_torch_double_walk.py``
on a GPU machine).
"""

import numpy as np
import pytest
import torch

from nimble_tpu_torch.ops import double_walk as dw
from nimble_tpu_torch.ops import span_walk as sw
from nimble_tpu_torch.ops.device_tables import IndexTables

from test_torch_span_walk import K, _random_case


def _random_masks(rng, B, C, T, Tl):
    """int8 0/1 masks; alive/active decay like real walks, match is not
    always a subset of alive (the step rule takes ``live & match``), and
    ``Tl == 0`` gives the one-step all-zero left walk of ``l_steps = 0``."""
    def decaying(shape, p):
        return np.sort((rng.random(shape) < p).astype(np.int8),
                       axis=-1)[..., ::-1].copy()

    f_alive = decaying((B, C, T), 0.85)
    f_match = (rng.random((B, C, T)) < 0.75).astype(np.int8) & f_alive
    f_match[::5] = (rng.random(f_match[::5].shape) < 0.5)
    f_active = decaying((B, T), 0.9)
    if Tl == 0:
        l_alive = l_match = np.zeros((B, C, 1), dtype=np.int8)
        l_active = np.zeros((B, 1), dtype=np.int8)
    else:
        l_alive = decaying((B, C, Tl), 0.6)
        l_match = (rng.random((B, C, Tl)) < 0.7).astype(np.int8) & l_alive
        l_active = decaying((B, Tl), 0.7)
    live0 = (rng.random((B, C)) < 0.8).astype(np.int8)
    live0[::9] = 0
    return dict(f_alive=f_alive, f_match=f_match, f_active=f_active,
                l_alive=l_alive, l_match=l_match, l_active=l_active,
                live0=live0)


def _torch(masks, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in masks.items()}


def _jax_pallas(masks):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from nimble_tpu.ops.pallas_walk import pallas_double_walk

    with pltpu.force_tpu_interpret_mode():
        out = pallas_double_walk(
            *(jnp.asarray(masks[k]) for k in (
                "f_alive", "f_match", "f_active", "l_alive", "l_match",
                "l_active", "live0")), tile_b=128)
    return [np.asarray(x) for x in out]


def _jax_scan(masks):
    import jax.numpy as jnp

    from nimble_tpu.ops.engine_fast import _walk_scan_t

    def tcb(x):
        return jnp.transpose(jnp.asarray(x != 0), (2, 1, 0))

    def tb(x):
        return jnp.transpose(jnp.asarray(x != 0), (1, 0))

    live = jnp.asarray(masks["live0"] != 0).T
    live, s1, m1 = _walk_scan_t(live, tcb(masks["f_alive"]),
                                tcb(masks["f_match"]), tb(masks["f_active"]))
    live, s2, m2 = _walk_scan_t(live, tcb(masks["l_alive"]),
                                tcb(masks["l_match"]), tb(masks["l_active"]))
    return np.asarray(live).T, np.asarray(s1 + s2), np.asarray(m1 + m2)


MASK_CASES = [  # (seed, B, C, T, Tl)
    (0, 256, 8, 32, 32), (1, 128, 8, 62, 62), (2, 128, 8, 66, 20),
    (3, 256, 5, 17, 0), (4, 128, 16, 40, 9),
]


@pytest.mark.parametrize("seed,B,C,T,Tl", MASK_CASES)
def test_plain_matches_pallas_and_scan(seed, B, C, T, Tl):
    masks = _random_masks(np.random.default_rng(seed), B, C, T, Tl)
    live, score, mm = dw.double_walk_plain(**_torch(masks))
    assert live.dtype == torch.int8 and score.dtype == torch.int32
    p_live, p_score, p_mm = _jax_pallas(masks)
    s_live, s_score, s_mm = _jax_scan(masks)
    np.testing.assert_array_equal(live.numpy(), p_live)
    np.testing.assert_array_equal(score.numpy(), p_score)
    np.testing.assert_array_equal(mm.numpy(), p_mm)
    np.testing.assert_array_equal(live.numpy().astype(bool), s_live)
    np.testing.assert_array_equal(score.numpy(), s_score)
    np.testing.assert_array_equal(mm.numpy(), s_mm)
    assert int(score.sum()) > 0 and int(mm.sum()) > 0


def test_wrapper_takes_plain_version_on_cpu():
    masks = _torch(_random_masks(np.random.default_rng(5), 128, 8, 30, 12))
    before = dw.double_walk.launches
    got = dw.double_walk(**masks)
    want = dw.double_walk_plain(**masks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert dw.double_walk.launches == before  # no kernel on the CPU


def test_wrapper_rejects_bad_arguments():
    masks = _torch(_random_masks(np.random.default_rng(6), 128, 8, 30, 12))
    with pytest.raises(ValueError, match="f_match"):
        dw.double_walk(**dict(masks, f_match=masks["f_match"].bool()))
    with pytest.raises(ValueError, match="l_active"):
        dw.double_walk(**dict(masks, l_active=masks["l_active"][:, :5]))
    with pytest.raises(ValueError, match="contiguous"):
        dw.double_walk(**dict(
            masks, live0=masks["live0"].t().contiguous().t()))
    with pytest.raises(ValueError, match="candidate count"):
        big = _torch(_random_masks(np.random.default_rng(7), 128, 33, 4, 4))
        dw.double_walk(**big)


@pytest.mark.parametrize("B,C,T,Tl", [
    (8192, 8, 62, 62), (8192, 8, 66, 66), (8192, 8, 62, 1), (1, 1, 1, 1),
    (33, 32, 130, 130), (8193, 16, 17, 63), (5, 8, 0, 9), (8192, 32, 1000, 1),
])
def test_tile_plan_fits_the_shared_memory(B, C, T, Tl):
    """The tile is the largest up to min(B, MAX_TILE) reads that fits the
    target, or one read; the layout never shrinks as a dimension grows."""
    optin = 232448  # an H100's opt-in maximum
    R = dw.tile_reads(B, C, T, Tl, optin)
    assert 1 <= R <= min(B, dw.MAX_TILE)
    assert R == 1 or dw.smem_bytes(R, C, T, Tl) <= dw.SMEM_TARGET
    if R < min(B, dw.MAX_TILE):
        assert dw.smem_bytes(R + 1, C, T, Tl) > dw.SMEM_TARGET
    assert dw.smem_bytes(R, C, T, Tl) <= optin
    base = dw.smem_bytes(R, C, T, Tl)
    for grown in ((R + 1, C, T, Tl), (R, C + 1, T, Tl), (R, C, T + 5, Tl),
                  (R, C, T, Tl + 5 + max(T, Tl))):
        assert dw.smem_bytes(*grown) >= base
    # two staging buffers of one walk and two sets of packed words
    S = max(T, Tl)
    assert base >= 2 * R * (2 * C + 1) * S + 2 * 2 * R * S


def test_tile_plan_refuses_a_read_over_the_opt_in_maximum():
    assert dw.tile_reads(64, 32, 1500, 62, 232448) == 1
    with pytest.raises(ValueError, match="opt in"):
        dw.tile_reads(64, 32, 1800, 62, 232448)
    with pytest.raises(ValueError, match="opt in"):
        dw.tile_reads(64, 8, 62, 62, 1024)


def _sliced(masks, device):
    """The masks as contiguous slices x[1:] of one-read-longer tensors: the
    data starts C*T (or T, or C) bytes into its storage, not 16-aligned."""
    out = {}
    for k, v in masks.items():
        pad = np.concatenate([np.ones_like(v[:1]), v])
        out[k] = torch.from_numpy(pad).to(device)[1:]
        assert out[k].is_contiguous() and out[k].storage_offset() > 0
    return out


def test_wrapper_on_cpu_takes_sliced_masks():
    rng = np.random.default_rng(8)
    masks = _random_masks(rng, 70, 5, 17, 9)
    got = dw.double_walk(**_sliced(masks, "cpu"))
    want = dw.double_walk_plain(**_torch(masks))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tables(case, ref_pad):
    i32 = lambda a: torch.from_numpy(np.array(a).astype(np.int32))  # noqa: E731
    empty = torch.zeros(1, dtype=torch.int32)
    return IndexTables(
        k=K, width=8, max_probe=1, bucket_mask=0, ref_pad=ref_pad,
        bkey_lo=empty, bkey_hi=empty, bkey_fp=empty, bstart=empty,
        bcount=empty, postings_row=empty, postings_off=empty,
        ref_codes_packed=torch.from_numpy(
            np.array(case["ref_codes_packed"]).view(np.int32)),
        row_starts=i32(case["row_starts"]),
        row_lengths=i32(case["row_lengths"]),
    )


def _rel_args(case):
    i32 = lambda a: torch.from_numpy(np.array(a).astype(np.int32))  # noqa: E731
    return (i32(case["reads_i32"]), i32(case["read_lens"]),
            i32(case["anchor"]).long(), i32(case["rows"]).long(),
            i32(case["offs"]).long(), torch.from_numpy(np.array(case["live0"])))


@pytest.mark.parametrize("Lmax", [64, 92, 96, 128])
def test_span_walk_rel_matches_jax(Lmax):
    """The relative-coordinate glue + double walk against the JAX function
    at the main path's l_steps = Lmax - k, a short left walk and none; the
    main-path case also equals the fused walk."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from nimble_tpu.ops.engine_fast import _span_walk_abs_fused, _span_walk_rel

    rng = np.random.default_rng(Lmax)
    case, ref_pad = _random_case(rng, 128, Lmax, C=8)
    jcase = {name: jnp.asarray(v) for name, v in case.items()}
    tables = _tables(case, ref_pad)
    for l_steps in (Lmax - K, 7, 0):
        with pltpu.force_tpu_interpret_mode():
            want = _span_walk_rel(**jcase, k=K, ref_pad=ref_pad,
                                  l_steps=l_steps, use_pallas=True)
        got = sw.span_walk_rel(*_rel_args(case), tables, l_steps=l_steps)
        assert got[0].dtype == torch.bool
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if l_steps == Lmax - K:
            fused = _span_walk_abs_fused(**jcase, k=K, ref_pad=ref_pad)
            for g, w in zip(got, fused):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert int(got[1].sum()) > 0


def test_unpack_span_matches_jax():
    from nimble_tpu.ops.engine_fast import _unpack_span

    rng = np.random.default_rng(4)
    words = rng.integers(0, 2**32, (300, 9), dtype=np.uint64).astype(np.uint32)
    phase = rng.integers(0, 16, 300).astype(np.int32)
    want = np.asarray(_unpack_span(words, phase, 120))
    got = sw.unpack_span(torch.from_numpy(words.view(np.int32)),
                         torch.from_numpy(phase), 120)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bucket", [64, 92, 96, 128])
def test_compact_double_walk_matches_jax(bucket):
    """probe_walk_filter(walk="double") against the JAX compact pass with
    use_pallas=True, and against the port's own fused walk."""
    import types

    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from nimble_tpu.models.aligner import DeviceAlignEngine
    from nimble_tpu.ops import engine_fast as ef
    from nimble_tpu.ops.device_index import build_bucketed_index
    from nimble_tpu_torch.ops.compact import probe_walk_filter
    from nimble_tpu_torch.ops.device_tables import (
        FilterScalars,
        s_min_table,
        tables_from_bucketed_index,
    )
    from test_torch_compact import _cfg, _library, _packed, _reads

    rng = np.random.default_rng(bucket + 1)
    doubled, index = _library(rng)
    bidx = build_bucketed_index(index)
    lo = 40 if bucket == 64 else bucket - 30
    mat, lens = _reads(rng, doubled, 200, lo, bucket, junk_prefix=12)
    buf = _packed(mat, lens, bucket)
    cfg = _cfg()
    ns = types.SimpleNamespace(config=cfg, _s_min_cache={})
    s_min = DeviceAlignEngine._s_min_table(ns, bucket)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ef.probe_walk_filter_packed_chunked(
            jnp.asarray(buf[None]),
            *(jnp.asarray(getattr(bidx, f)) for f in (
                "bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount",
                "postings_row", "postings_off", "ref_codes_packed",
                "row_starts", "row_lengths")),
            jnp.asarray(s_min), jnp.asarray(np.int32(cfg.score_threshold)),
            jnp.asarray(np.int32(cfg.num_mismatches)),
            jnp.asarray(np.bool_(cfg.discard_multiple_matches)),
            jnp.asarray(np.bool_(cfg.discard_nonzero_mismatch)),
            k=bidx.k, max_probe=bidx.max_probe, c_max=8,
            bucket_mask=bidx.n_buckets - 1, p_limit=bucket - bidx.k + 1,
            ref_pad=bidx.ref_pad, bucket=bucket, use_pallas=True,
            one_col=False))[0]
    t = tables_from_bucketed_index(bidx, "cpu")
    args = (torch.from_numpy(buf), t, FilterScalars.from_config(cfg),
            torch.from_numpy(s_min_table(cfg.score_percent, bucket)))
    got = probe_walk_filter(*args, bucket=bucket, c_max=8, walk="double")
    np.testing.assert_array_equal(got.numpy(), want)
    fused = probe_walk_filter(*args, bucket=bucket, c_max=8, walk="fused")
    assert torch.equal(got, fused)
    assert ((want[:, 1] >> 16) & 1).sum() > 20


def test_unknown_walk_is_refused():
    from nimble_tpu_torch.ops.compact import walk_candidates

    with pytest.raises(ValueError, match="walk="):
        walk_candidates(None, None, bucket=92, walk="scan")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,C,T,Tl", MASK_CASES + [
    (10, 8192, 8, 62, 62), (11, 8192, 8, 66, 66), (12, 8192, 8, 62, 0),
    (13, 300, 3, 5, 1), (14, 257, 32, 70, 70),
])
def test_cuda_kernel_matches_plain(cuda_device, seed, B, C, T, Tl):
    masks = _torch(_random_masks(np.random.default_rng(seed), B, C, T, Tl),
                   cuda_device)
    before = dw.double_walk.launches
    got = dw.double_walk(**masks)
    torch.cuda.synchronize()
    assert dw.double_walk.launches == before + 1
    want = dw.double_walk_plain(**masks)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


EDGE_CASES = (  # (seed, B, C, T, Tl)
    [(20 + i, 300, 8, T, T) for i, T in enumerate(
        (1, 15, 16, 17, 63, 64, 65, 130))]
    + [(30, 300, 8, 1, 130), (31, 300, 8, 130, 1), (32, 300, 8, 0, 17),
       (33, 300, 8, 65, 0)]
    + [(40 + i, 257, C, 40, 23) for i, C in enumerate((1, 5, 8, 16, 32))]
    + [(50 + i, B, 8, 62, 62) for i, B in enumerate((1, 31, 33, 8193))]
)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,C,T,Tl", EDGE_CASES)
def test_cuda_kernel_edges_match_plain(cuda_device, seed, B, C, T, Tl):
    """Step counts around the kernel's 4-step words and above 64, 0-step
    walks, 1 to 32 candidates (1 to 4 groups of 8), batches off the tile."""
    masks = _torch(_random_masks(np.random.default_rng(seed), B, C, T, Tl),
                   cuda_device)
    before = dw.double_walk.launches
    got = dw.double_walk(**masks)
    torch.cuda.synchronize()
    assert dw.double_walk.launches == before + 1
    for g, w in zip(got, dw.double_walk_plain(**masks)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,T,Tl", [(8192, 8, 62, 62), (300, 5, 17, 9),
                                      (33, 32, 63, 1)])
def test_cuda_kernel_on_misaligned_slices(cuda_device, B, C, T, Tl):
    """Masks that are contiguous slices x[1:], their data not 16-byte
    aligned: the kernel stages each range over its aligned envelope."""
    masks = _random_masks(np.random.default_rng(B + C), B, C, T, Tl)
    sliced = _sliced(masks, cuda_device)
    assert any(v.data_ptr() % 16 for v in sliced.values())
    got = dw.double_walk(**sliced)
    torch.cuda.synchronize()
    want = dw.double_walk_plain(**_torch(masks, cuda_device))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_layout_matches_the_wrapper_mirror(cuda_device):
    lib = dw._kernel_lib()
    for R, C, T, Tl in ((24, 8, 62, 62), (1, 32, 130, 1), (7, 5, 0, 17)):
        assert lib.nimble_double_walk_smem(R, C, T, Tl) == dw.smem_bytes(
            R, C, T, Tl)


@pytest.mark.cuda
@pytest.mark.parametrize("Lmax,l_steps", [(92, 62), (96, 66), (92, 0),
                                          (128, 9)])
def test_cuda_span_walk_rel_matches_plain(cuda_device, Lmax, l_steps):
    case, ref_pad = _random_case(np.random.default_rng(Lmax), 8192, Lmax,
                                 C=8)
    tables = _tables(case, ref_pad)
    tables = IndexTables(**{
        f: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
        for f, v in vars(tables).items()})
    args = [a.to(cuda_device) for a in _rel_args(case)]
    masks = sw.rel_walk_masks(*args, tables, l_steps=l_steps)
    got = dw.double_walk(**masks)
    want = dw.double_walk_plain(**masks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    live, score, mm = sw.span_walk_rel(*args, tables, l_steps=l_steps)
    assert torch.equal(live, got[0] != 0) and torch.equal(score, got[1])
