"""The port's gather-probe ops vs the probe's Pallas kernels, bit for bit.

``ops.gather``'s plain versions (which the wrappers take for CPU tensors)
must give ``jnp.take`` / ``jnp.take_along_axis`` and the three Pallas
kernel bodies of ``scripts/probe_mosaic_gather.py`` (``k_take`` :71-72,
``k_taa`` :94-98, ``k_lane`` :123-125), run through ``pl.pallas_call`` with
the script's ``pltpu.VMEM`` specs in interpret mode on the CPU.  The
kernels are closures inside the script's ``main()``, so their one-line
bodies are restated here.  Tables hold uint32 values with the top bit set,
viewed as int32 in the port.  ``probe_gather``'s torch sub-ops must equal
the script's XLA sub-ops, and its entry must report ``match=True`` for the
three gathers.  Every value is an integer: exact equality.

The CUDA cases hold the kernels of ``csrc/gather_rows.cu`` to the plain
versions, with tables below and above 48 KiB of shared memory, and a table
above the card's opt-in maximum, which must be refused; ``gather_lane``,
which stages one table row per block, also at one row, rows whose bytes are
not a multiple of 16, ragged M, a table over the whole-table limit whose
rows fit (taken), and a row over the limit (refused).  They need no jax
(``python -m pytest --noconftest -m cuda tests/test_torch_gather.py`` on a
GPU machine); this module imports jax only inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from nimble_tpu_torch import probe_gather
from nimble_tpu_torch.ops import gather as g

SHAPES = [(256, 8, 1024), (4096, 8, 2048), (37, 8, 300), (64, 5, 129),
          (1, 4, 17), (4097, 1, 1001)]


def _inputs(seed, N, W, M):
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    tab[0, 0] = 0xFFFFFFFF
    tab[-1, -1] = 0x80000000
    idx = rng.integers(0, N, size=(M,), dtype=np.int32)
    idx2 = rng.integers(0, N, size=(M, W), dtype=np.int32)
    return tab, idx, idx2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            if a.dtype == np.uint32 else a)


def _pallas(body, out_shape, *args):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    return np.asarray(pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("N,W,M", SHAPES)
def test_take_matches_jnp_take_and_pallas_body(N, W, M):
    import jax.numpy as jnp

    tab, idx, _ = _inputs(N + M, N, W, M)

    def k_take(tab_ref, idx_ref, out_ref):  # probe_mosaic_gather.py:71-72
        out_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)

    want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(_pallas(k_take, (M, W), tab, idx), want)
    got = g.gather_take(_t(tab), _t(idx))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, W)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("N,W,M", SHAPES)
def test_taa_matches_take_along_axis_and_pallas_body(N, W, M):
    import jax.numpy as jnp

    tab, idx, idx2 = _inputs(2 * N + M, N, W, M)

    def k_taa(tab_ref, idx_ref, out_ref):  # probe_mosaic_gather.py:94-98
        ii = idx_ref[:].reshape(-1, 1)
        out_ref[:] = jnp.take_along_axis(
            tab_ref[:], jnp.broadcast_to(ii, (M, W)), axis=0)

    bcast = np.broadcast_to(idx[:, None], (M, W))
    want = np.asarray(jnp.take_along_axis(
        jnp.asarray(tab), jnp.asarray(bcast), axis=0))
    np.testing.assert_array_equal(_pallas(k_taa, (M, W), tab, idx), want)
    got = g.gather_taa(_t(tab), _t(np.ascontiguousarray(bcast)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the general form: a different row per column
    want2 = np.asarray(jnp.take_along_axis(
        jnp.asarray(tab), jnp.asarray(idx2), axis=0))
    got2 = g.gather_taa(_t(tab), _t(idx2))
    np.testing.assert_array_equal(got2.numpy().view(np.uint32), want2)


@pytest.mark.parametrize("N,W,M", SHAPES)
def test_lane_matches_take_along_axis_and_pallas_body(N, W, M):
    import jax.numpy as jnp

    tab, idx, idx2 = _inputs(3 * N + M, N, W, M)
    tab_t = np.ascontiguousarray(tab.T)

    def k_lane(tab_ref, idx_ref, out_ref):  # probe_mosaic_gather.py:123-125
        ii = jnp.broadcast_to(idx_ref[:].reshape(1, -1), (W, M))
        out_ref[:] = jnp.take_along_axis(tab_ref[:], ii, axis=1)

    want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx), axis=0)).T
    np.testing.assert_array_equal(_pallas(k_lane, (W, M), tab_t, idx), want)
    lanes = np.ascontiguousarray(np.broadcast_to(idx[None, :], (W, M)))
    got = g.gather_lane(_t(tab_t), _t(lanes))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    idx2_t = np.ascontiguousarray(idx2.T)
    want2 = np.asarray(jnp.take_along_axis(
        jnp.asarray(tab_t), jnp.asarray(idx2_t), axis=1))
    got2 = g.gather_lane(_t(tab_t), _t(idx2_t))
    np.testing.assert_array_equal(got2.numpy().view(np.uint32), want2)


def test_sub_ops_match_the_probe_xla_sub_ops():
    """probe_mosaic_gather.py:155-177 at a reduced batch."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    B, C, NWr, n_tab = 64, probe_gather.C, probe_gather.NWR, 512
    words = rng.integers(0, 2**32, size=(B * C, NWr + 1), dtype=np.uint32)
    words[0, :] = 0xFFFFFFFF
    phase = rng.integers(0, 16, size=(B * C,), dtype=np.int32)
    phase[:16] = np.arange(16)
    reads = rng.integers(0, 4, size=(B, 16 * NWr), dtype=np.int32)

    w, ph, rd = jnp.asarray(words), jnp.asarray(phase), jnp.asarray(reads)
    sh = (jnp.uint32(2) * ph.astype(jnp.uint32))[:, None]
    lo_w = w[:, :NWr] >> sh
    hi_w = (w[:, 1:NWr + 1] << (jnp.uint32(31) - sh)) << jnp.uint32(1)
    aligned = (lo_w | hi_w).reshape(B, C, NWr)
    j16 = (jnp.uint32(2) * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    rw = (rd.astype(jnp.uint32).reshape(B, NWr, 16) << j16).sum(
        axis=2, dtype=jnp.uint32)
    x = aligned ^ rw[:, None, :]
    want = np.asarray((~(x | (x >> jnp.uint32(1)))) & jnp.uint32(0x55555555))
    got = probe_gather.funnel_match(_t(words), torch.from_numpy(phase),
                                    torch.from_numpy(reads), B)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    packed = rng.integers(0, 2**32, size=(n_tab + 8,), dtype=np.uint32)
    idx = rng.integers(0, n_tab, size=(999,), dtype=np.int32)
    pj = jnp.asarray(packed)
    win = jnp.stack([pj[j:n_tab + j] for j in range(8)], axis=1)
    want_w = np.asarray(jnp.take(win, jnp.asarray(idx), axis=0))
    got_w = probe_gather.win_build_and_take(_t(packed), torch.from_numpy(idx)
                                            .to(torch.int64), n_tab)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32), want_w)


def test_probe_entry_on_the_cpu_reports_three_matches(capsys):
    rc = probe_gather.main(["--cpu", "--table-rows", "256", "--rows", "1024",
                            "--batch", "64"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("match=True") == 3 and "match=False" not in out
    for label in ("index_select", "gather_take", "gather_taa", "gather_lane",
                  "funnel+match", "win+take"):
        assert label in out


def test_probe_entry_without_a_card_exits(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_gather.main(["--rows", "16"]) != 0
    assert "match=" not in capsys.readouterr().out


@pytest.mark.parametrize("call,args,match", [
    (g.gather_take, (torch.zeros((4, 8), dtype=torch.int64),
                     torch.zeros(3, dtype=torch.int32)), "int32"),
    (g.gather_take, (torch.zeros((4, 8), dtype=torch.int32),
                     torch.zeros((3, 1), dtype=torch.int32)), "shape"),
    (g.gather_taa, (torch.zeros((4, 8), dtype=torch.int32),
                    torch.zeros((3, 4), dtype=torch.int32)), "shape"),
    (g.gather_lane, (torch.zeros((8, 4), dtype=torch.int32),
                     torch.zeros((4, 3), dtype=torch.int32)), "shape"),
    (g.gather_take, (torch.zeros((8, 4), dtype=torch.int32).t(),
                     torch.zeros(3, dtype=torch.int32)), "contiguous"),
    (g.gather_take, (torch.zeros((0, 8), dtype=torch.int32),
                     torch.zeros(3, dtype=torch.int32)), "empty"),
])
def test_wrappers_refuse_bad_arguments(call, args, match):
    with pytest.raises(ValueError, match=match):
        call(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (N, W, M): the probe's 128 KiB table, tables under 48 KiB, odd widths
# (the scalar paths), and 216 KiB, near the H100's 227 KiB opt-in maximum
CUDA_SHAPES = [(4096, 8, 65536), (256, 8, 1024), (1500, 8, 70001),
               (37, 5, 3001), (6912, 8, 4096), (1, 4, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,W,M", CUDA_SHAPES)
def test_cuda_kernels_match_plain(cuda_device, N, W, M):
    tab, idx, idx2 = (_t(a).to(cuda_device) for a in _inputs(N * M, N, W, M))
    tab_t = tab.t().contiguous()
    idx2_t = idx2.t().contiguous()
    for fn, plain, a, b in (
            (g.gather_take, g.gather_take_plain, tab, idx),
            (g.gather_taa, g.gather_taa_plain, tab, idx2),
            (g.gather_lane, g.gather_lane_plain, tab_t, idx2_t)):
        before = fn.launches
        got = fn(a, b)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.device.type == "cuda"
        assert torch.equal(got, plain(a, b)), fn.__name__


# (W, N, M) of gather_lane: one row; N * 4 not a multiple of 16 (the row
# starts off a 16-byte boundary); ragged M (the scalar path); 256 KiB and
# 864 KiB tables, over the whole-table limit, with rows of 16 and 108 KiB
LANE_SHAPES = [(1, 4096, 65536), (8, 4097, 65536), (8, 37, 3001),
               (3, 1001, 65537), (16, 4096, 65536), (4, 55296, 10000),
               (1, 1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,M", LANE_SHAPES)
def test_cuda_lane_kernel_edges_match_plain(cuda_device, W, N, M):
    rng = np.random.default_rng(W * N + M)
    tab_t = _t(rng.integers(0, 2**32, size=(W, N), dtype=np.uint32)).to(
        cuda_device)
    idx2 = _t(rng.integers(0, N, size=(W, M), dtype=np.int32)).to(
        cuda_device)
    before = g.gather_lane.launches
    got = g.gather_lane(tab_t, idx2)
    torch.cuda.synchronize()
    assert g.gather_lane.launches == before + 1
    assert torch.equal(got, g.gather_lane_plain(tab_t, idx2))
    # the same on a table that is a contiguous slice, 4 bytes into its
    # storage
    sliced = torch.cat([tab_t.flatten()[:1], tab_t.flatten()])[1:].view(W, N)
    assert torch.equal(g.gather_lane(sliced, idx2), got)


@pytest.mark.cuda
def test_cuda_kernels_clamp_out_of_range_indices(cuda_device):
    tab = torch.arange(40, dtype=torch.int32, device=cuda_device).reshape(
        10, 4)
    idx = torch.tensor([-5, 0, 9, 10, 1 << 30], dtype=torch.int32,
                       device=cuda_device)
    got = g.gather_take(tab, idx)
    want = tab[idx.clamp(0, 9).long()]
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_table_over_the_opt_in_maximum_is_refused(cuda_device):
    optin = torch.cuda.get_device_properties(cuda_device)
    limit = getattr(optin, "shared_memory_per_block_optin", 232448)
    N = limit // 32 + 1  # one (N, 8) int32 table just over the limit
    tab = torch.zeros((N, 8), dtype=torch.int32, device=cuda_device)
    idx = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    # gather_lane stages one row: a (2, N) table whose rows are each just
    # over the limit
    row = torch.zeros((2, limit // 4 + 1), dtype=torch.int32,
                      device=cuda_device)
    for fn, a, b in ((g.gather_take, tab, idx),
                     (g.gather_taa, tab, idx[:, None].expand(64, 8)
                      .contiguous()),
                     (g.gather_lane, row,
                      idx[None, :].expand(2, 64).contiguous())):
        before = fn.launches
        with pytest.raises(ValueError, match="opt in"):
            fn(a, b)
        assert fn.launches == before
