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

``gather_taa`` also takes ``k_taa``'s own broadcast index, the view
``idx[:, None].expand(M, W)``; other index layouts are refused.

A wrapper counts a launch only once its kernel has launched: not for an
empty output, a refused table or a failed launch (a stand-in kernel
library, so this runs on the CPU too).

The CUDA cases hold the kernels of ``csrc/gather_rows.cu`` to the plain
versions.  ``gather_take`` and ``gather_taa`` in both of their kernel's
designs (rows read unstaged; the general form's table copied into every
block): N odd and small, N = 1, odd W (the scalar paths), a table 4 bytes
into its storage, the broadcast index, and tables over the 227 KiB one
block can hold, which they take unstaged.  ``gather_lane``, which stages
one table row per block, at one row, rows whose bytes are not a multiple
of 16, ragged M, a table over the whole-table limit whose rows fit
(taken), and a row over the limit (refused).  They need no jax (``python
-m pytest --noconftest -m cuda tests/test_torch_gather.py`` on a GPU
machine); this module imports jax only inside the tests that use it.
"""

import contextlib
import types


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


@pytest.mark.parametrize("N,W,M", SHAPES)
def test_taa_on_the_broadcast_view_matches_pallas_k_taa(N, W, M):
    """``k_taa``'s own input: one (M,) index, broadcast over the row."""
    import jax.numpy as jnp

    tab, idx, _ = _inputs(5 * N + M, N, W, M)

    def k_taa(tab_ref, idx_ref, out_ref):  # probe_mosaic_gather.py:94-98
        ii = idx_ref[:].reshape(-1, 1)
        out_ref[:] = jnp.take_along_axis(
            tab_ref[:], jnp.broadcast_to(ii, (M, W)), axis=0)

    want = _pallas(k_taa, (M, W), tab, idx)
    view = _t(idx)[:, None].expand(M, W)
    assert view.stride() == (1, 0) or M == 1 or W == 1
    got = g.gather_taa(_t(tab), view)
    assert tuple(got.shape) == (M, W) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


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
    # index layouts: only taa takes a broadcast, and only of strides (1, 0)
    (g.gather_take, (torch.zeros((4, 8), dtype=torch.int32),
                     torch.zeros(6, dtype=torch.int32)[::2]), "contiguous"),
    (g.gather_taa, (torch.zeros((4, 8), dtype=torch.int32),
                    torch.zeros((8, 3), dtype=torch.int32).t()),
     r"strides \(1, 0\)"),
    (g.gather_taa, (torch.zeros((4, 8), dtype=torch.int32),
                    torch.zeros(6, dtype=torch.int32)[::2][:, None]
                    .expand(3, 8)), r"got strides \(2, 0\)"),
    (g.gather_taa, (torch.zeros((4, 8), dtype=torch.int32),
                    torch.zeros((1, 8), dtype=torch.int32).expand(3, 8)),
     r"got strides \(0, 1\)"),
    (g.gather_lane, (torch.zeros((8, 4), dtype=torch.int32),
                     torch.zeros(3, dtype=torch.int32)[None, :]
                     .expand(8, 3)), "contiguous"),
])
def test_wrappers_refuse_bad_arguments(call, args, match):
    with pytest.raises(ValueError, match=match):
        call(*args)


def test_gather_rows_refuses_a_cpu_table():
    """The kernel entry has no plain path: a CPU table is refused."""
    tab = torch.zeros((4, 8), dtype=torch.int32)
    before = g.gather_take.launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        g.gather_rows(g.gather_take, tab, torch.zeros(3, dtype=torch.int32))
    assert g.gather_take.launches == before


class _CardTensor:
    """Stands in for a CUDA tensor in front of a stand-in kernel library."""

    device = torch.device("cuda", 0)

    def __init__(self, *shape):
        self.shape = shape

    def data_ptr(self):
        return 0

    def numel(self):
        return int(np.prod(self.shape))


@pytest.mark.parametrize("M,rc,raises,counted", [
    (0, None, None, 0),  # empty output: nothing launched
    (5, 0, None, 1),
    (5, -1, ValueError, 0),  # the entry refused the table
    (5, 700, RuntimeError, 0),  # the launch failed
])
def test_launch_counts_only_a_launch_that_ran(monkeypatch, M, rc, raises,
                                              counted):
    calls = []
    lib = types.SimpleNamespace(
        nimble_gather_lane=lambda *a: calls.append(a) or rc,
        nimble_gather_smem_optin=lambda: 1024,
        nimble_gather_error_string=lambda e: b"launch failed")
    monkeypatch.setattr(g, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(g.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(g.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    before = g.gather_lane.launches
    out = _CardTensor(2, M)
    args = (g.gather_lane, "nimble_gather_lane", _CardTensor(2, 9),
            _CardTensor(2, M), out, (9, 2, M), lambda optin: "refused")
    if raises is None:
        assert g._launch(*args) is out
    else:
        with pytest.raises(raises):
            g._launch(*args)
    assert len(calls) == (M > 0)
    assert g.gather_lane.launches == before + counted


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


# (N, W, M) of gather_take / gather_taa: N odd, small, and N = 1, odd W
# (the scalar paths), a 512 KiB and a 1.25 MiB table (over the 227 KiB one
# block can hold: the general form unstaged too), the probe's table
ROW_SHAPES = [(4097, 8, 65536), (7, 8, 1000), (1, 8, 33), (1, 4, 17),
              (37, 5, 3001), (9, 3, 100), (16384, 8, 65536),
              (40000, 8, 5000), (4096, 8, 65536)]


def _row_cases(tab, idx, idx2):
    """(label, table, index, strides) of both forms, on the table and on a
    copy 4 bytes into its storage (staged copies then start off a 16-byte
    boundary, and the 16-byte paths give way to the scalar ones)."""
    N, W = tab.shape
    sliced = torch.cat([tab.flatten()[:1], tab.flatten()])[1:].view(N, W)
    for label, t in (("table", tab), ("sliced table", sliced)):
        yield label + ", take", t, idx, None
        yield label + ", broadcast", t, idx[:, None].expand(-1, W), (1, 0)
        yield label + ", general", t, idx2, (W, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("N,W,M", ROW_SHAPES)
def test_cuda_take_and_taa_edges_match_plain(cuda_device, N, W, M):
    tab, idx, idx2 = (_t(a).to(cuda_device) for a in _inputs(N + W + M, N, W,
                                                             M))
    want_take = g.gather_take_plain(tab, idx)
    for label, t, b, strides in _row_cases(tab, idx, idx2):
        fn = g.gather_take if strides is None else g.gather_taa
        before = fn.launches
        got = fn(t, b)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, label
        want = (want_take if strides in (None, (1, 0))
                else g.gather_taa_plain(tab, idx2))
        assert torch.equal(got, want), label


@pytest.mark.cuda
def test_cuda_kernels_clamp_out_of_range_indices(cuda_device):
    tab = torch.arange(40, dtype=torch.int32, device=cuda_device).reshape(
        10, 4)
    idx = torch.tensor([-5, 0, 9, 10, 1 << 30], dtype=torch.int32,
                       device=cuda_device)
    want = tab[idx.clamp(0, 9).long()]
    assert torch.equal(g.gather_take(tab, idx), want)
    assert torch.equal(g.gather_taa(tab, idx[:, None].expand(5, 4)), want)
    assert torch.equal(
        g.gather_taa(tab, idx[:, None].expand(5, 4).contiguous()), want)


def _optin(device) -> int:
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", 232448)


@pytest.mark.cuda
def test_cuda_table_over_the_opt_in_maximum_is_refused(cuda_device):
    """Take and taa refuse no table: the row form reads rows unstaged at
    every size; the general form copies the table into every block while a
    block can hold it (its 16-byte envelope: the table's bytes and 16),
    and reads it unstaged above.  Lane refuses a row over the opt-in
    maximum, and counts no launch."""
    limit = _optin(cuda_device)
    one = (limit - 16) // 32  # the largest (N, 8) table one block holds
    idx = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    small = torch.zeros((one, 8), dtype=torch.int32, device=cuda_device)
    mid = torch.zeros((one + 1, 8), dtype=torch.int32, device=cuda_device)
    big = torch.zeros((8 * (one + 1), 8), dtype=torch.int32,
                      device=cuda_device)
    for t in (small, mid, big):
        t[-1] = 7
    general = torch.full((64, 8), -1, dtype=torch.int32,
                         device=cuda_device).add_(1 << 30)  # clamped: last
    assert g.rows_design(small, general) == ("per-block", one * 32 + 16)
    assert g.rows_design(mid, general) == ("unstaged", 0)
    for t in (small, mid, big):
        last = torch.full_like(idx, t.shape[0] - 1)
        assert g.rows_design(t, last) == ("unstaged", 0)
        bcast = last[:, None].expand(64, 8)
        assert g.rows_design(t, bcast) == ("unstaged", 0)
        assert int(g.gather_take(t, last).min()) == 7
        assert int(g.gather_taa(t, bcast).min()) == 7
        assert int(g.gather_taa(t, general).min()) == 7
    row = torch.zeros((2, limit // 4 + 1), dtype=torch.int32,
                      device=cuda_device)
    before = g.gather_lane.launches
    with pytest.raises(ValueError, match="opt in"):
        g.gather_lane(row, idx[None, :].expand(2, 64).contiguous())
    assert g.gather_lane.launches == before
