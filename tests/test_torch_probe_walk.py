"""The ``probe_walk_filter`` kernel: its wrapper, its order, its plain twin.

``nimble_tpu_torch.ops.probe_walk.probe_walk`` launches
``csrc/probe_walk_filter.cu`` (probe, candidates, walk, filter and pack in
one launch) for CUDA tensors and takes its plain twin, the torch chain of
``ops.compact`` / ``ops.full``, for CPU tensors.  Here:

- the wrapper refuses, with ValueError, every argument the kernel does not
  take, in both modes and for single and stacked tables;
- the tables are checked once per tables object (``IndexTables.layout``,
  kept on the object), the gates and ``s_min`` on their first call with
  it, the packed rows and ``c_max`` on every call: a bad table is refused
  on its first call, a bad ``packed`` after good calls still is, and a new
  tables object is checked anew;
- in front of a stand-in kernel library, tensors that report a CUDA device
  reach the kernel entry as one argument block (``_ProbeTables``, whose
  layout equals ``csrc/probe_walk_tables.h``'s as the host's C++ compiler
  lays it out), entering no device context on the current device; the
  kernel's own refusals (bucket rows not 16-byte loadable, extents of
  2^31) raise ValueError, a failed build or launch raises instead of
  taking the plain chain, and ``probe_walk.launches`` counts only launches
  that ran;
- a scalar per-read probe in the kernel's own order (first position, first
  hop with a hit, lowest lane, verify that lane only, stop) equals the JAX
  package's ``_probe_bucketed`` bit for bit: phase-A splits, a crowded
  table (``max_probe`` 2), planted fingerprint collisions, zero-padded
  rows and reads of 30-41 bases;
- the stacked pass (every row against every library) equals each
  library's pass with its own tables;
- a kernel's build hash covers the headers its source includes.

The kernel itself is held to the plain twin where a card is present (the
``cuda`` cases, which need no jax: ``python -m pytest --noconftest -m cuda
tests/test_torch_probe_walk.py``).  Every output is an integer: exact
equality throughout.
"""

import ctypes
import dataclasses
import gc
import shutil
import subprocess
import types
import weakref

import numpy as np
import pytest
import torch

from nimble_tpu_torch.config import AlignFilterConfig
from nimble_tpu_torch.index.build import build_index
from nimble_tpu_torch.models.aligner import pack_reads
from nimble_tpu_torch.ops import _build, device_tables
from nimble_tpu_torch.ops import probe_walk as pw
from nimble_tpu_torch.ops.device_index import (
    EMPTY_SLOT,
    build_bucketed_index,
    insert_bucket_table,
    kmer_fp,
)
from nimble_tpu_torch.ops.device_tables import (
    FilterScalars,
    IndexTables,
    s_min_table,
    stack_tables,
    tables_from_bucketed_index,
)
from nimble_tpu_torch.utils.dna import encode_bases, revcomp
from nimble_tpu_torch.workload import allele_family

M32 = 0xFFFFFFFF
SALT = 0x7FEB352D  # the fingerprint's salt (ops/device_index.FP_SALT)


def _cfg(**kw):
    base = dict(score_percent=0.3, score_threshold=40, num_mismatches=1,
                max_hits_to_report=10)
    base.update(kw)
    return AlignFilterConfig(**base)


def _library(rng, n_feats=6, feat_len=300):
    """Random doubled library (each feature and its reverse complement)."""
    feats = ["".join(rng.choice(list("ACGT"), size=feat_len))
             for _ in range(n_feats)]
    doubled = [x for s in feats for x in (s, revcomp(s))]
    return doubled, build_index(doubled)


def _reads(rng, doubled, n, lo, hi, width, junk_prefix=0):
    """(n, width) int8 codes zero past each length in [lo, hi]: fragments
    of the library, ~20% with one substitution, ~10% junk, each after up
    to ``junk_prefix`` random bases (which move the anchor off 0)."""
    mat = np.zeros((n, width), dtype=np.int8)
    lens = rng.integers(lo, hi + 1, n).astype(np.int32)
    for i in range(n):
        L = int(lens[i])
        pre = min(int(rng.integers(0, junk_prefix + 1)), L)
        feat = encode_bases(doubled[int(rng.integers(0, len(doubled)))])
        s = int(rng.integers(0, len(feat) - (L - pre) + 1))
        r = np.concatenate([rng.integers(0, 4, pre).astype(np.int8),
                            feat[s : s + L - pre]])
        u = rng.random()
        if u < 0.2:
            j = int(rng.integers(0, L))
            r[j] = (r[j] + int(rng.integers(1, 4))) % 4
        elif u < 0.3:
            r = rng.integers(0, 4, L).astype(np.int8)
        mat[i, :L] = r
    return mat, lens


def _crowded(bidx, index):
    """``bidx`` rebuilt at too few buckets: linear-probe hops, max_probe
    >= 2."""
    keys = index.keys_sorted
    n_buckets = 1 << int(np.ceil(np.log2(len(keys) / (8 * 0.9))))
    lo = np.full((n_buckets, 8), EMPTY_SLOT, dtype=np.uint32)
    hi = np.full((n_buckets, 8), EMPTY_SLOT, dtype=np.uint32)
    st = np.zeros((n_buckets, 8), dtype=np.int32)
    ct = np.zeros((n_buckets, 8), dtype=np.int32)
    max_probe = insert_bucket_table(keys, index.post_starts[:-1],
                                    np.diff(index.post_starts), lo, hi, st,
                                    ct, 8)
    assert max_probe >= 2
    return dataclasses.replace(
        bidx, n_buckets=n_buckets, max_probe=max_probe, bkey_lo=lo,
        bkey_hi=hi, bkey_fp=kmer_fp(lo, hi), bstart=st, bcount=ct)


# --- the kernel's probe order, one read at a time -------------------------

def _fmix32(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _keys_at(codes, p, k):
    """The key halves of the k-mer at p: hi = bases [p, p + k/2), lo =
    [p + k/2, p + k), the first base most significant."""
    hi = lo = 0
    for j in range(k // 2):
        hi = (hi << 2) | int(codes[p + j])
    for j in range(k // 2, k):
        lo = (lo << 2) | int(codes[p + j])
    return lo, hi


def kernel_order_probe(codes, read_len, bidx, p_limit):
    """The probe as ``csrc/probe_walk_filter.cu`` orders it for one read:
    positions from 0 while a k-mer fits the read, the first hop with any
    fingerprint hit and the lowest lane in it; only that lane's full key
    is verified, and the search stops there, hit or collision.  Returns
    (has_anchor, anchor, bucket, lane, fp_bad)."""
    k = bidx.k
    fp_tab, lo_tab, hi_tab = bidx.bkey_fp, bidx.bkey_lo, bidx.bkey_hi
    mask = bidx.n_buckets - 1
    P = min(len(codes) - k + 1, p_limit)
    for p in range(min(P, int(read_len) - k + 1)):
        lo, hi = _keys_at(codes, p, k)
        h = _fmix32(lo ^ _fmix32(hi))
        fp = _fmix32((((hi << 16) | (hi >> 16)) & M32)
                     ^ _fmix32(lo ^ SALT))
        for hop in range(bidx.max_probe):
            b = (h + hop) & mask
            lanes = np.flatnonzero(fp_tab[b] == fp)
            if lanes.size:
                w = int(lanes[0])
                bad = int(lo_tab[b, w]) != lo or int(hi_tab[b, w]) != hi
                return True, p, b, w, bad
    return False, 0, 0, 0, False


def _probe_case(name):
    """(bucketed index, (n, Lmax) codes, lengths, phase_a) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    doubled, index = _library(rng, n_feats=8)
    bidx = build_bucketed_index(index)
    phase_a = 0
    if name.startswith("phase_a"):
        phase_a = int(name.split("=")[1])
        mat, lens = _reads(rng, doubled, 160, 60, 96, 96, junk_prefix=40)
    elif name == "max_probe 2":
        bidx = _crowded(bidx, index)
        mat, lens = _reads(rng, doubled, 160, 60, 92, 92, junk_prefix=20)
    elif name == "planted collisions":
        mat, lens = _reads(rng, doubled, 128, 60, 92, 92, junk_prefix=12)
        fp = bidx.bkey_fp.copy()
        for i in range(0, 128, 2):  # forge lane 0 of a k-mer's bucket
            p = int(rng.integers(0, 8))
            lo, hi = _keys_at(mat[i], p, bidx.k)
            fp[_fmix32(lo ^ _fmix32(hi)) & (bidx.n_buckets - 1), 0] = _fmix32(
                (((hi << 16) | (hi >> 16)) & M32) ^ _fmix32(lo ^ SALT))
        bidx = dataclasses.replace(bidx, bkey_fp=fp)
    elif name == "zero-padded rows":
        mat, lens = _reads(rng, doubled, 128, 40, 92, 92, junk_prefix=8)
        mat[::9], lens[::9] = 0, 0            # pad rows
        lens[1::9] = 92                       # zeros past a fragment's end
    else:  # reads of 30-41 bases
        mat, lens = _reads(rng, doubled, 160, 30, 41, 64, junk_prefix=6)
    return bidx, mat, lens, phase_a


PROBE_CASES = ["phase_a=1", "phase_a=4", "phase_a=16", "phase_a=1073741824",
               "max_probe 2", "planted collisions", "zero-padded rows",
               "reads of 30-41 bases"]


@pytest.mark.parametrize("name", PROBE_CASES)
def test_kernel_order_matches_jax_probe(name):
    import jax.numpy as jnp

    from nimble_tpu.ops import engine_fast as ef

    bidx, mat, lens, phase_a = _probe_case(name)
    Lmax = mat.shape[1]
    p_limit = Lmax - bidx.k + 1
    want = [np.asarray(x) for x in ef._probe_bucketed(
        jnp.asarray(mat, dtype=jnp.int32), jnp.asarray(lens),
        jnp.asarray(bidx.bkey_lo), jnp.asarray(bidx.bkey_hi),
        jnp.asarray(bidx.bkey_fp), k=bidx.k, max_probe=bidx.max_probe,
        bucket_mask=bidx.n_buckets - 1, p_limit=p_limit, phase_a=phase_a)]
    got = np.array([kernel_order_probe(mat[i], lens[i], bidx, p_limit)
                    for i in range(mat.shape[0])], dtype=np.int64).T
    for field, g, w in zip(("has_anchor", "anchor", "bucket", "lane",
                            "fp_bad"), got, want):
        np.testing.assert_array_equal(g, w.astype(np.int64), err_msg=field)
    assert got[0].sum() > 0 and (got[0] == 0).sum() > 0
    if name == "planted collisions":
        assert got[4].sum() > 10
    if name.startswith("phase_a"):
        assert (got[1] >= 16).sum() > 0  # anchors past a phase-A boundary


# --- inputs of the pass ---------------------------------------------------

def _single(seed=3, bucket=92, c_max=8, n=96):
    """(packed (n, .) uint8, tables, scalars, s_min, bucket, c_max)."""
    rng = np.random.default_rng(seed)
    doubled, index = _library(rng, feat_len=max(300, bucket + 100))
    t = tables_from_bucketed_index(build_bucketed_index(index), "cpu")
    mat, lens = _reads(rng, doubled, n, 50, bucket, bucket, junk_prefix=10)
    cfg = _cfg()
    return (torch.from_numpy(pack_reads(mat, lens, bucket)), t,
            FilterScalars.from_config(cfg),
            torch.from_numpy(s_min_table(cfg.score_percent, bucket)),
            bucket, c_max)


def _allele_family(seed=7, bucket=92, c_max=8, n=96):
    """The same on ``workload.allele_family``'s library (8 alleles of one
    1,500 bp feature at 1% divergence, doubled) and 90 bp reads from it:
    most reads keep several candidates live through the walk."""
    _feats, doubled, mat = allele_family(n_reads=n, seed=seed)
    t = tables_from_bucketed_index(build_bucketed_index(build_index(doubled)),
                                   "cpu")
    cfg = _cfg()
    lens = np.full(n, mat.shape[1], dtype=np.int32)
    return (torch.from_numpy(pack_reads(mat, lens, bucket)), t,
            FilterScalars.from_config(cfg),
            torch.from_numpy(s_min_table(cfg.score_percent, bucket)),
            bucket, c_max)


def _stacked_parts(seed, bucket, n):
    """(indexes, configs, packed reads) of three libraries of different
    sizes and gates, the reads drawn from each in turn."""
    rng = np.random.default_rng(seed)
    libs = [_library(rng, n_feats=f, feat_len=L)
            for f, L in ((6, 300), (3, 500), (9, 200))]
    cfgs = [_cfg(), _cfg(score_threshold=30, num_mismatches=0,
                         discard_multiple_matches=True),
            _cfg(score_percent=0.5, discard_nonzero_mismatch=True)]
    mat = np.zeros((n, bucket), dtype=np.int8)
    lens = np.zeros(n, dtype=np.int32)
    for i, (doubled, _ix) in enumerate(libs):
        part, plens = _reads(rng, doubled, n // 3 + 1, 50, bucket, bucket,
                             junk_prefix=10)
        mat[i::3], lens[i::3] = part[: len(mat[i::3])], plens[: len(lens[i::3])]
    return ([ix for _d, ix in libs], cfgs,
            torch.from_numpy(pack_reads(mat, lens, bucket)))


def _stacked(seed=5, bucket=92, c_max=8, n=64):
    """The same for the three stacked libraries of ``_stacked_parts``."""
    indexes, cfgs, packed = _stacked_parts(seed, bucket, n)
    st = stack_tables(indexes, [build_bucketed_index(ix) for ix in indexes],
                      cfgs, "cpu")
    return packed, st, st.scalars, st.s_min(bucket), bucket, c_max


def _call(args, full):
    packed, t, scalars, s_min, bucket, c_max = args
    if full:
        scalars = s_min = None
    return pw.probe_walk(packed, t, bucket=bucket, c_max=c_max,
                         scalars=scalars, s_min=s_min)


# --- the wrapper's checks -------------------------------------------------

def _bad_inputs():
    """(label, function of (args, full) -> call, message) per refusal."""
    def with_table(name, fn):
        def call(a, full):
            t = dataclasses.replace(a[1], **{name: fn(getattr(a[1], name))})
            return _call((a[0], t) + a[2:], full)
        return call

    return [
        ("packed dtype", lambda a, f: _call((a[0].int(),) + a[1:], f),
         "packed"),
        ("packed width", lambda a, f: _call(
            (a[0][:, :-1].contiguous(),) + a[1:], f), "packed"),
        ("c_max 17", lambda a, f: _call(a[:5] + (17,), f), "c_max"),
        ("k over 32", lambda a, f: _call(
            (a[0], dataclasses.replace(a[1], k=33)) + a[2:], f), "k="),
        ("table dtype", with_table("bstart", lambda x: x.long()), "bstart"),
        ("table shape", with_table("bkey_hi", lambda x: x[..., :4]),
         "bkey_hi"),
        ("table layout", with_table(
            "postings_off", lambda x: torch.stack([x, x], -1)[..., 0]),
         "contiguous"),
        ("table device", with_table(
            "row_lengths", lambda x: torch.empty_like(x, device="meta")),
         "row_lengths is on meta"),
        ("reference words", with_table(
            "ref_codes_packed", lambda x: x[..., :3].contiguous()),
         "ref_codes_packed"),
    ]


BAD = _bad_inputs()


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
@pytest.mark.parametrize("label,call,match", BAD, ids=[b[0] for b in BAD])
def test_wrapper_refuses_bad_arguments(label, call, match, full, stacked):
    args = (_stacked if stacked else _single)(n=8)
    before = pw.probe_walk.launches
    with pytest.raises(ValueError, match=match):
        call(args, full)
    assert pw.probe_walk.launches == before


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
def test_wrapper_refuses_mismatched_gates(stacked):
    packed, t, scalars, s_min, bucket, c_max = (
        _stacked if stacked else _single)(n=8)
    with pytest.raises(ValueError, match="scalars and s_min"):
        pw.probe_walk(packed, t, bucket=bucket, c_max=c_max, scalars=scalars)
    with pytest.raises(ValueError, match="s_min"):
        pw.probe_walk(packed, t, bucket=bucket, c_max=c_max, scalars=scalars,
                      s_min=s_min[..., None])
    if stacked:  # one library's Python gates on stacked tables
        with pytest.raises(ValueError, match="scalars.score_threshold"):
            pw.probe_walk(packed, t, bucket=bucket, c_max=c_max,
                          scalars=FilterScalars.from_config(_cfg()),
                          s_min=s_min)
    else:  # one library's tables take one library's (1-d) s_min
        with pytest.raises(ValueError, match="s_min"):
            pw.probe_walk(packed, t, bucket=bucket, c_max=c_max,
                          scalars=scalars, s_min=s_min[None])


@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
def test_other_devices_are_refused(full):
    """A tensor on neither the CPU nor a card raises: no plain fallback."""
    packed, t, scalars, s_min, bucket, c_max = _single(n=8)
    meta = lambda x: torch.empty_like(x, device="meta")  # noqa: E731
    t = IndexTables(**{f: meta(v) if isinstance(v, torch.Tensor) else v
                       for f, v in vars(t).items()})
    with pytest.raises(ValueError, match="unsupported device meta"):
        _call((meta(packed), t, scalars, meta(s_min), bucket, c_max), full)


# --- the launch, in front of a stand-in kernel library --------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: stands in for a card's
    tensor in front of a stand-in kernel library."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(args):
    packed, t, scalars, s_min, bucket, c_max = args
    card = lambda x: x.as_subclass(_OnCard)  # noqa: E731
    t = type(t)(**{f: card(v) if isinstance(v, torch.Tensor) else v
                   for f, v in vars(t).items()})
    if isinstance(scalars.score_threshold, torch.Tensor):
        scalars = FilterScalars(**{f: card(v)
                                   for f, v in vars(scalars).items()})
    return card(packed), t, scalars, card(s_min), bucket, c_max


@pytest.fixture
def stand_in(monkeypatch):
    """A stand-in kernel library returning ``state["rc"]``; the plain chain
    and the CUDA runtime calls are replaced so that neither can run.  The
    current device is ``state["current"]``; ``state["entered"]`` records
    the device contexts entered."""
    state = {"rc": 0, "calls": [], "current": 0, "entered": []}

    def launch(block, *rest):
        state["calls"].append((_copy_block(block),) + rest)
        return state["rc"]

    lib = types.SimpleNamespace(
        nimble_probe_walk_filter=launch,
        nimble_cuda_error_string=lambda e: b"an illegal memory access")
    monkeypatch.setattr(pw, "_kernel_lib", lambda: lib)

    class Context:
        def __init__(self, dev):
            state["entered"].append(dev)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(pw.torch.cuda, "device", Context)
    monkeypatch.setattr(pw.torch.cuda, "current_device",
                        lambda: state["current"])
    monkeypatch.setattr(pw.torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))

    def no_plain(*a, **kw):
        raise AssertionError("the plain chain ran for a card's tensors")

    monkeypatch.setattr(pw, "probe_walk_plain", no_plain)
    return state


def _copy_block(block):
    """A copy of the block the stand-in was handed (the wrapper reuses its
    block from call to call)."""
    return pw._ProbeTables.from_buffer_copy(block)


@pytest.mark.parametrize("current", [0, 1], ids=["current", "other"])
@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
def test_card_tensors_reach_the_kernel(stand_in, full, stacked, current):
    stand_in["current"] = current
    args = _on_card((_stacked if stacked else _single)(n=10))
    packed, t, scalars, s_min, bucket, c_max = args
    before = pw.probe_walk.launches
    out = _call(args, full)
    assert pw.probe_walk.launches == before + 1
    (a,) = stand_in["calls"]
    L = 3 if stacked else 1
    assert out.device.type == "cuda" and out.dtype == torch.int32
    assert tuple(out.shape) == (10 * L, 3 if full else 2)
    block, packed_ptr, out_ptr, B0, C, stream = a
    assert (packed_ptr, out_ptr, B0, C, stream) == (
        packed.data_ptr(), out.data_ptr(), 10, 8, 7)
    # a device context only for a card other than the current one
    assert stand_in["entered"] == ([] if current == 0 else [out.device])
    tables = dict(ref="ref_codes_packed", **{f: f for f in (
        "bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount", "postings_row",
        "postings_off", "row_starts", "row_lengths")})
    for field, name in tables.items():
        assert getattr(block, field) == getattr(t, name).data_ptr(), field
    assert (block.L, block.n_buckets, block.W, block.max_probe) == (
        L, t.bucket_mask + 1, 8, t.max_probe)
    assert (block.n_postings, block.n_rows, block.n_words) == (
        t.postings_row.shape[-1], t.row_starts.shape[-1],
        t.ref_codes_packed.shape[-1])
    assert (block.Lmax, block.k, block.ref_pad, block.full) == (
        bucket, t.k, t.ref_pad, int(full))
    assert (block.s_min is None) == full
    gates = (block.threshold, block.mismatches, block.discard_multiple,
             block.discard_nonzero)
    assert all(g is None for g in gates) == (full or not stacked)
    if not full:
        assert block.s_min == s_min.data_ptr()
        assert block.s_len == s_min.shape[-1]
    if not full and stacked:
        assert gates == tuple(getattr(scalars, f).data_ptr() for f in (
            "score_threshold", "num_mismatches", "discard_multiple",
            "discard_nonzero"))
    if not full and not stacked:
        assert (block.threshold0, block.mismatches0, block.discard_multiple0,
                block.discard_nonzero0) == (40, 1, 0, 0)


@pytest.mark.parametrize("rc", [1, 700])
def test_a_failed_launch_raises_and_is_not_counted(stand_in, rc):
    stand_in["rc"] = rc
    args = _on_card(_single(n=10))
    before = pw.probe_walk.launches
    with pytest.raises(RuntimeError, match="probe_walk kernel launch failed: "
                       "an illegal memory access"):
        _call(args, False)
    assert len(stand_in["calls"]) == 1
    assert pw.probe_walk.launches == before


def test_a_failed_build_raises_and_is_not_counted(monkeypatch, tmp_path):
    """No nvcc: the build raises on the card's tensors; nothing falls back
    to the plain chain."""
    def no_nvcc():
        raise RuntimeError("nvcc not found (stand-in)")

    monkeypatch.setattr(pw, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(pw, "probe_walk_plain", None)
    args = _on_card(_single(n=10))
    before = pw.probe_walk.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _call(args, False)
    assert pw.probe_walk.launches == before


def test_an_empty_launch_is_not_counted(stand_in):
    packed, *rest = _single(n=10)
    args = _on_card((packed[:0].contiguous(), *rest))
    before = pw.probe_walk.launches
    out = _call(args, True)
    assert tuple(out.shape) == (0, 3) and not stand_in["calls"]
    assert pw.probe_walk.launches == before


def _misaligned(x):
    """``x``'s values in a contiguous view 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype)
    at = (-(buf.data_ptr() // 4) + 1) % 4
    view = buf[at:at + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    return view


def _six_lanes(t):
    """``t`` with its bucket rows cut to 6 lanes: the plain twin takes it,
    the kernel does not (a row is not whole 16-byte vectors)."""
    return dataclasses.replace(t, **{
        f: getattr(t, f)[..., :6].contiguous() for f in (
            "bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount")})


@pytest.mark.parametrize("case", ["width 6", "misaligned", "2^31 elements",
                                  "2^31 results"])
@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
def test_kernel_refusals_raise_before_a_launch(stand_in, monkeypatch, case,
                                               full):
    """What only the kernel refuses (the plain twin takes it): bucket rows
    that are not whole aligned 16-byte vectors, and extents at 2^31."""
    packed, t, scalars, s_min, bucket, c_max = _single(n=10)
    match = "bkey_fp"
    if case == "width 6":
        t = _six_lanes(t)
    elif case == "misaligned":
        t = dataclasses.replace(t, bkey_fp=_misaligned(t.bkey_fp))
    elif case == "2^31 elements":  # scaled down: the same test, 2^31 -> 4096
        monkeypatch.setattr(pw, "MAX_INDEX", 4096)
        match = "2\\^31 elements or more"
    args = _on_card((packed, t, scalars, s_min, bucket, c_max))
    if case == "2^31 results":  # per call, after the tables' checks passed
        _call(args, full)
        stand_in["calls"].clear()
        monkeypatch.setattr(pw, "MAX_INDEX", 10 * (3 if full else 2))
        match = "reach 2\\^31 elements"
    before = pw.probe_walk.launches
    with pytest.raises(ValueError, match=match):
        _call(args, full)
    assert not stand_in["calls"] and pw.probe_walk.launches == before


# --- the checks, once per tables object -----------------------------------

def test_tables_are_checked_once_per_tables_object(monkeypatch):
    checked = []
    real = device_tables._check_layout

    def counting(t):
        checked.append(t)
        return real(t)

    monkeypatch.setattr(device_tables, "_check_layout", counting)
    packed, t, scalars, s_min, bucket, c_max = args = _single(n=12)
    _call(args, False)
    _call(args, True)
    _call(args, False)
    assert checked == [t]
    # a bad packed after good calls: still refused
    with pytest.raises(ValueError, match="packed"):
        _call((packed.int(),) + args[1:], False)
    with pytest.raises(ValueError, match="c_max"):
        _call(args[:5] + (0,), False)
    # other gate objects with the same tables: checked on their first call
    with pytest.raises(ValueError, match="s_min"):
        _call((packed, t, scalars, s_min[None], bucket, c_max), False)
    _call((packed, t, FilterScalars.from_config(_cfg()), s_min.clone(),
           bucket, c_max), False)
    assert checked == [t]
    # a new tables object, good or bad, is checked anew
    same = dataclasses.replace(t)
    _call((packed, same) + args[2:], False)
    bad = dataclasses.replace(t, bstart=t.bstart.long())
    with pytest.raises(ValueError, match="bstart"):
        _call((packed, bad) + args[2:], False)
    with pytest.raises(ValueError, match="bstart"):
        _call((packed, bad) + args[2:], False)
    assert checked == [t, same, bad, bad]
    # packed on another device than the checked tables
    with pytest.raises(ValueError, match="packed is on meta"):
        _call((torch.empty_like(packed, device="meta"),) + args[1:], False)


def test_the_checked_layout_lives_and_dies_with_its_tables():
    """The checks and argument blocks are kept on the tables object itself
    (``IndexTables.layout``): nothing else holds the tables."""
    args = _single(n=8)
    t = args[1]
    _call(args, False)
    _call(args, True)
    assert t.layout is t.layout and len(t.layout.blocks) == 2
    assert "layout" not in {f.name for f in dataclasses.fields(t)}
    gone = weakref.ref(t)
    del args, t
    gc.collect()
    assert gone() is None


def test_the_argument_block_matches_the_c_header(tmp_path):
    """``_ProbeTables`` lays out ``struct ProbeTables`` as the host's C++
    compiler does (same ABI as nvcc's host side): every field's offset and
    the size."""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) on PATH")
    fields = [f for f, _ in pw._ProbeTables._fields_]
    src = tmp_path / "layout.cpp"
    src.write_text(
        '#include <cstddef>\n#include <cstdio>\n#include "probe_walk_tables.h"\n'
        "int main() {\n"
        + "".join(f'  std::printf("%zu\\n", offsetof(ProbeTables, {f}));\n'
                  for f in fields)
        + '  std::printf("%zu\\n", sizeof(ProbeTables));\n  return 0;\n}\n')
    exe = tmp_path / "layout"
    subprocess.run([gxx, "-std=c++17", "-I", str(_build.CSRC_DIR), "-o",
                    str(exe), str(src)], check=True, capture_output=True,
                   timeout=120)
    got = [int(x) for x in subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True,
        timeout=60).stdout.split()]
    want = [getattr(pw._ProbeTables, f).offset for f in fields] + [
        ctypes.sizeof(pw._ProbeTables)]
    assert got == want


# --- the plain twin on the CPU --------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
def test_cpu_tensors_take_the_plain_twin(full):
    args = _single(n=64)
    before = pw.probe_walk.launches
    got = _call(args, full)
    packed, t, scalars, s_min, bucket, c_max = args
    want = pw.probe_walk_plain(packed, t, bucket=bucket, c_max=c_max,
                               **({} if full else dict(scalars=scalars,
                                                       s_min=s_min)))
    assert torch.equal(got, want) and pw.probe_walk.launches == before
    assert (got[:, 1] >> (16 if full else 18) & 1).sum() > 20  # anchors


@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
def test_each_library_of_a_stack_equals_it_alone(full):
    """Stacked tables: row l*B + b is packed row b against library l, as
    the pass with library l's own tables (built at the stack's bucket
    count) and gates gives it."""
    indexes, cfgs, packed = _stacked_parts(5, 92, 48)
    st = stack_tables(indexes, [build_bucketed_index(ix) for ix in indexes],
                      cfgs, "cpu")
    got = _call((packed, st, st.scalars, st.s_min(92), 92, 8), full)
    assert tuple(got.shape) == (3 * 48, 3 if full else 2)
    n_buckets = st.bkey_fp.shape[1]
    for lib, (index, cfg) in enumerate(zip(indexes, cfgs)):
        t = tables_from_bucketed_index(
            build_bucketed_index(index, min_buckets=n_buckets), "cpu")
        want = _call((packed, t, FilterScalars.from_config(cfg),
                      torch.from_numpy(s_min_table(cfg.score_percent, 92)),
                      92, 8), full)
        assert torch.equal(got[lib * 48:(lib + 1) * 48], want), lib
    per_lib = (got[:, 1] >> (16 if full else 18) & 1).reshape(3, 48)
    assert (per_lib.sum(dim=1) > 5).all()  # every library anchors reads


# --- the build hash -------------------------------------------------------

@pytest.mark.parametrize("name,changes", [
    ("probe_walk_filter", True), ("fused_span_walk", True),
    ("double_walk", False), ("gather_rows", False)])
def test_a_header_edit_changes_the_library_path(tmp_path, monkeypatch, name,
                                                changes):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = _build.library_path(name)
    header = csrc / "span_walk.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert (_build.library_path(name) != before) == changes
    assert _build.library_path(name).name.startswith(f"lib{name}-")


# --- the kernel against its plain twin, on the card -----------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _to(args, device):
    packed, t, scalars, s_min, bucket, c_max = args
    move = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x  # noqa: E731,E501
    t = type(t)(**{f: move(v) for f, v in vars(t).items()})
    scalars = FilterScalars(**{f: move(v) for f, v in vars(scalars).items()})
    return move(packed), t, scalars, move(s_min), bucket, c_max


def _card_case(name):
    """Inputs of one card case, on the CPU."""
    if name == "allele family":
        return _allele_family(n=700)
    if name.startswith("stacked"):
        return _stacked(n=1000)
    if name.startswith("bucket"):
        bucket = int(name.split()[1])
        return _single(seed=bucket, bucket=bucket, n=700)
    if name == "c_max 3":
        return _single(seed=2, c_max=3, n=700)
    if name == "c_max 16":
        return _single(seed=4, c_max=16, n=700)
    bidx, mat, lens, _ = _probe_case(name)
    bucket = mat.shape[1]
    cfg = _cfg()
    return (torch.from_numpy(pack_reads(mat, lens, bucket)),
            tables_from_bucketed_index(bidx, "cpu"),
            FilterScalars.from_config(cfg),
            torch.from_numpy(s_min_table(cfg.score_percent, bucket)), bucket,
            8)


CARD_CASES = ["bucket 64", "bucket 92", "bucket 128", "bucket 160",
              "bucket 1024", "c_max 3", "c_max 16", "stacked", "max_probe 2",
              "planted collisions", "zero-padded rows", "reads of 30-41 bases",
              "allele family"]


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
@pytest.mark.parametrize("name", CARD_CASES)
def test_cuda_kernel_matches_plain(cuda_device, name, full):
    args = _to(_card_case(name), cuda_device)
    before = pw.probe_walk.launches
    got = _call(args, full)
    torch.cuda.synchronize()
    assert pw.probe_walk.launches == before + 1
    packed, t, scalars, s_min, bucket, c_max = args
    want = pw.probe_walk_plain(packed, t, bucket=bucket, c_max=c_max,
                               **({} if full else dict(scalars=scalars,
                                                       s_min=s_min)))
    assert got.device.type == "cuda" and torch.equal(got, want)
