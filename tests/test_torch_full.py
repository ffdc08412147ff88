"""The port's full-output pass and engine interface vs the JAX engine's.

``ops.full.probe_walk_full`` must return exactly the (B, 3) int32 rows of
``engine_fast.probe_walk_full_packed`` for the same packed reads and tables,
with ``walk="fused"`` against ``use_pallas="fused"`` and ``walk="double"``
against ``use_pallas=True`` (both Pallas kernels in interpret mode on the
CPU): random reads, planted fingerprint collisions, anchors with more
postings than ``c_max``, and the zero pad rows of a 128-row tile.
``TorchAlignEngine.full_collect(full_dispatch(...))`` must return the same
dict as ``DeviceAlignEngine``'s on batches with duplicates, trimmed rows
whose codes run past their length, short, inactive and over-long reads, and
postings overflow (host rescue ids included), and with the multiple-match
gate on where it rejects rows; that gate decodes only its candidates, as
the whole launch's ``_decode_counts`` would.  ``dedupe_packed_rows`` must
return the JAX engine's (first, inv).  Exact equality throughout.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nimble_tpu.models import aligner as jax_aligner
from nimble_tpu.ops import engine_fast as ef
from nimble_tpu.ops.device_index import build_bucketed_index, hash_kmer, kmer_fp
from nimble_tpu.utils.dna import encode_bases
from nimble_tpu_torch.config import FILTER_REASON_CODE, FilterReason
from nimble_tpu_torch.models.aligner import TorchAlignEngine, dedupe_packed_rows
from nimble_tpu_torch.ops.device_tables import tables_from_bucketed_index
from nimble_tpu_torch.ops.full import probe_walk_full, unpack_full_packed
from nimble_tpu_torch.utils.metrics import RECORDER

from test_torch_compact import K, _cfg, _key_halves, _library, _packed, _reads
from torch_sides import PORT

WALK_MODES = [("fused", "fused"), ("double", True)]
_FIELDS = ("bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount",
           "postings_row", "postings_off", "ref_codes_packed", "row_starts",
           "row_lengths")


def _jax_full(bidx, buf, bucket, use_pallas, c_max):
    with pltpu.force_tpu_interpret_mode():
        out = ef.probe_walk_full_packed(
            jnp.asarray(buf), *(jnp.asarray(getattr(bidx, f)) for f in _FIELDS),
            k=bidx.k, max_probe=bidx.max_probe, c_max=c_max,
            bucket_mask=bidx.n_buckets - 1, p_limit=bucket - bidx.k + 1,
            ref_pad=bidx.ref_pad, bucket=bucket, use_pallas=use_pallas)
    return np.asarray(out)


def _assert_same(bidx, mat, lens, bucket, c_max=8):
    buf = _packed(mat, lens, bucket)
    t = tables_from_bucketed_index(bidx, "cpu")
    outs = {}
    for walk, use_pallas in WALK_MODES:
        want = _jax_full(bidx, buf, bucket, use_pallas, c_max)
        got = probe_walk_full(torch.from_numpy(buf), t, bucket=bucket,
                              c_max=c_max, walk=walk).numpy()
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=walk)
        uw, ug = ef.unpack_full_packed(want), unpack_full_packed(got)
        for key in uw:
            np.testing.assert_array_equal(ug[key], uw[key], err_msg=key)
        outs[walk] = got
    np.testing.assert_array_equal(outs["fused"], outs["double"])
    return unpack_full_packed(outs["fused"]), buf.shape[0] - mat.shape[0]


@pytest.mark.parametrize("bucket", [64, 92, 96, 128])
def test_random_reads_and_pad_rows_match_jax(bucket):
    rng = np.random.default_rng(100 + bucket)
    doubled, index = _library(rng)
    bidx = build_bucketed_index(index)
    lo = 40 if bucket == 64 else bucket - 30
    mat, lens = _reads(rng, doubled, 150, lo, bucket, junk_prefix=8)
    out, n_pad = _assert_same(bidx, mat, lens, bucket)
    assert n_pad > 0 and not out["has_anchor"][-n_pad:].any()
    assert out["has_anchor"].sum() > 100 and out["mismatches"].sum() > 0


def test_postings_overflow_sets_overflow_bit():
    rng = np.random.default_rng(21)
    shared = "".join(rng.choice(list("ACGT"), size=70))
    doubled, index = _library(rng, n_feats=10, shared=shared, n_shared=10)
    bidx = build_bucketed_index(index)
    assert bidx.max_postings > 8
    mat, lens = _reads(rng, doubled, 128, 60, 92)
    mat[:40] = 0
    for i in range(40):  # reads starting inside the shared segment
        mat[i, :50] = encode_bases(shared[i % 20 : i % 20 + 50])
        lens[i] = 50
    out, _ = _assert_same(bidx, mat, lens, 92)
    assert out["overflow"][:40].any()


def test_planted_fingerprint_collisions_set_overflow_bit():
    """(after tests/test_fp_probe.py): a forged fingerprint hit diverts
    the anchor; the full pass must flag it for host rescue like JAX."""
    rng = np.random.default_rng(5)
    doubled, index = _library(rng, n_feats=6, feat_len=200)
    bidx = build_bucketed_index(index)
    mat, lens = _reads(rng, doubled, 128, 65, 65)
    for i in range(128):  # 10 junk bases + 55 library bases
        feat = encode_bases(doubled[i % len(doubled)])
        s = (i * 11) % (len(feat) - 60)
        mat[i, :10] = rng.integers(0, 4, 10)
        mat[i, 10:65] = feat[s : s + 55]
    fp = bidx.bkey_fp.copy()
    mask = bidx.n_buckets - 1
    planted = 0
    for i in range(0, 128, 2):
        lo, hi = _key_halves(mat[i, :K])
        b = int(hash_kmer(lo, hi)[0]) & mask
        want = kmer_fp(lo, hi)[0]
        if fp[b, 0] != want:
            fp[b, 0] = want
            planted += 1
    assert planted > 0
    forged = dataclasses.replace(bidx, bkey_fp=fp)
    out, _ = _assert_same(forged, mat, lens, 92)
    assert out["overflow"][::2].sum() >= planted // 2


def test_small_c_max_matches_jax():
    rng = np.random.default_rng(17)
    shared = "".join(rng.choice(list("ACGT"), size=70))
    doubled, index = _library(rng, n_feats=6, shared=shared, n_shared=3)
    mat, lens = _reads(rng, doubled, 128, 50, 64)
    _assert_same(build_bucketed_index(index), mat, lens, 64, c_max=4)


def test_dedupe_packed_rows_invariants():
    """(after tests/test_full_dedupe.py) and equal to the JAX engine's."""
    rng = np.random.default_rng(5)
    for width in (25, 32, 9):
        base = rng.integers(0, 256, size=(37, width), dtype=np.uint8)
        buf = base[rng.integers(0, 37, size=300)]
        first, inv = dedupe_packed_rows(buf)
        np.testing.assert_array_equal(buf[first][inv], buf)
        assert len(first) == len(np.unique(buf, axis=0))
        want_first, want_inv = jax_aligner.dedupe_packed_rows(buf)
        np.testing.assert_array_equal(first, want_first)
        np.testing.assert_array_equal(inv, want_inv)


def _batch(rng, doubled, shared=None):
    """A BAM-like batch: 60 distinct reads tiled to 240 rows, codes left
    past each trimmed length, some short, inactive and over-long rows, and
    (with ``shared``) reads whose anchor overflows c_max."""
    mat, lens = _reads(rng, doubled, 60, 45, 96, junk_prefix=6)
    if shared is not None:
        for i in range(8):
            mat[i, :60] = encode_bases(shared[i : i + 60])
            lens[i] = 60
    full_lens = lens.copy()
    mat = mat[np.arange(240) % 60]
    lens = lens[np.arange(240) % 60].copy()
    lens[::7] = np.maximum(lens[::7] - 11, 0)  # trimmed: codes run past
    lens[5::23] = 12                            # below MIN_READ_LENGTH
    active = np.ones(240, dtype=bool)
    active[3::17] = False
    assert (full_lens[np.arange(240) % 60][::7] > lens[::7]).all()
    # two over-long reads go to host rescue
    wide = np.zeros((240, 1100), dtype=np.int8)
    wide[:, : mat.shape[1]] = mat
    feat = encode_bases(doubled[0] * 4)
    for i in (10, 130):
        wide[i] = feat[:1100]
        lens[i] = 1100
    return wide, lens.astype(np.int32), active


@pytest.mark.parametrize("walk", ["fused", "double"])
@pytest.mark.parametrize("with_overflow", [False, True])
def test_engine_full_interface_matches_jax(walk, with_overflow):
    rng = np.random.default_rng(31 + with_overflow)
    shared = "".join(rng.choice(list("ACGT"), size=80))
    doubled, index = _library(rng, n_feats=10, shared=shared,
                              n_shared=10 if with_overflow else 0)
    mat, lens, active = _batch(rng, doubled,
                               shared if with_overflow else None)
    cfg = _cfg(score_percent=0.25, discard_multiple_matches=with_overflow)
    want_eng = jax_aligner.DeviceAlignEngine(
        index, cfg, use_pallas_walk="fused" if walk == "fused" else True)
    with pltpu.force_tpu_interpret_mode():
        want = want_eng.full_collect(want_eng.full_dispatch(mat, lens, active))
    eng = TorchAlignEngine(
        PORT.build_index(doubled),
        _cfg(PORT.AlignFilterConfig, score_percent=0.25,
             discard_multiple_matches=with_overflow),
        device="cpu", walk=walk, launch_batch=64)
    got = eng.full_collect(eng.full_dispatch(mat, lens, active))
    for key in ("reason", "norm", "score", "eq_key"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["rescued"] == want["rescued"]
    assert len(got["rescued"]) >= (3 if with_overflow else 2)
    assert (got["reason"] == -1).sum() > 40


def _reached_the_gate(state, result):
    """Distinct rows of a full pass that reach the multiple-match gate,
    from a result with the gate off: a device result (no overflow) that
    passed, or failed only the mismatch gate after it."""
    code = FILTER_REASON_CODE
    after = [-1, code[FilterReason.ABOVE_MISMATCH_THRESHOLD]]
    n = 0
    for sel, _m, out_dev, _buf, _bucket, inv in state["launches"]:
        overflow = unpack_full_packed(out_dev.cpu().numpy())["overflow"]
        rep = sel[np.unique(inv, return_index=True)[1]]
        n += np.count_nonzero(np.isin(result["reason"][rep], after)
                              & ~overflow)
    return n


@pytest.mark.parametrize("walk", ["fused", "double"])
@pytest.mark.parametrize("c_max", [4, 8])
def test_engine_multiple_match_gate_rejects_rows_and_decodes_only_them(
        walk, c_max, monkeypatch):
    """With ``discard_multiple_matches`` on, reads in a segment three
    features share fail the gate, as in the JAX engine; only the rows
    reaching the gate are decoded (``bam.rows_decoded``); the gate changes
    nothing else of the gate-off result."""
    rng = np.random.default_rng(41)
    shared = "".join(rng.choice(list("ACGT"), size=80))
    doubled, index = _library(rng, n_feats=6, shared=shared, n_shared=3)
    mat, lens, active = _batch(rng, doubled, shared)
    code = FILTER_REASON_CODE[FilterReason.DISCARDED_MULTIPLE_MATCH]
    want_eng = jax_aligner.DeviceAlignEngine(
        index, _cfg(discard_multiple_matches=True), c_max=c_max,
        use_pallas_walk="fused" if walk == "fused" else True)
    with pltpu.force_tpu_interpret_mode():
        want = want_eng.full_collect(want_eng.full_dispatch(mat, lens, active))
    port_index = PORT.build_index(doubled)
    got = {}
    monkeypatch.setenv("NIMBLE_TIMING", "1")
    for on in (False, True):
        eng = TorchAlignEngine(
            port_index,
            _cfg(PORT.AlignFilterConfig, discard_multiple_matches=on),
            device="cpu", walk=walk, c_max=c_max, launch_batch=64)
        RECORDER.clear()
        state = eng.full_dispatch(mat, lens, active)
        with RECORDER.traced_pass("bam.pass"):
            got[on] = eng.full_collect(state)
        decoded = RECORDER.counters.get("bam.rows_decoded", 0)
        assert decoded == (_reached_the_gate(state, got[False]) if on else 0)
    for key in ("reason", "norm", "score", "eq_key"):
        assert got[True][key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[True][key], want[key], err_msg=key)
    assert got[True]["rescued"] == want["rescued"]
    hit = got[True]["reason"] == code
    assert hit.sum() >= 8 and decoded > hit.sum()
    assert set(got[False]["reason"][hit]) <= {
        -1, FILTER_REASON_CODE[FilterReason.ABOVE_MISMATCH_THRESHOLD]}
    assert (got[False]["eq_key"][hit] >= 0).all()
    for key in ("reason", "norm", "score", "eq_key"):
        np.testing.assert_array_equal(got[True][key][~hit],
                                      got[False][key][~hit], err_msg=key)
    assert got[True]["rescued"] == got[False]["rescued"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("c_max", [2, 4, 8, 16])
def test_the_gate_decodes_its_candidates_as_the_whole_decode(seed, c_max):
    """For random combo keys over a library's postings, the multiple-match
    gate, which decodes only its candidates, fails exactly the candidates
    whose whole-launch ``_decode_counts`` is above 1, and no other row; the
    keys include windows that repeat a feature row, so a distinct count
    falls below the mask's popcount."""
    rng = np.random.default_rng(seed)
    doubled, _index = _library(rng, n_feats=3, feat_len=120)
    eng = TorchAlignEngine(PORT.build_index(doubled),
                           _cfg(PORT.AlignFilterConfig,
                                discard_multiple_matches=True),
                           device="cpu", c_max=c_max)
    n_post = len(eng.bidx.postings_row)
    m = 3000
    astart = rng.integers(0, n_post, m)
    astart[:50] = n_post - 1 - np.arange(50) % c_max  # windows at the end
    mask = rng.integers(1, 1 << c_max, m)
    keys = (astart.astype(np.int64) << c_max) | mask
    ha = rng.random(m) < 0.8
    keys[~ha] = rng.integers(-5, 1 << 40, np.count_nonzero(~ha))
    cand = ha & (rng.random(m) < 0.7)
    whole = eng._decode_counts(keys, ha)
    popcount = np.array([bin(int(x)).count("1") for x in mask])
    assert (whole[ha] < popcount[ha]).any()
    assert ((whole[cand] > 1).any() and (whole[cand] == 1).any())
    rows = np.flatnonzero(cand)
    np.testing.assert_array_equal(
        eng._decode_counts(keys[rows], np.ones(len(rows), dtype=bool)),
        whole[rows])
    fails = eng.multiple_matches(keys, cand)
    assert fails.dtype == bool and fails.shape == (m,)
    np.testing.assert_array_equal(fails, cand & (whole > 1))


def test_engine_refuses_unknown_walk_and_wide_c_max():
    rng = np.random.default_rng(2)
    doubled, _index = _library(rng, n_feats=2, feat_len=100)
    index, cfg = PORT.build_index(doubled), _cfg(PORT.AlignFilterConfig)
    with pytest.raises(ValueError, match="walk="):
        TorchAlignEngine(index, cfg, device="cpu", walk="scan")
    with pytest.raises(ValueError, match="c_max"):
        TorchAlignEngine(index, cfg, device="cpu", c_max=17)
