"""The port's stacked multi-library path vs the JAX package's, bit for bit.

- ``ops.device_tables.stack_tables`` must give the arrays, geometry, gates
  and s_min stacks of ``MultiLibraryDispatcher`` (``_dev``, ``_scalars``,
  ``_s_min_stack``), for libraries of one size and of different sizes (the
  rebuild at the common bucket count).
- ``probe_walk_filter_multi`` / ``probe_walk_full_multi`` must return the
  (L, B, 2) / (L, B, 3) int32 of ``probe_walk_filter_packed_multi_chunked``
  / ``probe_walk_full_packed_multi_chunked`` on the same stacked inputs, with
  both walks: per-library configs (mismatches, ``score_percent``, discard
  flags), planted fingerprint collisions, postings overflow, buckets
  64 / 92 / 128.
- ``TorchMultiLibraryDispatcher``'s ``collect`` / ``full_collect`` must equal
  the JAX dispatcher's, and each library's single ``TorchAlignEngine``;
  ``full_collect`` also with libraries that differ on the multiple-match
  gate, one entropy gate a launch and only the gate's rows decoded.
- The port's ``pipeline.fastq_pipeline.process`` and
  ``pipeline.bam_fast.process_fast`` must write the bytes of the JAX
  pipelines with ``DeviceAlignEngine`` s (after
  ``tests/test_multi_library.py``: single-end, paired-end, distinct mates,
  duplicates across chunks; BAM with uniform and with per-library trim).

Every output is an integer or a byte: exact equality.
"""

import contextlib
import dataclasses
import gzip
import io
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.models.multi_aligner import MultiLibraryDispatcher
from nimble_tpu.ops import engine_fast as ef
from nimble_tpu.ops.device_index import hash_kmer, kmer_fp
from nimble_tpu.utils.dna import encode_bases, revcomp
from nimble_tpu_torch.config import FILTER_REASON_CODE, FilterReason
from nimble_tpu_torch.models import multi_aligner
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.models.multi_aligner import TorchMultiLibraryDispatcher
from nimble_tpu_torch.ops.compact import probe_walk_filter_multi
from nimble_tpu_torch.ops.device_tables import stack_tables
from nimble_tpu_torch.ops.full import probe_walk_full_multi
from nimble_tpu_torch.utils.metrics import RECORDER

from conftest import library_path, reads_path
from test_torch_bam import _trimmed_duplicate_bam, ensure_native_libraries
from test_torch_compact import K, _key_halves, _packed, _reads
from torch_sides import JAX, PORT, random_library

FIELDS = ("bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount",
          "postings_row", "postings_off", "ref_codes_packed", "row_starts",
          "row_lengths")


class _Lib(tuple):
    """(reference, index, config, doubled rows) of a random library built
    with the JAX package's loaders; ``port`` is the same library built with
    the port's own."""

    port: tuple


def _lib(seed, n_features=5, feat_len=200, **kw):
    lib = _Lib(random_library(JAX, seed, n_features, feat_len, **kw))
    lib.port = random_library(PORT, seed, n_features, feat_len, **kw)
    return lib


def _mixed_reads(rng, libs, n, lo, hi, junk_prefix=6):
    """Reads from every library in turn (``_reads``: mixed lengths, ~20%
    with a substitution, ~5% junk)."""
    parts = [_reads(rng, libs[i % len(libs)][3], n // len(libs), lo, hi,
                    junk_prefix=junk_prefix) for i in range(len(libs))]
    return (np.concatenate([m for m, _ in parts]),
            np.concatenate([x for _, x in parts]))


def _stack(libs):
    return stack_tables([l.port[1] for l in libs],
                        [PORT.build_bucketed_index(l.port[1]) for l in libs],
                        [l.port[2] for l in libs], "cpu")


def _jax_multi(libs):
    return MultiLibraryDispatcher([DeviceAlignEngine(l[1], l[2])
                                   for l in libs])


# --- stack_tables ---------------------------------------------------------

@pytest.mark.parametrize("sizes", [[(5, 200), (5, 200), (5, 200)],
                                   [(4, 150), (30, 400), (2, 120)]])
def test_stacked_tables_equal_jax_dispatcher(sizes):
    libs = [_lib(40 + i, n, f, num_mismatches=i % 2,
                 score_percent=0.2 + 0.1 * i,
                 discard_multiple_matches=i == 1,
                 discard_nonzero_mismatch=i == 2)
            for i, (n, f) in enumerate(sizes)]
    want = _jax_multi(libs)
    st = _stack(libs)
    if sizes[0] != sizes[1]:  # the rebuild ran: the libraries' own counts
        own = {DeviceAlignEngine(l[1], l[2]).bidx.n_buckets for l in libs}
        assert len(own) > 1
    assert (st.k, st.max_probe, st.bucket_mask + 1, st.ref_pad) == (
        want.k, want.max_probe, want.n_buckets, want.ref_pad)
    assert st.n_libraries == len(libs)
    for f in FIELDS:
        w = np.asarray(want._dev[f])
        got = getattr(st, f).numpy()
        assert got.shape == w.shape, f
        np.testing.assert_array_equal(got, w.view(np.int32)
                                      if w.dtype == np.uint32 else w, f)
    for got, w in zip((st.scalars.score_threshold, st.scalars.num_mismatches,
                       st.scalars.discard_multiple,
                       st.scalars.discard_nonzero), want._scalars):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    for bucket in (64, 92, 128):
        np.testing.assert_array_equal(st.s_min(bucket).numpy(),
                                      np.asarray(want._s_min_stack(bucket)))


def test_stack_tables_refuses_mismatched_inputs():
    _ref, index, cfg, _ = _lib(1).port
    bidx = PORT.build_bucketed_index(index)
    with pytest.raises(ValueError, match="one config per library"):
        stack_tables([index, index], [bidx, bidx], [cfg], "cpu")
    with pytest.raises(ValueError, match="one table and one config"):
        stack_tables([index, index], [bidx], [cfg, cfg], "cpu")


# --- the stacked device passes ----------------------------------------------

WALK_MODES = [("fused", False), ("double", False), ("fused", "fused")]


def _jax_stacked(multi, fp=None):
    dev = {f: jnp.asarray(v) for f, v in multi._dev.items()}
    if fp is not None:
        dev["bkey_fp"] = jnp.asarray(fp)
    return dev


def _assert_passes_match(libs, mat, lens, bucket, *, plant=None, c_max=8):
    multi = _jax_multi(libs)
    st = _stack(libs)
    fp = None
    if plant is not None:
        fp = plant(np.asarray(multi._dev["bkey_fp"]).copy(), multi)
        st = dataclasses.replace(st, bkey_fp=torch.from_numpy(
            fp.view(np.int32)))
    dev = _jax_stacked(multi, fp)
    buf = _packed(mat, lens, bucket)
    geo = dict(k=multi.k, max_probe=multi.max_probe, c_max=c_max,
               bucket_mask=multi.n_buckets - 1, p_limit=bucket - multi.k + 1,
               ref_pad=multi.ref_pad, bucket=bucket)
    tables = [dev[f] for f in FIELDS]
    thr, nmm, dm, dn = multi._scalars
    outs = {}
    for walk, use_pallas in WALK_MODES:
        want2 = np.asarray(ef.probe_walk_filter_packed_multi_chunked(
            jnp.asarray(buf[None]), *tables, multi._s_min_stack(bucket),
            thr, nmm, dm, dn, use_pallas=use_pallas, **geo))[0]
        want3 = np.asarray(ef.probe_walk_full_packed_multi_chunked(
            jnp.asarray(buf[None]), *tables, use_pallas=use_pallas,
            **geo))[0]
        got2 = probe_walk_filter_multi(torch.from_numpy(buf), st,
                                       bucket=bucket, c_max=c_max, walk=walk)
        got3 = probe_walk_full_multi(torch.from_numpy(buf), st,
                                     bucket=bucket, c_max=c_max, walk=walk)
        assert got2.dtype == torch.int32 and got3.dtype == torch.int32
        assert tuple(got2.shape) == (len(libs), buf.shape[0], 2)
        np.testing.assert_array_equal(got2.numpy(), want2, f"(L,B,2) {walk}")
        np.testing.assert_array_equal(got3.numpy(), want3, f"(L,B,3) {walk}")
        outs[walk] = got3.numpy()
    return [ef.unpack_full_packed(o) for o in outs["fused"]]


@pytest.mark.parametrize("bucket", [64, 92, 128])
def test_stacked_passes_match_jax(bucket):
    rng = np.random.default_rng(200 + bucket)
    libs = [_lib(1, 5, 200),
            _lib(2, 12, 350, num_mismatches=0, score_percent=0.5),
            _lib(3, 3, 150, discard_multiple_matches=True,
                 discard_nonzero_mismatch=True, score_threshold=55)]
    lo = 40 if bucket == 64 else bucket - 30
    mat, lens = _mixed_reads(rng, libs, 180, lo, bucket)
    out = _assert_passes_match(libs, mat, lens, bucket)
    # every library anchors its own reads, and only those
    n = 60
    for li, o in enumerate(out):
        own = o["has_anchor"][li * n:(li + 1) * n].mean()
        assert own > 0.8 and o["has_anchor"][:180].mean() < own


def test_stacked_passes_postings_overflow():
    rng = np.random.default_rng(21)
    shared = "".join(rng.choice(list("ACGT"), size=70))
    libs = [_lib(5, 10, 200, shared=shared, n_shared=10),
            _lib(6, 6, 200, shared=shared, n_shared=3, num_mismatches=2)]
    mat, lens = _mixed_reads(rng, libs, 128, 60, 92)
    mat[:40] = 0
    for i in range(40):  # reads inside the shared segment
        mat[i, :50] = encode_bases(shared[i % 20:i % 20 + 50])
        lens[i] = 50
    out = _assert_passes_match(libs, mat, lens, 92)
    assert out[0]["overflow"][:40].all() and not out[1]["overflow"][:40].any()


def test_stacked_passes_planted_fingerprint_collisions():
    """(after tests/test_fp_probe.py): a forged fingerprint hit in one
    library diverts that library's anchor only."""
    rng = np.random.default_rng(5)
    libs = [_lib(7, 6, 200), _lib(8, 6, 200)]
    doubled = libs[0][3]
    mat, lens = _reads(rng, doubled, 128, 65, 65)
    for i in range(128):  # 10 junk bases + 55 library bases
        feat = encode_bases(doubled[i % len(doubled)])
        s = (i * 11) % (len(feat) - 60)
        mat[i, :10] = rng.integers(0, 4, 10)
        mat[i, 10:65] = feat[s:s + 55]
    planted = []

    def plant(fp, multi):
        mask = multi.n_buckets - 1
        for i in range(0, 128, 2):
            lo, hi = _key_halves(mat[i, :K])
            b = int(hash_kmer(lo, hi)[0]) & mask
            want = kmer_fp(lo, hi)[0]
            if fp[0, b, 0] != want:
                fp[0, b, 0] = want
                planted.append(i)
        return fp

    out = _assert_passes_match(libs, mat, lens, 92, plant=plant)
    assert planted
    assert out[0]["overflow"][planted].sum() >= len(planted) // 2
    assert not out[1]["overflow"][planted].any()


def test_stacked_passes_small_c_max():
    rng = np.random.default_rng(17)
    shared = "".join(rng.choice(list("ACGT"), size=70))
    libs = [_lib(9, 6, 300, shared=shared, n_shared=3), _lib(10, 4, 120)]
    mat, lens = _mixed_reads(rng, libs, 128, 50, 64)
    _assert_passes_match(libs, mat, lens, 64, c_max=4)


# --- the dispatcher ---------------------------------------------------------

def _batch(rng, libs):
    """A chunk across buckets 64 / 92 / 128: reads of 50-140 bp from every
    library, some short, some over the largest bucket, some duplicated."""
    mat, lens = _mixed_reads(rng, libs, 150, 50, 140, junk_prefix=0)
    mat = np.concatenate([mat, mat[:20]])
    lens = np.concatenate([lens, lens[:20]]).astype(np.int32)
    lens[7::31] = 12                  # below MIN_READ_LENGTH
    mat *= np.arange(mat.shape[1])[None, :] < lens[:, None]
    return mat, lens


def _dispatchers(libs, walk):
    torch_engines = [TorchAlignEngine(*l.port[1:3], device="cpu", walk=walk,
                                      buckets=(64, 92, 128), launch_batch=64)
                     for l in libs]
    jax_engines = [DeviceAlignEngine(l[1], l[2], buckets=(64, 92, 128))
                   for l in libs]
    return (TorchMultiLibraryDispatcher(torch_engines), torch_engines,
            MultiLibraryDispatcher(jax_engines))


@pytest.mark.parametrize("walk", ["fused", "double"])
def test_dispatcher_collect_matches_jax_and_single_engines(walk):
    rng = np.random.default_rng(11)
    shared = "".join(rng.choice(list("ACGT"), size=80))
    libs = [_lib(11, 8, 260, shared=shared, n_shared=8),
            _lib(12, 20, 400, num_mismatches=0, score_percent=0.45),
            _lib(13, 3, 220, discard_multiple_matches=True)]
    mat, lens = _batch(rng, libs)
    multi, engines, jax_multi = _dispatchers(libs, walk)
    got = multi.collect(multi.dispatch(mat, lens))
    want = jax_multi.collect(jax_multi.dispatch(mat, lens))
    for li, (g, w, e) in enumerate(zip(got, want, engines)):
        for key in ("astart", "mask", "passed", "needs_host"):
            np.testing.assert_array_equal(g[key], w[key], f"{li} {key}")
        single = e.align_raw_compact_from_matrix(mat, lens)
        for key in ("passed", "needs_host"):
            np.testing.assert_array_equal(g[key], single[key])
        passed = np.flatnonzero(single["passed"])
        assert len(passed) > 10
        for i in passed:
            assert e.decode_combo(g["astart"][i], g["mask"][i]) == \
                e.decode_combo(single["astart"][i], single["mask"][i])
    assert got[0]["needs_host"].any()  # postings overflow in library 0


def _rows_at_the_multiple_match_gate(state, result, li):
    """Distinct rows of a stacked full pass that reach library ``li``'s
    multiple-match gate (on): a device result (no overflow) whose reason
    is that gate's or a later step's."""
    code = FILTER_REASON_CODE
    after = [-1, code[FilterReason.DISCARDED_MULTIPLE_MATCH],
             code[FilterReason.ABOVE_MISMATCH_THRESHOLD]]
    n = 0
    for sel, _m, out_dev, _buf, _bucket, inv in state["launches"]:
        overflow = (out_dev.cpu().numpy()[li][:, 1] & (1 << 17)) != 0
        rep = sel[np.unique(inv, return_index=True)[1]]
        n += np.count_nonzero(np.isin(result["reason"][rep], after)
                              & ~overflow)
    return n


# (walk, discard_multiple_matches of libraries 0 and 1); the first two
# cases keep the test's original ids and inputs
_FULL_COLLECT_CASES = [("fused", (False, False)), ("double", (False, False)),
                       ("fused", (False, True)), ("double", (False, True)),
                       ("fused", (True, True)), ("double", (True, True))]


@pytest.mark.parametrize(
    "walk,multiple", _FULL_COLLECT_CASES,
    ids=["fused", "double", "fused-off-on", "double-off-on", "fused-on-on",
         "double-on-on"])
def test_dispatcher_full_collect_matches_jax_and_single_engines(
        walk, multiple, monkeypatch):
    """Each library equals the JAX dispatcher's and its engine alone, key
    for key, dtype for dtype; the entropy gate opens once a launch; only
    the rows reaching a library's multiple-match gate are decoded."""
    rng = np.random.default_rng(12)
    shared = "".join(rng.choice(list("ACGT"), size=80))
    gated = any(multiple)
    # a gated case plants a segment library 1 shares too, and reads in it;
    # the (off, off) cases keep the original libraries and batch
    planted = dict(shared=shared[:60], n_shared=3) if gated else {}
    libs = [_lib(14, 8, 260, shared=shared, n_shared=8, score_percent=0.25,
                 discard_multiple_matches=multiple[0]),
            _lib(15, 20, 400, num_mismatches=0,
                 discard_multiple_matches=multiple[1], **planted),
            _lib(16, 3, 220, discard_nonzero_mismatch=True)]
    mat, lens = _batch(rng, libs)
    if gated:  # reads in 8 rows of library 0 and 3 of library 1
        for i in range(11):
            mat[i] = 0
            mat[i, :50] = encode_bases(shared[i : i + 50])
            lens[i] = 50
    active = np.ones(len(lens), dtype=bool)
    active[3::17] = False
    wide = np.zeros((len(lens), 1100), dtype=np.int8)
    wide[:, :mat.shape[1]] = mat
    wide[9] = encode_bases(libs[0][3][0] * 6)[:1100]  # host rescue
    lens[9] = 1100
    multi, engines, jax_multi = _dispatchers(libs, walk)
    monkeypatch.setenv("NIMBLE_TIMING", "1")
    RECORDER.clear()
    state = multi.full_dispatch(wide, lens, active)
    with RECORDER.traced_pass("bam.pass"):
        got = multi.full_collect(state)
    counters = dict(RECORDER.counters)
    entropy = [s for s in RECORDER.spans if s.name == "bam.collect.entropy"]
    assert len(entropy) == len(state["launches"]) >= 2
    assert sum(s.items for s in entropy) == sum(
        launch[1] for launch in state["launches"])
    decoded = sum(_rows_at_the_multiple_match_gate(state, got[li], li)
                  for li in (0, 1) if multiple[li])
    assert counters.get("bam.rows_decoded", 0) == decoded
    assert (decoded > 0) == gated
    multiple_code = FILTER_REASON_CODE[FilterReason.DISCARDED_MULTIPLE_MATCH]
    assert (got[1]["reason"] == multiple_code).any() == multiple[1]
    want = jax_multi.full_collect(jax_multi.full_dispatch(wide, lens, active))
    for li, (g, w, e) in enumerate(zip(got, want, engines)):
        single = e.full_collect(e.full_dispatch(wide, lens, active))
        for other in (w, single):
            for key in ("reason", "norm", "score", "eq_key"):
                assert g[key].dtype == other[key].dtype
                np.testing.assert_array_equal(g[key], other[key],
                                              f"{li} {key}")
            assert g["rescued"] == other["rescued"]
        assert (g["reason"] == -1).sum() > 10
    assert len(got[0]["rescued"]) > 1


def test_dispatcher_refuses_engines_that_cannot_share_a_pass():
    libs = [_lib(17), _lib(18)]

    def engine(l, **kw):
        return TorchAlignEngine(*l.port[1:3], device="cpu", **kw)

    for kw, what in (({"walk": "double"}, "walk"),
                     ({"launch_batch": 64}, "launch_batch"),
                     ({"c_max": 4}, "c_max"),
                     ({"buckets": (64, 128)}, "buckets")):
        with pytest.raises(ValueError, match=what):
            TorchMultiLibraryDispatcher([engine(libs[0]),
                                         engine(libs[1], **kw)])
    with pytest.raises(ValueError, match="TorchAlignEngine"):
        TorchMultiLibraryDispatcher([engine(libs[0]),
                                     DeviceAlignEngine(libs[1][1],
                                                       libs[1][2])])
    with pytest.raises(ValueError, match="trim"):
        libs[1].port[2].trim_target_length = 33
        TorchMultiLibraryDispatcher(
            [engine(libs[0]), engine(libs[1])]).full_dispatch(
                np.zeros((1, 64), np.int8), np.full(1, 64), np.ones(1, bool))


# --- the pipelines ----------------------------------------------------------

@pytest.fixture
def native_library():
    """Each side's native host library (``tests/test_torch_bam.py``)."""
    ensure_native_libraries()


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _fastq_outputs(tmp_path, tag, process, make_engine, inputs, refs, cfgs,
                   indexes, **kw):
    outs = [str(tmp_path / f"{tag}{i}.tsv") for i in range(len(refs))]
    engines = [make_engine(x, c) for x, c in zip(indexes, cfgs)]
    _quiet(process, inputs, engines, refs, cfgs, outs, **kw)
    return [open(o).read() for o in outs]


@pytest.fixture
def stacked_launches(monkeypatch):
    """Counts the stacked compact passes the port's pipelines run."""
    calls = []
    real = multi_aligner.probe_walk_filter_multi

    def spy(packed, **kw):
        calls.append(packed.shape[0])
        return real(packed, **kw)

    monkeypatch.setattr(multi_aligner, "probe_walk_filter_multi", spy)
    return calls


def _sides(libs):
    """(references, configs, indexes) of each side of ``_lib`` libraries."""
    return ([[l[i] for l in libs] for i in (0, 2, 1)],
            [[l.port[i] for l in libs] for i in (0, 2, 1)])


def _compare_fastq(tmp_path, inputs, jax_side, port_side, walk, **kw):
    """The JAX pipeline on the JAX side's (references, configs, indexes)
    and the port's on the port's: the same TSV bytes."""
    want = _fastq_outputs(tmp_path, "jax", JAX.fastq_pipeline.process,
                          lambda x, c: DeviceAlignEngine(x, c), inputs,
                          *jax_side, **kw)
    got = _fastq_outputs(
        tmp_path, "torch", PORT.fastq_pipeline.process,
        lambda x, c: TorchAlignEngine(x, c, device="cpu", walk=walk),
        inputs, *port_side, **kw)
    assert got == want
    assert any(len(t.splitlines()) > 1 for t in got)
    return got


@pytest.mark.parametrize("walk", ["fused", "double"])
def test_fastq_single_end_matches_jax(tmp_path, stacked_launches, walk):
    rng = np.random.default_rng(0)
    libs = [_lib(1), _lib(2, num_mismatches=0, score_percent=0.5), _lib(3)]
    fastq = tmp_path / "reads.fastq"
    with open(fastq, "w") as f:
        for i in range(48):
            if i < 40:
                feats = libs[int(rng.integers(0, 3))][3]
                src = feats[int(rng.integers(0, len(feats)))]
                s = int(rng.integers(0, len(src) - 60))
                seq = src[s:s + 60]
            else:
                seq = "".join(rng.choice(list("ACGT"), size=60))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * 60}\n")
    _compare_fastq(tmp_path, [str(fastq)], *_sides(libs), walk)
    assert stacked_launches == [48]  # one stacked pass for all libraries


def _fixture_libraries(side):
    """(references, configs, indexes) of basic.json and basic-rev.json,
    loaded with ``side``'s loaders."""
    out = []
    for name in ("basic.json", "basic-rev.json"):
        cfg, ref = side.load_reference_library(library_path(name),
                                               side.LibraryChemistry.NONE)
        seqs = side.get_reference_sequence_data(ref)[0]
        out.append((ref, cfg, side.build_index(seqs)))
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


def test_fastq_paired_end_matches_jax(tmp_path, stacked_launches):
    fq = reads_path("basic.fastq")
    _compare_fastq(tmp_path, [fq, fq], _fixture_libraries(JAX),
                   _fixture_libraries(PORT), "fused")
    assert len(stacked_launches) == 1


def test_fastq_paired_end_distinct_mates_matches_jax(tmp_path):
    comp = str.maketrans("ACGT", "TGCA")
    lines = open(reads_path("basic.fastq")).read().splitlines()
    r2 = tmp_path / "r2.fastq"
    with open(r2, "w") as f:
        for i in range(0, len(lines), 4):
            seq = lines[i + 1].translate(comp)[::-1]
            f.write(f"{lines[i]}\n{seq}\n+\n{lines[i + 3]}\n")
    _compare_fastq(tmp_path, [reads_path("basic.fastq"), str(r2)],
                   _fixture_libraries(JAX), _fixture_libraries(PORT),
                   "double")


def test_fastq_duplicates_across_chunks_match_jax(tmp_path, stacked_launches):
    rng = np.random.default_rng(11)
    libs = [_lib(21), _lib(22)]
    seqs = []
    for _ in range(10):
        feats = libs[int(rng.integers(0, 2))][3]
        src = feats[int(rng.integers(0, len(feats)))]
        s = int(rng.integers(0, len(src) - 60))
        seqs.append(src[s:s + 60])
    fastq = tmp_path / "dup.fastq"
    with open(fastq, "w") as f:
        for i in range(60):  # every read 6 times, copies in other chunks
            f.write(f"@r{i}\n{seqs[i % 10]}\n+\n{'I' * 60}\n")
    _compare_fastq(tmp_path, [str(fastq)], *_sides(libs), "fused",
                   chunk_reads=16)
    # the shared dedupe: only the first chunk's 10 distinct reads upload
    assert stacked_launches == [10]


def test_fastq_engines_that_cannot_share_a_pass_match_jax(tmp_path,
                                                          stacked_launches):
    """Engines with different walks: per-engine launches, same bytes."""
    fq = [reads_path("basic.fastq")]
    want = _fastq_outputs(tmp_path, "jax", JAX.fastq_pipeline.process,
                          lambda x, c: DeviceAlignEngine(x, c), fq,
                          *_fixture_libraries(JAX))
    walks = iter(("fused", "double"))
    got = _fastq_outputs(
        tmp_path, "torch", PORT.fastq_pipeline.process,
        lambda x, c: TorchAlignEngine(x, c, device="cpu", walk=next(walks)),
        fq, *_fixture_libraries(PORT))
    assert got == want and not stacked_launches


def _bam_libs(trims, side):
    rng = np.random.default_rng(77)
    feats = ["".join(rng.choice(list("ACGT"), size=220)) for _ in range(8)]
    libs = []
    for li, (length, strict) in enumerate(trims):
        own = feats[4 * (li % 2):4 * (li % 2) + 4] if li < 2 else feats[1:6]
        doubled = [x for f in own for x in (f, revcomp(f))]
        names = [n for i in range(len(own))
                 for n in (f"l{li}g{i}", f"l{li}g{i}§rev")]
        ref = side.Reference(
            group_on=0, headers=["sequence_name", "sequence"],
            columns=[names, doubled], sequence_name_idx=0, sequence_idx=1)
        cfg = side.AlignFilterConfig(
            reference_genome_size=len(doubled), score_percent=0.3,
            score_threshold=35, num_mismatches=li % 2,
            max_hits_to_report=8, trim_target_length=length,
            trim_strictness=strict)
        libs.append((ref, side.build_index(doubled), cfg))
    return feats, libs


def _bam_outputs(tmp_path, tag, process, make_engine, bam, libs, cores):
    outs = [str(tmp_path / f"{tag}{i}.tsv.gz") for i in range(len(libs))]
    engines = [make_engine(l[1], l[2]) for l in libs]
    _quiet(process, [str(bam)], engines, [l[0] for l in libs],
           [l[2] for l in libs], outs, cores, False)
    return [gzip.open(o).read() for o in outs]


@pytest.mark.parametrize("trims,cores", [
    ([(50, 0.9)] * 3, 2),
    ([(50, 0.9)] * 3, 4),
    ([(50, 0.9), (40, 0.5), (50, 0.9)], 3),
])
def test_bam_process_fast_matches_jax(tmp_path, monkeypatch, native_library,
                                      trims, cores):
    feats, libs = _bam_libs(trims, JAX)
    bam = tmp_path / "trim_dup.bam"
    _trimmed_duplicate_bam(bam, feats, seed=3)
    want = _bam_outputs(tmp_path, "jax", JAX.bam_fast.process_fast,
                        lambda x, c: DeviceAlignEngine(x, c), bam, libs,
                        cores)
    _, libs = _bam_libs(trims, PORT)
    stacked = []
    real = multi_aligner.probe_walk_full_multi
    monkeypatch.setattr(multi_aligner, "probe_walk_full_multi",
                        lambda packed, **kw: stacked.append(1)
                        or real(packed, **kw))
    got = _bam_outputs(
        tmp_path, "torch", PORT.bam_fast.process_fast,
        lambda x, c: TorchAlignEngine(x, c, device="cpu"), bam, libs, cores)
    assert got == want
    uniform = len(set(trims)) == 1
    assert bool(stacked) == uniform
    for data in got:
        rows = data.splitlines()[1:]
        assert len(rows) > 100 and sum(r.split(b"\t")[0] != b""
                                       for r in rows) > 20


def test_bam_process_fast_restores_switch_interval(tmp_path, native_library):
    feats, libs = _bam_libs([(50, 0.9)] * 2, PORT)
    bam = tmp_path / "b.bam"
    _trimmed_duplicate_bam(bam, feats, seed=4)
    before = sys.getswitchinterval()
    sys.setswitchinterval(0.0123)
    try:
        _bam_outputs(tmp_path, "t", PORT.bam_fast.process_fast,
                     lambda x, c: TorchAlignEngine(x, c, device="cpu"), bam,
                     libs, 2)
        assert sys.getswitchinterval() == pytest.approx(0.0123)
    finally:
        sys.setswitchinterval(before)


def test_dispatcher_raw_pack_matrix_reads():
    """(after tests/test_multi_library.py:85): pack_matrix chunks of 70 bp
    reads from three libraries, each library's passed reads decode to its
    single engine's eq classes."""
    rng = np.random.default_rng(5)
    libs = [_lib(7), _lib(8, feat_len=320), _lib(9, n_features=2)]
    reads = []
    for _ in range(50):
        feats = libs[int(rng.integers(0, 3))][3]
        src = feats[int(rng.integers(0, len(feats)))]
        s = int(rng.integers(0, len(src) - 70))
        reads.append(src[s:s + 70])
    mat, lens = PORT.pack_matrix([PORT.encode_bases(r) for r in reads])
    engines = [TorchAlignEngine(*l.port[1:3], device="cpu") for l in libs]
    multi = TorchMultiLibraryDispatcher(engines)
    raws = multi.collect(multi.dispatch(mat, lens))
    for li, e in enumerate(engines):
        ref_raw = e.align_raw_compact_from_matrix(mat, lens)
        np.testing.assert_array_equal(raws[li]["passed"], ref_raw["passed"])
        for i in np.flatnonzero(ref_raw["passed"]):
            assert e.decode_combo(raws[li]["astart"][i],
                                  raws[li]["mask"][i]) == \
                e.decode_combo(ref_raw["astart"][i], ref_raw["mask"][i])
