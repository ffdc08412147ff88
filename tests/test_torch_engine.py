"""The port's slice as a whole: FASTQ -> counts TSV, byte for byte.

``fastq_pipeline.process`` driven by ``TorchAlignEngine(device="cpu")`` must
write the same bytes as the same pipeline driven by
``DeviceAlignEngine(use_pallas_walk="fused")`` (the fused Pallas walk in
interpret mode on the CPU) on the repo's fixtures and on small synthetic
libraries shaped like the bench workload, single-end and paired.  The
reference's oracle count vectors (``tests/test_oracle_alignment.py``) must
hold through the port too.  Exact equality throughout.
"""

import numpy as np
import pytest

from nimble_tpu.config import LibraryChemistry
from nimble_tpu.core.calls import HostAlignEngine
from nimble_tpu.core.fast_count import fast_count_calls
from nimble_tpu.index.build import build_index
from nimble_tpu.io.fastq import read_fastq_codes
from nimble_tpu.library import get_reference_sequence_data, load_reference_library
from nimble_tpu.models.aligner import DeviceAlignEngine
from nimble_tpu.pipeline import fastq_pipeline
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.workload import write_workload

from conftest import library_path, reads_path

BASIC_TSV = (
    "feature\tscore\n"
    "A02-0\tA02-1\tA02-2\tA02-LC\t1\n"
    "A02-0\tA02-LC\t1\n"
    "A02-1\t1\n"
)


def _torch_engine(index, cfg):
    return TorchAlignEngine(index, cfg, device="cpu")


def _jax_engine(index, cfg):
    return DeviceAlignEngine(index, cfg, use_pallas_walk="fused")


def _tsv(make_engine, lib, fastqs, out, mm=None,
         chem=LibraryChemistry.NONE, chunk_reads=None):
    cfg, ref = load_reference_library(lib, chem)
    if mm is not None:
        cfg.num_mismatches = mm
    index = build_index(get_reference_sequence_data(ref)[0])
    kw = {} if chunk_reads is None else {"chunk_reads": chunk_reads}
    fastq_pipeline.process(list(fastqs), [make_engine(index, cfg)], [ref],
                           [cfg], [str(out)], **kw)
    return out.read_bytes()


def _both(tmp_path, lib, fastqs, **kw):
    got = _tsv(_torch_engine, lib, fastqs, tmp_path / "torch.tsv", **kw)
    want = _tsv(_jax_engine, lib, fastqs, tmp_path / "jax.tsv", **kw)
    assert got == want
    return got.decode()


def test_basic_fixture_tsv(tmp_path):
    got = _both(tmp_path, library_path("basic.json"),
                [reads_path("basic.fastq")], mm=0)
    assert got == BASIC_TSV


@pytest.mark.parametrize("lib,fastq,mm", [
    ("basic.json", "basic.fastq", 2),
    ("basic-rev.json", "basic.fastq", 1),
    ("mismatch.json", "mismatch.fastq", 0),
    ("mismatch.json", "mismatch.fastq", 1),
])
def test_fixture_tsvs_match_jax_engine(tmp_path, lib, fastq, mm):
    got = _both(tmp_path, library_path(lib), [reads_path(fastq)], mm=mm)
    if lib == "mismatch.json":
        assert got == f"feature\tscore\ngene\t{1 + mm}\n"


def test_paired_fixtures_match_jax_engine(tmp_path):
    _both(tmp_path, library_path("basic.json"),
          [reads_path("fastq_pipeline_test_r1.fastq"),
           reads_path("fastq_pipeline_test_r2.fastq")],
          chem=LibraryChemistry.UNSTRANDED)


@pytest.mark.parametrize("seed,read_len,chunk", [(0, 90, None), (1, 120, 700)])
def test_synthetic_single_end(tmp_path, seed, read_len, chunk):
    wl = write_workload(str(tmp_path / "wl"), n_features=10, feat_len=400,
                        read_len=read_len, n_reads=1500, seed=seed)
    got = _both(tmp_path, wl.library, wl.inputs, chunk_reads=chunk)
    assert len(got.splitlines()) > 10


@pytest.mark.parametrize("chem", [LibraryChemistry.UNSTRANDED,
                                  LibraryChemistry.FIVE_PRIME])
def test_synthetic_paired(tmp_path, chem):
    wl = write_workload(str(tmp_path / "wl"), n_features=8, feat_len=400,
                        read_len=80, n_reads=1000, seed=3, paired=True,
                        mate_gap=60)
    got = _both(tmp_path, wl.library, wl.inputs, chem=chem)
    assert len(got.splitlines()) > 5


def test_compact_results_match_jax_engine_with_rescue():
    """align_raw_compact_from_matrix of both engines on mixed lengths,
    including short reads (no launch) and reads longer than the largest
    bucket (host rescue)."""
    rng = np.random.default_rng(9)
    feats = ["".join(rng.choice(list("ACGT"), size=300)) for _ in range(6)]
    index = build_index(feats)
    cfg, _ = load_reference_library(library_path("basic.json"),
                                    LibraryChemistry.NONE)
    cfg.score_threshold, cfg.num_mismatches = 40, 1
    lens = rng.integers(20, 140, 300).astype(np.int32)
    mat = np.zeros((300, 140), dtype=np.int8)
    codes = [np.frombuffer(f.encode(), np.uint8) for f in feats]
    lut = np.zeros(256, np.int8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    for i, L in enumerate(lens):
        src = lut[codes[i % 6]]
        s = int(rng.integers(0, 300 - L))
        mat[i, :L] = src[s : s + L]
    buckets = (64, 92, 96, 128)
    t = TorchAlignEngine(index, cfg, device="cpu", buckets=buckets,
                         launch_batch=64)
    j = DeviceAlignEngine(index, cfg, buckets=buckets,
                          use_pallas_walk="fused")
    got = t.align_raw_compact_from_matrix(mat, lens)
    want = j.align_raw_compact_from_matrix(mat, lens)
    for key in ("astart", "mask", "passed", "needs_host"):
        sel = want["passed"] | want["needs_host"] if key in ("astart", "mask") \
            else slice(None)
        np.testing.assert_array_equal(got[key][sel], want[key][sel],
                                      err_msg=key)
    assert got["needs_host"][lens > 128].all()
    assert got["passed"].sum() > 100


@pytest.mark.parametrize("paired", [False, True])
def test_torch_engine_matches_host_oracle(tmp_path, paired):
    """TSVs through the port equal the NumPy oracle engine's (the general
    per-read path, independent of the compact kernels)."""
    wl = write_workload(str(tmp_path / "wl"), n_features=6, feat_len=300,
                        read_len=70, n_reads=400, seed=4, paired=paired,
                        mate_gap=50)
    chem = LibraryChemistry.UNSTRANDED
    got = _tsv(_torch_engine, wl.library, wl.inputs, tmp_path / "t.tsv",
               chem=chem)
    want = _tsv(HostAlignEngine, wl.library, wl.inputs, tmp_path / "h.tsv",
                chem=chem)
    assert got == want
    assert len(got.splitlines()) > 5


# --- the reference's oracle vectors (tests/test_oracle_alignment.py) -------

def _oracle_run(seq_filename, lib_filename, mismatches, group_on=False):
    cfg, ref = load_reference_library(library_path(lib_filename),
                                      LibraryChemistry.NONE)
    index = build_index(get_reference_sequence_data(ref)[0])
    reads = read_fastq_codes(reads_path(seq_filename))
    cfg.num_mismatches = mismatches
    if group_on:
        ref.group_on = 4
        ref.headers.append("test_group_on")
        ref.columns.append(["g1", "g1", "g2", "g2", "g2", "g2", "g1", "g1",
                            "g1", "g1"])
    res = fast_count_calls(reads, None, _torch_engine(index, cfg), ref, cfg)
    return [(features, entry[0]) for features, entry in res]


@pytest.mark.parametrize("lib", ["basic.json", "basic-rev.json"])
@pytest.mark.parametrize("mismatches,expected_a02_1", [(0, 1), (1, 1), (2, 2)])
def test_oracle_basic_cases(lib, mismatches, expected_a02_1):
    assert _oracle_run("basic.fastq", lib, mismatches) == [
        (["A02-0", "A02-1", "A02-2", "A02-LC"], 1),
        (["A02-0", "A02-LC"], 1),
        (["A02-1"], expected_a02_1),
    ]


def test_oracle_group_by():
    assert _oracle_run("basic.fastq", "basic.json", 0, group_on=True) == [
        (["g1"], 1), (["g1", "g2"], 1), (["g2"], 1),
    ]


@pytest.mark.parametrize("mismatches,expected_count", [(0, 1), (1, 2)])
def test_oracle_mismatch_cases(mismatches, expected_count):
    assert _oracle_run("mismatch.fastq", "mismatch.json", mismatches) == [
        (["gene"], expected_count)]
