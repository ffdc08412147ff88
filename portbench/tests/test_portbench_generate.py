"""The generators repeat byte for byte for a seed, draw the same counts for
every seed, and the 10x BAM's mates come from one molecule."""

import numpy as np
import pytest

from portbench import generate, spec

BENCH = spec.benchmark()
SEEDS = (7, 2**31 + 5)


def _cell(name):
    return spec.load_cell(name, BENCH)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_library_is_the_published_file(config, tmp_path):
    """The library written for the program is the configuration's, and
    basic is nimble's basic.json as published (the repo's copy of it)."""
    import json

    cfg = spec.load_cell(next(w["name"] for w in BENCH["workloads"]
                              if w["config"] == config), BENCH)["config_file"]
    lib = generate.library(cfg)
    generate.write_library(str(tmp_path / "lib.json"), lib)
    written = json.loads((tmp_path / "lib.json").read_text())
    assert written == cfg["library"]
    table = written[1]
    seqs = table["columns"][table["headers"].index("sequence")]
    assert [generate.decode(c) for c in lib.codes] == [s.upper()
                                                       for s in seqs]
    if config == "basic":
        published = spec.ROOT / "tests" / "data" / "libraries" / "basic.json"
        assert written == json.loads(published.read_text())


def _big_library(seed: int) -> generate.Library:
    """A library of 2,000 random 500 bp features: too large for chance
    collisions between fragments."""
    rng = np.random.default_rng(seed)
    return generate.Library([], list(rng.integers(0, 4, (2000, 500),
                                                   dtype=np.int8)))


@pytest.mark.parametrize("cell", ["basic_fastq_ontarget"])
def test_fastq_repeats_and_counts_hold(cell, tmp_path):
    c = _cell(cell)
    n = 4096
    out = []
    for i, seed in enumerate((SEEDS[0], SEEDS[0], SEEDS[1])):
        lib = generate.library(c["config_file"])
        reads = generate.fastq_reads(lib, c["traffic_file"], n, seed)
        generate.write_fastq(str(tmp_path / f"r{i}.fastq"), reads)
        out.append(((tmp_path / f"r{i}.fastq").read_bytes(), reads))
    assert out[0][0] == out[1][0] and out[0][0] != out[2][0]
    assert out[0][1].shape == (n, c["traffic_file"]["read_len"])


def test_fastq_duplicates_are_as_stated():
    c = _cell("basic_fastq_ontarget")
    reads = generate.fastq_reads(_big_library(3), c["traffic_file"], 32768,
                                 SEEDS[0])
    distinct = len(np.unique(reads, axis=0))
    copies = c["traffic_file"]["copies"]
    # 2.5 reads a fragment
    assert abs(distinct / len(reads) - len(copies) / sum(copies)) < 0.01


@pytest.mark.parametrize("cell", ["basic_bam_10x"])
def test_bam_repeats_for_a_seed(cell, tmp_path):
    c = _cell(cell)
    lib = generate.library(c["config_file"])
    blobs = []
    for i, seed in enumerate((SEEDS[1], SEEDS[1], SEEDS[0])):
        recs = generate.tenx_records(lib, c["traffic_file"], 64, seed)
        generate.write_bam(str(tmp_path / f"{i}.bam"), recs)
        blobs.append((tmp_path / f"{i}.bam").read_bytes())
    assert blobs[0] == blobs[1] and blobs[0] != blobs[2]


def _find(seq: np.ndarray, rows: np.ndarray) -> set:
    """Rows holding ``seq`` as a substring."""
    text = [generate.decode(r) for r in rows]
    s = generate.decode(seq)
    return {i for i, t in enumerate(text) if s in t}


@pytest.mark.parametrize("cell", ["basic_bam_10x"])
def test_tenx_mates_share_a_feature_and_the_share_holds(cell):
    c = _cell(cell)
    tr = c["traffic_file"]
    lib = generate.library(c["config_file"])
    n_groups = 400
    recs = generate.tenx_records(lib, tr, n_groups, SEEDS[0])
    assert recs.on_library.sum() == round(tr["library_share"] * n_groups)
    feats = np.stack(lib.codes)
    per_group = 2 * tr["pairs_per_group"]
    checked = 0
    for g in np.flatnonzero(recs.on_library):
        hits = None
        for i in range(g * per_group, (g + 1) * per_group):
            # the stored sequence is reference-forward for both mates
            found = _find(recs.seq[i], feats)
            if found:  # reads with an error or junk are not found
                hits = found if hits is None else hits & found
        assert hits, "the mates of a group's pairs share no feature"
        checked += 1
    assert checked
    flags = recs.flag.reshape(-1, 2)
    assert (flags[:, 0] == generate.R1_FLAG).all()
    assert (flags[:, 1] == generate.R2_FLAG).all()


def test_errors_are_exact_shares():
    c = _cell("basic_bam_10x")
    tr = c["traffic_file"]
    lib = generate.library(c["config_file"])
    recs = generate.tenx_records(lib, tr, 256, SEEDS[0])
    feats = np.stack(lib.codes)
    clean = sum(bool(_find(s, feats)) for s in recs.seq[
        np.repeat(recs.on_library, 2 * tr["pairs_per_group"])])
    n_on = int(recs.on_library.sum()) * 2 * tr["pairs_per_group"]
    # about 75% of on-library reads are error free
    assert 0.6 * n_on < clean < 0.9 * n_on
