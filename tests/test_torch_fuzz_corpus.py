"""The port's campaign corpora vs the JAX package's campaign scripts.

For a child seed, ``nimble_tpu_torch.fuzz.corpus.draw_*_trial`` must give
what ``scripts/fuzz_differential.py``, ``scripts/fuzz_fastq.py`` and
``scripts/fuzz_bam.py`` build from the same seed: the same library rows,
reads, ``Reference`` and ``AlignFilterConfig`` fields, the same FASTQ and
BAM bytes, and the generator left in the same state.  The scripts are
loaded through ``importlib`` (``tests/conftest.py`` has put JAX on the CPU)
and run with their engines, ``build_index``, ``run_pipeline`` and
``run_both`` replaced by recorders, so no JAX engine runs; the BAM script's
draws are inline in ``main``, which runs for one trial under a stopped
clock.  Everything compared is an integer, a string or bytes: the
tolerance is equality.  A gzip file's header carries its write time, so
its four time bytes are zeroed on both sides before the compare.
"""

import enum
import importlib.util
import os
import sys
import types

import numpy as np
import pytest

from nimble_tpu_torch.fuzz import corpus
from nimble_tpu_torch.io.bam import write_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIFFERENTIAL_SEEDS = range(8)
FASTQ_SEEDS = range(14)
BAM_SEEDS = range(6)


class _Captured(Exception):
    """Raised by a recorder once a trial's draws are all made."""


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _value(v):
    return v.value if isinstance(v, enum.Enum) else v


def _config(cfg) -> dict:
    return {k: _value(v) for k, v in vars(cfg).items()}


def _reference(ref) -> dict:
    return {k: getattr(ref, k) for k in (
        "group_on", "headers", "columns", "sequence_name_idx",
        "sequence_idx")}


def _file_bytes(path) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":  # gzip: drop the header's write time
        data = data[:4] + b"\0\0\0\0" + data[8:]
    return data


def _state(rng):
    return rng.bit_generator.state


# --- the engine campaign ---------------------------------------------------

def _jax_differential(monkeypatch, child):
    mod = _script("fuzz_differential")
    rec = {}

    def build_index(doubled):
        rec["doubled"] = list(doubled)
        return "index"

    class Host:
        def __init__(self, index, cfg):
            rec["config"] = cfg

        def align_batch(self, reads):
            rec["reads"] = [np.asarray(r) for r in reads]
            raise _Captured

    monkeypatch.setattr(mod, "build_index", build_index)
    monkeypatch.setattr(mod, "HostAlignEngine", Host)
    monkeypatch.setattr(mod, "DeviceAlignEngine",
                        lambda *a, **k: types.SimpleNamespace())
    rng = np.random.default_rng(child)
    try:
        assert mod.check_trial(rng, False, False) == 0
        rec = None  # an empty library: the trial was skipped
    except _Captured:
        pass
    return rec, _state(rng)


@pytest.mark.parametrize("child", DIFFERENTIAL_SEEDS)
def test_differential_corpus_matches_the_jax_script(monkeypatch, child):
    want, want_state = _jax_differential(monkeypatch, child)
    rng = np.random.default_rng(child)
    got = corpus.draw_differential_trial(rng)
    assert _state(rng) == want_state
    if want is None:
        assert got is None
        return
    assert got.doubled == want["doubled"]
    assert _config(got.config) == _config(want["config"])
    assert len(got.reads) == len(want["reads"])
    for g, w in zip(got.reads, want["reads"]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --- the FASTQ campaign ----------------------------------------------------

def _jax_fastq(monkeypatch, child, td):
    mod = _script("fuzz_fastq")
    import nimble_tpu.models.mesh_aligner as jax_mesh

    rec = {"doubled": [], "mesh": False, "runs": []}

    def build_index(doubled):
        rec["doubled"].append(list(doubled))
        return len(rec["doubled"]) - 1

    def engine(kind):
        def make(index, cfg, **kw):
            return (kind, index)
        return make

    def mesh_engine(index, cfg):
        rec["mesh"] = True
        return ("mesh", index)

    def run_pipeline(files, engines, refs, cfgs, td_, tag):
        rec["runs"].append((tag, list(engines), [_reference(r) for r in refs],
                            [_config(c) for c in cfgs]))
        rec["files"] = {os.path.basename(f): _file_bytes(f) for f in files}
        return [b""] * len(engines)

    monkeypatch.setattr(mod, "build_index", build_index)
    monkeypatch.setattr(mod, "DeviceAlignEngine", engine("device"))
    monkeypatch.setattr(mod, "HostAlignEngine", engine("host"))
    monkeypatch.setattr(jax_mesh, "MeshAlignEngine", mesh_engine)
    monkeypatch.setattr(mod, "run_pipeline", run_pipeline)
    rng = np.random.default_rng(child)
    n = mod.check_trial(rng, str(td), 3)
    return (rec if n else None), _state(rng)


@pytest.mark.parametrize("child", FASTQ_SEEDS)
def test_fastq_corpus_matches_the_jax_script(monkeypatch, tmp_path, child):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    want, want_state = _jax_fastq(monkeypatch, child, jax_dir)
    rng = np.random.default_rng(child)
    got = corpus.draw_fastq_trial(rng)
    assert _state(rng) == want_state
    if want is None:
        assert got is None
        return
    assert [lib.doubled for lib in got.libraries] == want["doubled"]
    fast = want["runs"][0]
    assert fast[0] == "fast3"
    assert [_reference(lib.reference) for lib in got.libraries] == fast[2]
    assert [_config(lib.config) for lib in got.libraries] == fast[3]
    assert got.use_mesh == want["mesh"]
    assert (len(got.libraries) == 2) == (len(fast[1]) == 2)
    ext = ".fastq.gz" if got.gz else ".fastq"
    names = [f"r1_3{ext}"] + ([f"r2_3{ext}"] if got.paired else [])
    assert sorted(want["files"]) == sorted(names)
    for name, seqs in zip(names, [got.r1s, got.r2s]):
        corpus.write_fastq(str(port_dir / name), seqs, got.gz)
        assert _file_bytes(port_dir / name) == want["files"][name], name


def test_fastq_seeds_cover_the_trial_shapes():
    """The seeds above reach every branch of the FASTQ draw: paired and
    single, gzip, two libraries, a mesh trial and a group_on column."""
    seen = set()
    for child in FASTQ_SEEDS:
        t = corpus.draw_fastq_trial(np.random.default_rng(child))
        if t is None:
            continue
        seen |= {("paired", t.paired), ("gz", t.gz),
                 ("libraries", len(t.libraries)), ("mesh", t.use_mesh),
                 ("group_on", t.libraries[0].reference.group_on)}
    assert {("paired", True), ("paired", False), ("gz", True),
            ("libraries", 2), ("mesh", True), ("group_on", 2)} <= seen


# --- the BAM campaign ------------------------------------------------------

def _jax_bam(monkeypatch, seed):
    mod = _script("fuzz_bam")
    rec = {}
    clock = iter([0.0, 0.0])

    def build_index(doubled):
        rec["doubled"] = list(doubled)
        return "index"

    def device_engine(index, cfg):
        rec["config"] = _config(cfg)
        return "engine"

    real_write_bam = mod.write_bam

    def write_bam_(path, header, records):
        rec["header"] = (header.text, list(header.references))
        real_write_bam(path, header, records)

    def run_both(bam, engine, ref, cfg, quirks, td, tag):
        rec["reference"] = _reference(ref)
        with open(bam, "rb") as f:
            rec["bam"] = f.read()
        return b"", b""

    monkeypatch.setattr(mod, "build_index", build_index)
    monkeypatch.setattr(mod, "DeviceAlignEngine", device_engine)
    monkeypatch.setattr(mod, "write_bam", write_bam_)
    monkeypatch.setattr(mod, "run_both", run_both)
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        time=lambda: next(clock, 1e18)))
    monkeypatch.setattr(sys, "argv", ["fuzz_bam.py", "--minutes", "1",
                                      "--seed", str(seed)])
    mod.main()
    return rec


@pytest.mark.parametrize("seed", BAM_SEEDS)
def test_bam_corpus_matches_the_jax_script(monkeypatch, tmp_path, seed,
                                           capsys):
    want = _jax_bam(monkeypatch, seed)
    assert "DONE: 1 trials" in capsys.readouterr().out
    child = int(np.random.default_rng(seed).integers(0, 2**63 - 1))
    got = corpus.draw_bam_trial(np.random.default_rng(child))
    assert got.doubled == want["doubled"]
    assert _config(got.config) == want["config"]
    assert _reference(got.reference) == want["reference"]
    header = corpus.BAM_HEADER
    assert (header.text, list(header.references)) == want["header"]
    path = str(tmp_path / "port.bam")
    write_bam(path, header, got.records)
    with open(path, "rb") as f:
        assert f.read() == want["bam"]
