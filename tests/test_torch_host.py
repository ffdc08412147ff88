"""The port's copies of the host modules vs the JAX package's originals.

``nimble_tpu_torch`` keeps its own copy of the jax-free host code it runs
(library loading, index build, FASTQ and BAM readers, trim, orientation,
dedupe, the NumPy oracle engine, writers) and of the C++ host library
(``csrc/nimble_host.cpp``).  Each case runs the JAX package's function and
the port's copy on the same inputs, made from a seed with numpy, each side
with its own loaders (``tests/torch_sides.py``), and asserts byte or array
equality: the copies must give the same bytes.
"""

import dataclasses
import enum

import numpy as np
import pytest

from conftest import DATA_DIR, library_path, reads_path
from torch_sides import JAX, PORT

SIDES = (JAX, PORT)
GOLDEN_BAM = str(DATA_DIR / "golden" / "forensic.bam")


@pytest.fixture(scope="module", autouse=True)
def native_libraries():
    from test_torch_bam import ensure_native_libraries

    ensure_native_libraries()


def _plain(x):
    """Package-neutral form of a result: dataclasses as tuples of their
    fields, enums by name, numpy arrays as (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _plain(v)) for k, v in x.items())
    return x


def _same(fn):
    """``fn(side)`` on both sides, in package-neutral form; asserts equal
    and returns the port's."""
    want, got = (_plain(fn(side)) for side in SIDES)
    assert got == want
    return got


def _ragged(rng, n, lo, hi, high=4, dtype=np.int8):
    lens = rng.integers(lo, hi, n)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return offs, rng.integers(0, high, int(offs[-1])).astype(dtype)


# --- native (C++ host library, or its NumPy fallback) -----------------------

NATIVE_CASES = ["encode_bases_bulk", "pack_reads_64", "pack_reads_92",
                "fill_matrix_encode", "orient_decode", "take_rows",
                "extract_kmer_keys", "owner_hash"]


@pytest.mark.parametrize("op", NATIVE_CASES)
def test_native_ops_match(op):
    rng = np.random.default_rng(NATIVE_CASES.index(op))
    if op == "encode_bases_bulk":
        data = bytes(rng.choice(list(b"ACGTacgtNnRY-\n@+"), 5000))
        _same(lambda s: s.native.encode_bases_bulk(data))
    elif op.startswith("pack_reads"):
        bucket = int(op.rsplit("_", 1)[1])
        mat = rng.integers(0, 4, (300, 120)).astype(np.int8)
        lens = rng.integers(20, bucket + 1, 300).astype(np.int32)
        _same(lambda s: s.native.pack_reads(mat, lens, bucket, 320))
    elif op == "fill_matrix_encode":
        raw = bytes(rng.choice(list(b"ACGTNacgtn@+I\n"), 20000))
        lens = rng.integers(0, 150, 100).astype(np.int64)
        offs = np.sort(rng.integers(0, 20000 - 150, 100)).astype(np.int64)

        def fill(s):
            out = np.zeros((110, 160), dtype=np.int8)
            assert s.native.fill_matrix_encode(raw, offs, lens, 160, out,
                                               row0=5)
            return out
        _same(fill)
    elif op == "orient_decode":
        offs, flat = _ragged(rng, 200, 0, 130)
        rev = (rng.random(200) < 0.5).astype(np.uint8)
        _same(lambda s: s.native.orient_decode(offs, flat, rev, 128))
    elif op == "take_rows":
        offs, flat = _ragged(rng, 200, 0, 40, high=256, dtype=np.uint8)
        idx = rng.integers(0, 200, 500)
        _same(lambda s: s.native.take_rows(offs, flat, idx))
    elif op == "extract_kmer_keys":
        codes = rng.integers(0, 4, 4000).astype(np.int8)
        _same(lambda s: s.native.extract_kmer_keys(codes, 30))
    elif op == "owner_hash":
        # over 2^16 rows: the threaded path; lengths past the row width are
        # clipped to it
        mat = rng.integers(0, 4, (70000, 90)).astype(np.int8)
        lens = rng.integers(20, 100, 70000).astype(np.int32)
        mate = rng.integers(0, 4, (70000, 60)).astype(np.int8)
        mate_lens = rng.integers(20, 61, 70000).astype(np.int32)
        out = _same(lambda s: (s.native.owner_hash(mat, lens, 7),
                               s.native.owner_hash(mat[:500], lens[:500], 3,
                                                   mate[:500],
                                                   mate_lens[:500]),
                               s.native.owner_hash(mat, lens, 5, mate,
                                                   mate_lens)))
        assert len(set(np.frombuffer(out[0][2], np.int64))) == 7
    assert PORT.native.available()


def test_native_build_is_the_ports_own():
    """The port loads its own library, built from its own source into its
    build directory, not the JAX package's."""
    from nimble_tpu_torch import native

    so = native.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "nimble_tpu_torch"
    assert native._SRC.parent.name == "csrc"


# --- FASTQ, trim, orientation, dedupe, writers ------------------------------

@pytest.mark.parametrize("chunk_reads", [7, 64, 1 << 17])
@pytest.mark.parametrize("fastq", ["basic.fastq", "fastq_pipeline_test_r1.fastq",
                                   "synthetic"])
def test_fastq_chunks_match(tmp_path, fastq, chunk_reads):
    if fastq == "synthetic":
        from nimble_tpu_torch.workload import write_workload

        path = write_workload(str(tmp_path / "wl"), n_features=5,
                              feat_len=300, read_len=90, n_reads=700,
                              seed=3).inputs[0]
    else:
        path = reads_path(fastq)
    chunks = _same(
        lambda s: list(s.iter_fastq_matrix_chunks(path, chunk_reads)))
    assert len(chunks) >= 1


def _quality_at_fastq(path, n=40):
    """A FASTQ whose even records' quality lines start with '@' (Phred
    Q31), as a record header does; returns the byte offsets of every
    record start and of every quality line that starts with '@'."""
    rng = np.random.default_rng(12)
    starts, quals, data = [], [], b""
    for i in range(n):
        L = int(rng.integers(30, 95))
        seq = bytes(rng.choice(list(b"ACGTN"), L))
        qual = (b"@" if i % 2 == 0 else b"I") + bytes(
            rng.choice(list(b"@I#5"), L - 1))
        starts.append(len(data))
        head = b"@read%d\n" % i + seq + b"\n+\n"
        if i % 2 == 0:
            quals.append(len(data) + len(head))
        data += head + qual + b"\n"
    with open(path, "wb") as f:
        f.write(data)
    return starts, quals, len(data)


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
@pytest.mark.parametrize("split", ["quality_at", "record_start", "even"])
def test_fastq_byterange_shards_match(tmp_path, monkeypatch, split, native):
    """read_fastq_matrix_byterange over a file cut at byte offsets that
    land on a quality line starting with '@', on a record start, or evenly
    in 5: each shard equals the JAX shard, and the shards in order hold
    the whole file's reads."""
    path = str(tmp_path / "q.fastq")
    starts, quals, size = _quality_at_fastq(path)
    cuts = {"quality_at": quals[3:30:6], "record_start": starts[5:35:7],
            "even": [size * h // 5 for h in range(1, 5)]}[split]
    bounds = [0, *cuts, size]
    if not native:
        for side in SIDES:
            monkeypatch.setattr(side.native, "available", lambda: False)
    fastq = {id(s): s.module("io.fastq") for s in SIDES}
    shards = _same(lambda s: [
        fastq[id(s)].read_fastq_matrix_byterange(path, lo, hi)
        for lo, hi in zip(bounds, bounds[1:])])
    rows = [bytes(np.frombuffer(m[2], np.int8).reshape(m[1])[i, : ln])
            for (m, (_d, _s, lb)) in shards
            for i, ln in enumerate(np.frombuffer(lb, np.int32))]
    mat, lens = PORT.module("io.fastq").read_fastq_matrix(path)
    assert rows == [bytes(mat[i, : lens[i]]) for i in range(len(lens))]
    assert len(rows) == 40 and all(m[1][0] for m, _l in shards)


@pytest.mark.parametrize("target,strictness", [(50, 0.9), (40, 0.5), (30, 0.0)])
@pytest.mark.parametrize("form", ["strings", "columnar"])
def test_maxinfo_batch_matches(target, strictness, form):
    rng = np.random.default_rng(target)
    offs, flat = _ragged(rng, 400, 0, 160, high=42, dtype=np.uint8)
    flat = flat + 33
    quals = [bytes(flat[offs[i]:offs[i + 1]]).decode() for i in range(400)]
    cols = type("Col", (), {"offs": offs, "flat": flat})()

    out = _same(lambda side: side.module("core.trim").maxinfo_batch(
        quals if form == "strings" else cols, target, strictness))
    assert len(set(out[2])) > 1


@pytest.mark.parametrize("chemistry", ["NONE", "UNSTRANDED", "FIVE_PRIME",
                                       "THREE_PRIME"])
def test_orientation_filters_match(chemistry):
    names = [f"F{i}" for i in range(6)] + [f"F{i}§rev" for i in range(6)]

    def run(side):
        orient = side.module("core.orientation")
        r = np.random.default_rng(7)
        out = []
        for _ in range(300):
            seq = list(r.choice(names, int(r.integers(0, 5)), replace=False))
            mate = list(r.choice(names, int(r.integers(0, 5)), replace=False))
            out.append(orient.filter_orientation_on_library_chemistry(
                seq, mate, side.LibraryChemistry[chemistry]))
            out.append(orient.get_all_calls(seq, mate))
            out.append(orient.filter_read_calls_with_orientation(seq))
        return out
    _same(run)


def test_dedupe_admit_matches():
    """The shared seen-set admission over chunks with repeats within and
    across chunks, single-end and paired."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 4, (40, 80)).astype(np.int8)
    blens = rng.integers(30, 81, 40).astype(np.int32)
    chunks = []
    for _ in range(4):
        pick = rng.integers(0, 40, 64)
        chunks.append((base[pick], blens[pick], base[pick[::-1]],
                       blens[pick[::-1]]))

    def run(side):
        fc = side.module("core.fast_count")
        out = []
        for paired in (False, True):
            seen = side.native.make_dedupe_set()
            assert seen is not None
            for mat, lens, mm, ml in chunks:
                out.append(fc.dedupe_admit(seen, mat, lens,
                                           *((mm, ml) if paired else ())))
        return out
    _same(run)


def test_write_to_tsv_matches(tmp_path):
    rng = np.random.default_rng(8)
    results = [([f"F{j}" for j in rng.integers(0, 9, int(rng.integers(1, 4)))],
                int(rng.integers(1, 1000))) for _ in range(50)]

    def run(side):
        writers = side.module("io.writers")
        out = tmp_path / f"{id(side)}.tsv"
        writers.write_to_tsv(results[:20], str(out))
        writers.write_to_tsv(results[20:], str(out))  # appends, one header
        return out.read_bytes()
    assert _same(run).startswith(b"feature\tscore\n")


# --- BAM, index, oracle engine ----------------------------------------------

@pytest.mark.parametrize("batch_records,paired", [(64, False), (1000, False),
                                                  (64, True)])
def test_bam_columnar_stream_matches(batch_records, paired):
    """The columnar group stream over the golden BAM: every batch's
    columns, group offsets and the final-group flag."""
    def run(side):
        stream = side.module("io.bam_columnar").ColumnarGroupStream(
            GOLDEN_BAM, paired)
        cols = [{f.name: (getattr(b, f.name).offs, getattr(b, f.name).flat)
                 if hasattr(getattr(b, f.name), "offs")
                 else getattr(b, f.name) for f in dataclasses.fields(b)}
                for b in stream.batches(batch_records)]
        return cols, stream.final_open_group_pending
    cols, _ = _same(run)
    assert len(cols) >= 1


@pytest.mark.parametrize("lib", ["basic.json", "mismatch.json",
                                 "strandedness.json", "synthetic"])
def test_bucketed_index_matches(lib):
    def run(side):
        if lib == "synthetic":
            rng = np.random.default_rng(6)
            seqs = ["".join(rng.choice(list("ACGT"), size=int(n)))
                    for n in rng.integers(40, 600, 60)]
        else:
            _cfg, ref = side.load_reference_library(
                library_path(lib), side.LibraryChemistry.NONE)
            seqs = side.get_reference_sequence_data(ref)[0]
        index = side.build_index(seqs)
        return index, side.build_bucketed_index(index)
    _same(run)


@pytest.mark.parametrize("lib,fastq,chemistry,mm", [
    ("basic.json", ["basic.fastq"], "NONE", 0),
    ("basic.json", ["basic.fastq"], "NONE", 2),
    ("mismatch.json", ["mismatch.fastq"], "NONE", 1),
    ("basic.json", ["fastq_pipeline_test_r1.fastq",
                    "fastq_pipeline_test_r2.fastq"], "UNSTRANDED", 1),
    ("synthetic", None, "FIVE_PRIME", 1),
])
def test_host_align_engine_matches(tmp_path, lib, fastq, chemistry, mm):
    """HostAlignEngine's per-read results, and the TSV each side's FASTQ
    pipeline writes with it."""
    if lib == "synthetic":
        from nimble_tpu_torch.workload import write_workload

        wl = write_workload(str(tmp_path / "wl"), n_features=6, feat_len=300,
                            read_len=80, n_reads=300, seed=9, paired=True,
                            mate_gap=50)
        lib_path, inputs = wl.library, wl.inputs
    else:
        lib_path, inputs = library_path(lib), [reads_path(f) for f in fastq]

    def run(side):
        cfg, ref = side.load_reference_library(
            lib_path, side.LibraryChemistry[chemistry])
        cfg.num_mismatches = mm
        engine = side.HostAlignEngine(
            side.build_index(side.get_reference_sequence_data(ref)[0]), cfg)
        per_read = engine.align_batch(side.read_fastq_codes(inputs[0]))
        out = tmp_path / f"{id(side)}.tsv"
        side.fastq_pipeline.process(inputs, [engine], [ref], [cfg], [str(out)])
        return per_read, out.read_bytes()
    per_read, tsv = _same(run)
    assert per_read and tsv.startswith(b"feature\tscore\n")
