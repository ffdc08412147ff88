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

NATIVE_CASES = ["fastq_scan", "pack_reads_64", "pack_reads_92",
                "fill_matrix_encode", "orient_decode", "take_rows",
                "extract_kmer_keys", "owner_hash"]


@pytest.mark.parametrize("op", NATIVE_CASES)
def test_native_ops_match(op):
    rng = np.random.default_rng(NATIVE_CASES.index(op))
    if op == "fastq_scan":
        # a whole file's scan: CRLF and trailing spaces, blank lines, '@'
        # quality lines, empty sequences, no newline at the end
        data = _fastq_bytes(rng, rng.integers(0, 130, 300), crlf=True,
                            spaces=True, blanks=True, quality_at=True,
                            last_newline=False)
        _same(lambda s: s.native.fastq_scan(data, 1000))
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

def _fastq_bytes(rng, lens, *, crlf=False, spaces=False, blanks=False,
                 quality_at=False, last_newline=True, width=None):
    """FASTQ text of records whose sequences have ``lens`` bases drawn
    from ACGTN and lower case: CRLF line ends, trailing spaces on every
    line, blank lines between records (and first and last), quality lines
    that start with '@', or no newline after the last line, as asked."""
    eol = b"\r\n" if crlf else b"\n"
    pad = b"  " if spaces else b""
    out = [b"\n \r\n" if blanks else b""]
    for i, n in enumerate(lens):
        seq = bytes(rng.choice(list(b"ACGTNacgtn"), int(n)))
        qual = bytes(rng.choice(list(b"I#5@"), int(n)))
        if quality_at and i % 2 == 0:
            qual = b"@" + qual[1:] if n else b"@"
        out.append(b"@r%d x" % i + pad + eol + seq + pad + eol + b"+" + pad
                   + eol + qual + pad + eol)
        if blanks and i % 3 == 1:
            out.append(eol + b"   " + eol)
    data = b"".join(out)
    if not last_newline:
        data = data.rstrip(b"\r\n ")
    return data


# kinds of FASTQ input for the chunked parse; a kind in _TINY_BUFFER runs
# the port with a first buffer of about a byte a record
_FASTQ_KINDS = ["basic.fastq", "fastq_pipeline_test_r1.fastq", "synthetic",
                "crlf_spaces", "blank_lines", "quality_at", "straddle",
                "long_record", "no_final_newline", "mixed_lengths", "gzip",
                "paired"]
_TINY_BUFFER = ("straddle", "long_record")


def _fastq_inputs(tmp_path, kind):
    """The input files of a FASTQ kind (R1 and R2 for ``paired``)."""
    import gzip

    if kind.endswith(".fastq"):
        return [reads_path(kind)]
    if kind == "synthetic":
        from nimble_tpu_torch.workload import write_workload

        return [write_workload(str(tmp_path / "wl"), n_features=5,
                               feat_len=300, read_len=90, n_reads=700,
                               seed=3).inputs[0]]
    rng = np.random.default_rng(_FASTQ_KINDS.index(kind))
    if kind == "paired":
        # mates of other lengths, so the two files' chunks differ in bytes
        texts = [_fastq_bytes(rng, rng.integers(20, 60, 500)),
                 _fastq_bytes(rng, rng.integers(100, 160, 500), crlf=True)]
    elif kind == "long_record":
        lens = rng.integers(30, 100, 20)
        lens[9] = 200_000
        texts = [_fastq_bytes(rng, lens)]
    else:
        lens = (rng.integers(0, 300, 400) if kind == "mixed_lengths"
                else rng.integers(60, 120, 400))
        texts = [_fastq_bytes(rng, lens, crlf=kind == "crlf_spaces",
                              spaces=kind == "crlf_spaces",
                              blanks=kind == "blank_lines",
                              quality_at=kind == "quality_at",
                              last_newline=kind != "no_final_newline")]
    paths = []
    for i, text in enumerate(texts):
        path = tmp_path / f"{kind}_{i}.fastq"
        if kind == "gzip":
            path = tmp_path / "reads.fastq.gz"
            text = gzip.compress(text)
        path.write_bytes(text)
        paths.append(str(path))
    return paths


def _decompressed_size(path):
    import gzip

    with open(path, "rb") as f:
        data = f.read()
    return len(gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data)


@pytest.mark.parametrize("chunk_reads", [7, 64, 1 << 17])
@pytest.mark.parametrize("fastq", _FASTQ_KINDS)
def test_fastq_chunks_match(tmp_path, monkeypatch, fastq, chunk_reads):
    """The port's chunks equal the JAX package's, chunk for chunk: exactly
    ``chunk_reads`` records each, every chunk as wide as its own longest
    read and zero past each length; a traced parse counts the file's bytes,
    and a buffer too small for a chunk grows."""
    from nimble_tpu_torch.io import fastq as port_fastq
    from nimble_tpu_torch.utils.metrics import RECORDER

    paths = _fastq_inputs(tmp_path, fastq)
    if fastq in _TINY_BUFFER:
        monkeypatch.setattr(port_fastq, "FIRST_BYTES_PER_RECORD", 1)
    monkeypatch.setenv("NIMBLE_TIMING", "1")
    RECORDER.clear()
    per_file = []
    for path in paths:
        want = _plain(list(JAX.iter_fastq_matrix_chunks(path, chunk_reads)))
        with RECORDER.traced_pass("fastq.pass"):
            chunks = list(PORT.iter_fastq_matrix_chunks(path, chunk_reads))
        assert _plain(chunks) == want
        per_file.append([len(lens) for _mat, lens in chunks])
        for mat, lens in chunks:
            assert mat.shape[1] == max(int(lens.max()), 1)
            assert not (mat * (np.arange(mat.shape[1]) >= lens[:, None])).any()
    assert all(n == chunk_reads for n in per_file[0][:-1])
    assert per_file[0] == per_file[-1]  # paired files chunk in lockstep
    assert RECORDER.counters["fastq.bytes_in"] == sum(
        _decompressed_size(p) for p in paths)
    grows = RECORDER.counters.get("fastq.parse.buffer_grows", 0)
    if fastq in _TINY_BUFFER:
        assert grows >= 1
    elif chunk_reads == 1 << 17:
        assert grows == 0  # the first buffer holds the whole file


@pytest.mark.parametrize("fastq", [k for k in _FASTQ_KINDS if k != "paired"])
def test_fastq_matrix_match(tmp_path, fastq):
    """``read_fastq_matrix`` equals the JAX package's on every kind, and
    ``read_fastq_matrix_byterange`` over thirds of a plain file too."""
    path = _fastq_inputs(tmp_path, fastq)[0]
    fastq_mod = {id(s): s.module("io.fastq") for s in SIDES}
    _same(lambda s: fastq_mod[id(s)].read_fastq_matrix(path))
    if fastq != "gzip":
        size = _decompressed_size(path)
        bounds = [0, size // 3, 2 * size // 3, size]
        _same(lambda s: [fastq_mod[id(s)].read_fastq_matrix_byterange(
            path, lo, hi) for lo, hi in zip(bounds, bounds[1:])])


def _malformed(kind):
    """(good records, the fault after them): a record a line short, a
    header without '@', a separator without '+', or a file that ends after
    a header, after a separator, or inside a sequence line."""
    rng = np.random.default_rng(7)
    return _fastq_bytes(rng, rng.integers(40, 90, 30)), {
        "bad_header": b"r31\nACGT\n+\nIIII\n@r32\nA\n+\nI\n",
        "bad_separator": b"@r31\nACGT\n-\nIIII\n",
        "missing_record_line": b"@r31\nACGT\n+\n@r32\nACGT\n+\nIIII\n",
        "ends_after_header": b"@r31\n",
        "ends_after_separator": b"@r31\nACGT\n+\n",
        "ends_in_sequence": b"@r31\nACG",
    }[kind]


@pytest.mark.parametrize("reader", ["chunks_7", "chunks_big", "matrix",
                                    "byterange"])
@pytest.mark.parametrize("kind", ["bad_header", "bad_separator",
                                  "missing_record_line", "ends_after_header",
                                  "ends_after_separator", "ends_in_sequence",
                                  "invalid_data"])
def test_malformed_fastq_raises_like_the_jax_package(tmp_path, kind, reader):
    """Both packages raise "Unable to read sequence" on a malformed or
    truncated file; the chunks the port yields before it hold only the
    good records, in order."""
    good_path = tmp_path / "good.fastq"
    if kind == "invalid_data":  # its first line is no header
        path = reads_path("fastq_invalid_data.fastq")
        good_path.write_bytes(b"")
    else:
        good, fault = _malformed(kind)
        good_path.write_bytes(good)
        path = str(tmp_path / "bad.fastq")
        with open(path, "wb") as f:
            f.write(good + fault)
    size = _decompressed_size(path)
    for side in SIDES:
        fastq_mod = side.module("io.fastq")
        rows = []
        with pytest.raises(ValueError, match="Unable to read sequence"):
            if reader == "matrix":
                fastq_mod.read_fastq_matrix(path)
            elif reader == "byterange":
                fastq_mod.read_fastq_matrix_byterange(path, 0, size)
            else:
                chunk = 7 if reader == "chunks_7" else 1 << 17
                for mat, lens in side.iter_fastq_matrix_chunks(path, chunk):
                    rows += [bytes(m[:n]) for m, n in zip(mat, lens)]
        good = [bytes(c) for c in side.read_fastq_codes(str(good_path))]
        assert rows == good[:len(rows)]


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

_FEATS = [
    "ACGTACGGATCCTTAGCAGTACCGATGGCATCAGGCTTACAGATTCCGGATACCGTTAGGCATCAGAT",
    "TTGACCGGTTAACCGGATCCAGTACCATGGCCTTAGACATCCGGTAACCGATTCCAGGATCCATGACA",
]
_CB = b"CBX00001-1"
_FIRST, _SECOND, _R2 = 0x1 | 0x40, 0x1 | 0x80, 0x1 | 0x80 | 0x10


def _synthetic_bam(**kw):
    def write(path):
        from nimble_tpu.io.synth import make_synthetic_bam

        make_synthetic_bam(path, _FEATS, **kw)
    return write


def _records_bam(make_records):
    """A BAM of the records ``make_records(rec, frag)`` lists, written by
    the JAX package's writer: ``rec(qname, flag, ub=...)`` is one record
    with a 60 bp fragment of ``_FEATS``, CB ``_CB`` and UMI ``ub`` (None:
    no UB tag)."""
    def write(path):
        from nimble_tpu.io.bam import BamHeader, BamRecord, write_bam

        rng = np.random.default_rng(3)

        def rec(qname, flag, ub=b"CCCCCCCCCC"):
            f = _FEATS[int(rng.integers(0, len(_FEATS)))]
            at = int(rng.integers(0, len(f) - 60))
            seq = f[at:at + 60]
            r = BamRecord(qname=qname, flag=flag, tid=0, pos=1, mtid=0,
                          mpos=1, seq=seq, qual=bytes([35] * len(seq)))
            r.tags["CB"] = ("Z", _CB.decode())
            if ub is not None:
                r.tags["UB"] = ("Z", ub.decode())
            return r

        write_bam(path, BamHeader(text="@HD\tVN:1.6\n",
                                  references=[("chr1", 100000)]),
                  make_records(rec))
    return write


def _pairs(rec, groups, prefix="g"):
    """Two mate pairs of each UMI in ``groups``."""
    return [rec(f"{prefix}{g}x{i}", flag, ub=umi)
            for g, umi in enumerate(groups) for i in range(2)
            for flag in (_FIRST, _R2)]


def _irregular(rec):
    # a paired-flagged orphan inside a populated run: the Python run
    # fallback and its unpaired-qname warnings
    recs = [rec(f"p{i}", flag) for i in range(2) for flag in (_FIRST, _R2)]
    recs += [rec("orphan", _FIRST), rec("p9", _FIRST), rec("p9", _R2)]
    return recs + _pairs(rec, [b"GGGGGGGGGG", b"TTTTTTTTTT"], "z")


def _missing_umi(rec):
    # the reference's fatal could-not-read-UMI record after two groups
    return (_pairs(rec, [b"CCCCCCCCCC", b"GGGGGGGGGG"])
            + [rec("bad", _FIRST, ub=None), rec("t0", _FIRST, ub=b"T" * 10),
               rec("t0", _R2, ub=b"T" * 10)])


def _leading_orphan(rec):
    # an all-orphan FIRST run takes the producer's one free pass
    return ([rec("lonely", _FIRST, ub=b"AACCGGTTAA")]
            + _pairs(rec, [b"CCCCCCCCCC", b"GGGGGGGGGG"]))


def _orphan_truncates(rec):
    # an all-orphan run after a delivered group ends the stream
    return (_pairs(rec, [b"CCCCCCCCCC", b"GGGGGGGGGG"])
            + [rec("lonely", _FIRST, ub=b"AACCGGTTAA")]
            + _pairs(rec, [b"TTTTTTTTTT"], "tail"))


def _truncated_bam(path):
    """A synthetic BAM whose decompressed stream ends mid-record, in a
    clean BGZF container with its EOF marker."""
    import gzip

    from nimble_tpu.io.bam import _BGZF_EOF, _bgzf_block

    _synthetic_bam(n_groups=3, pairs_per_group=2, read_len=64, seed=8)(path)
    with gzip.open(path, "rb") as f:
        payload = f.read()[:-7]
    with open(path, "wb") as f:
        for i in range(0, len(payload), 60000):
            f.write(_bgzf_block(payload[i:i + 60000]))
        f.write(_BGZF_EOF)


_STREAM_KINDS = {
    "golden": None,
    "regular": _synthetic_bam(n_groups=7, pairs_per_group=3, read_len=64,
                              unpaired_per_group=1, seed=5),
    "small_batches": _synthetic_bam(n_groups=12, pairs_per_group=2,
                                    read_len=64, seed=9),
    "irregular_qnames": _records_bam(_irregular),
    "missing_umi": _records_bam(_missing_umi),
    "leading_orphan": _records_bam(_leading_orphan),
    "orphan_truncates": _records_bam(_orphan_truncates),
    "truncated": _truncated_bam,
    "single_group": _synthetic_bam(n_groups=1, pairs_per_group=4,
                                   read_len=64, seed=10),
    "clip_124": _synthetic_bam(n_groups=4, pairs_per_group=2, read_len=111,
                               pad_to_124=True, seed=11),
}


@pytest.mark.parametrize("kind,batch_records,paired", [
    pytest.param("golden", 64, False, id="64-False"),
    pytest.param("golden", 1000, False, id="1000-False"),
    pytest.param("golden", 64, True, id="64-True"),
    ("regular", 16384, False),
    ("regular", 16384, True),
    ("small_batches", 4, False),
    ("irregular_qnames", 16384, False),
    ("missing_umi", 16384, False),
    ("leading_orphan", 16384, False),
    ("orphan_truncates", 16384, False),
    ("truncated", 16384, False),
    ("single_group", 16384, False),
    ("clip_124", 16384, False),
])
def test_bam_columnar_stream_matches(tmp_path, monkeypatch, kind,
                                     batch_records, paired):
    """The columnar group stream over the golden BAM and over each stream
    kind the producer's rules were written for: every batch's columns,
    group offsets, the stdout and stderr prints, the exception raised and
    the final-group flag.  The JAX package's stream runs its default, one
    scan-ahead thread.  The port's batches also mark the records whose SEQ
    the 10x 124-base rule clipped (``clipped``, which the JAX package's
    lack): every record of the padded stream, no other."""
    import contextlib
    import io

    for var in ("NIMBLE_BAM_PIPE", "NIMBLE_BAM_PREFETCH"):
        monkeypatch.delenv(var, raising=False)
    path = GOLDEN_BAM
    if _STREAM_KINDS[kind] is not None:
        path = str(tmp_path / f"{kind}.bam")
        _STREAM_KINDS[kind](path)

    clipped = []  # the port's (marks, clipped lengths) a batch

    def run(side):
        out, err = io.StringIO(), io.StringIO()
        cols, exc = [], None
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            stream = side.module("io.bam_columnar").ColumnarGroupStream(
                path, paired)
            try:
                for b in stream.batches(batch_records):
                    if side is PORT:
                        clipped.append((b.clipped, b.seq.lens()))
                    cols.append({
                        f.name: (getattr(b, f.name).offs,
                                 getattr(b, f.name).flat)
                        if hasattr(getattr(b, f.name), "offs")
                        else getattr(b, f.name)
                        for f in dataclasses.fields(b)
                        if f.name != "clipped"})
            except Exception as e:  # noqa: BLE001 — compared below
                exc = (type(e).__name__, str(e))
        return (cols, out.getvalue(), err.getvalue(), exc,
                stream.final_open_group_pending, stream.read_counter)
    cols, out, _, exc, _, _ = _same(run)
    if kind == "truncated":
        assert exc == ("EOFError", "truncated BAM stream")
    elif kind == "missing_umi":
        assert exc == ("ValueError", "Error -- Could not read UMI.")
    else:
        assert exc is None and len(cols) >= 1
    if kind == "irregular_qnames":
        assert "Warning: Unpaired qname!" in out
    assert len(clipped) == len(cols)
    for marks, lens in clipped:
        assert marks.dtype == bool and len(marks) == len(lens)
        assert marks.all() if kind == "clip_124" else not marks.any()
        assert (lens[marks] == 124 - 13).all()


def test_bam_columnar_stream_close_stops_its_scan_thread(tmp_path):
    """Closing a stream after its first batch stops the ``bam-scan``
    thread, which small chunks keep blocked on its full queue."""
    import threading

    path = str(tmp_path / "in.bam")
    _synthetic_bam(n_groups=200, pairs_per_group=2, read_len=64, seed=12)(
        path)
    stream = PORT.module("io.bam_columnar").ColumnarGroupStream(path, False)
    stream._CHUNK = 4096
    it = stream.batches(4)
    assert len(next(it)) > 0
    thread = stream._prefetch_thread
    assert thread is not None and thread.is_alive()
    closer = threading.Thread(target=lambda: (it.close(), stream.close()))
    closer.start()
    closer.join(60)
    assert not closer.is_alive() and not thread.is_alive()
    assert not [t for t in threading.enumerate()
                if t.name == "bam-scan" and t.is_alive()]


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
