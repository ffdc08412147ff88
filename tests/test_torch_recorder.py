"""The port's span and counter recorder (``nimble_tpu_torch.utils.metrics``).

Unit cases run on recorders of their own; the pipeline cases run a FASTQ
``process`` and a BAM ``process_fast`` at tiny sizes on the CPU with
``NIMBLE_TIMING`` set and read the process's recorder: every chunk or
batch carries its spans on the threads that do its work under one id, the
counters count the reads and rows, and the ``NIMBLE_TIMING`` lines, now
rendered from the recorder, give ``portbench.trace.parse_timing`` the keys
they always gave.  A profiler case ties the recorder's clock to a
``torch.profiler`` trace through the pass annotations.
"""

import contextlib
import gzip
import io
import json
import statistics
import sys
import threading

import numpy as np
import pytest

from nimble_tpu_torch.utils import metrics
from nimble_tpu_torch.utils.metrics import OFF, RECORDER, Recorder


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("NIMBLE_TIMING", "1")


def test_off_reads_no_clock_and_records_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.delenv("NIMBLE_TIMING", raising=False)
    monkeypatch.setattr(metrics.time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(metrics.time, "thread_time_ns", no_clock)
    rec = Recorder()
    with rec.traced_pass("fastq.pass") as whole:
        with rec.span("fastq.parse", chunk=3, items=9) as s:
            s.tag(4)
        rec.count("fastq.reads_in", 10)
    assert whole is OFF and s is OFF and rec.span("x") is OFF
    assert rec.current_chunk() is None
    assert rec.spans == [] and rec.counters == {}


def test_on_records_every_field(traced):
    rec = Recorder()
    with rec.traced_pass("fastq.pass") as whole:
        assert rec.on
        with rec.span("fastq.submit", items=7, chunk=2) as outer:
            assert rec.current_chunk() == 2
            with rec.span("fastq.count") as inner:
                sum(range(20000))
        with rec.span("fastq.parse_wait", wait=True) as waited:
            waited.tag(5)
    assert not rec.on
    assert [s.name for s in rec.spans] == [
        "fastq.count", "fastq.submit", "fastq.parse_wait", "fastq.pass"]
    me = threading.current_thread()
    for s in rec.spans:
        assert (s.thread, s.thread_name) == (me.ident, me.name)
        assert 0 < s.start_ns <= s.end_ns and s.cpu_ns >= 0
    assert whole.wait and whole.parent is None and whole.chunk is None
    assert (outer.items, outer.chunk, outer.wait) == (7, 2, False)
    assert outer.parent == whole.id and inner.parent == outer.id
    assert inner.chunk == 2  # a child takes its parent's chunk
    assert inner.cpu_ns > 0
    assert (waited.chunk, waited.items, waited.wait) == (5, 0, True)
    assert whole.start_ns <= outer.start_ns <= inner.start_ns
    assert inner.end_ns <= outer.end_ns <= waited.start_ns <= whole.end_ns


def test_counters_add_up_only_while_traced(traced, monkeypatch):
    rec = Recorder()
    rec.count("fastq.reads_in", 5)
    with rec.traced_pass("fastq.pass"):
        for n in (3, 4, 0):
            rec.count("fastq.reads_in", n)
        rec.count("fastq.rescued", np.int64(2))
    rec.count("fastq.reads_in", 5)
    assert rec.counters == {"fastq.reads_in": 7, "fastq.rescued": 2}
    assert type(rec.counters["fastq.rescued"]) is int


def test_spans_and_counts_from_four_threads(traced):
    rec = Recorder()
    per_thread, errors = 300, []

    def work(k: int) -> None:
        try:
            for i in range(per_thread):
                with rec.span("outer", chunk=(k, i)):
                    with rec.span("inner"):
                        rec.count("n", 1)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rec.traced_pass("pass"):
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert rec.counters == {"n": 4 * per_thread}
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans) == 8 * per_thread + 1
    inner = [s for s in rec.spans if s.name == "inner"]
    assert len(inner) == 4 * per_thread
    for s in inner:
        parent = by_id[s.parent]
        assert parent.name == "outer" and parent.thread == s.thread
        assert parent.chunk == s.chunk
    assert len({s.chunk for s in inner}) == 4 * per_thread


def test_parent_and_self_time(traced):
    rec = Recorder()
    with rec.traced_pass("pass"):
        with rec.span("outer") as outer:
            with rec.span("a") as a:
                with rec.span("a.leaf") as leaf:
                    sum(range(1000))
            with rec.span("b") as b:
                sum(range(1000))
    own = Recorder.self_ns(rec.spans)

    def dur(s):
        return s.end_ns - s.start_ns

    assert own[leaf.id] == dur(leaf)
    assert own[a.id] == dur(a) - dur(leaf)
    assert own[outer.id] == dur(outer) - dur(a) - dur(b)
    assert all(v >= 0 for v in own.values())


def test_a_traced_pass_after_an_untraced_one_clears_the_buffer(monkeypatch):
    rec = Recorder()

    def run(on: bool, name: str) -> None:
        if on:
            monkeypatch.setenv("NIMBLE_TIMING", "1")
        else:
            monkeypatch.delenv("NIMBLE_TIMING", raising=False)
        with rec.traced_pass("pass"):
            with rec.span(name):
                rec.count(name, 1)

    run(True, "first")
    run(True, "second")  # traced passes in a row add
    assert [s.name for s in rec.spans if s.name != "pass"] == [
        "first", "second"]
    run(False, "untraced")  # records nothing, leaves the buffer as it is
    assert [s.name for s in rec.spans if s.name != "pass"] == [
        "first", "second"] and not rec.on
    run(True, "third")  # after an untraced pass: a new buffer
    assert [s.name for s in rec.spans] == ["third", "pass"]
    assert rec.counters == {"third": 1}


def test_set_up_spans_are_recorded_with_tracing_off(monkeypatch):
    monkeypatch.delenv("NIMBLE_TIMING", raising=False)
    rec = Recorder()
    with rec.setup_span("setup.kernel_load", chunk="k") as load:
        with rec.setup_span("setup.kernel_build", chunk="k"):
            pass
    assert [s.name for s in rec.setup] == ["setup.kernel_build",
                                           "setup.kernel_load"]
    assert load.seconds >= 0 and rec.spans == []
    monkeypatch.setenv("NIMBLE_TIMING", "1")
    with rec.traced_pass("pass"):
        pass
    rec.clear()
    assert len(rec.setup) == 2 and rec.spans == []


def test_build_seconds_is_a_view_of_the_kernel_spans():
    from nimble_tpu_torch.ops import _build

    name = "test_recorder_kernel"
    assert name not in _build.build_seconds
    with pytest.raises(KeyError):
        _build.build_seconds[name]
    with metrics.setup_span("setup.kernel_load", chunk=name):
        pass
    assert _build.build_seconds[name] == 0.0  # loaded, not built
    with metrics.setup_span("setup.kernel_load", chunk=name):
        with metrics.setup_span("setup.kernel_build", chunk=name) as build:
            pass
    assert _build.build_seconds[name] == build.seconds
    assert name in _build.build_seconds


# --- the pipelines, traced ---------------------------------------------------

# the end of a single-end pass's ``[fastq counts]`` line: no pair counted
SINGLE_END_PAIRS = ("pairs-in 0 pairs-both 0 pairs-one-mate 0 pairs-invalid 0 "
                    "mate-ready 0")


@pytest.fixture(scope="module")
def fastq_job(tmp_path_factory):
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.workload import write_workload

    wl = write_workload(str(tmp_path_factory.mktemp("fq")), n_features=8,
                        feat_len=300, read_len=90, n_reads=3000, seed=7)
    cfg, ref = load_reference_library(wl.library,
                                      LibraryChemistry.UNSTRANDED)
    engine = TorchAlignEngine(build_index(get_reference_sequence_data(ref)[0]),
                              cfg, device="cpu")
    with open(wl.inputs[0]) as f:
        seqs = f.read().splitlines()[1::4]
    return wl, engine, ref, cfg, seqs


def _fastq_pass(fastq_job, out):
    from nimble_tpu_torch.pipeline import fastq_pipeline

    wl, engine, ref, cfg, _ = fastq_job
    fastq_pipeline.process(wl.inputs, [engine], [ref], [cfg], [str(out)],
                           chunk_reads=1024)


def _threads_by_chunk(spans, names):
    out = {}
    for s in spans:
        if s.name in names:
            out.setdefault(s.chunk, {}).setdefault(s.name, set()).add(
                s.thread_name.rsplit("_", 1)[0])
    return out


def test_a_traced_fastq_pass_spans_every_thread_of_each_chunk(
        fastq_job, traced, tmp_path, capsys):
    from portbench.trace import parse_timing

    RECORDER.clear()
    _fastq_pass(fastq_job, tmp_path / "out.tsv")
    err = capsys.readouterr().err
    seqs = fastq_job[4]
    threads = {"fastq.parse": "fastq-parse", "fastq.parse.read":
               "fastq-parse", "fastq.parse.scan": "fastq-parse",
               "fastq.parse.fill": "fastq-parse",
               "fastq.parse_wait": "MainThread", "fastq.submit": "MainThread",
               "fastq.dispatch": "fastq-dispatch",
               "fastq.collect": "fastq-fetch", "fastq.drain": "MainThread",
               "fastq.count": "MainThread"}
    got = _threads_by_chunk(RECORDER.spans, threads)
    n_chunks = -(-len(seqs) // 1024)
    for chunk in range(n_chunks):
        assert got[chunk] == {n: {t} for n, t in threads.items()}, chunk
    assert [s.name for s in RECORDER.spans if s.chunk is None] == [
        "fastq.finalize", "fastq.pass"]
    assert RECORDER.counters["fastq.reads_in"] == len(seqs)
    assert RECORDER.counters["fastq.rows_launched"] == len(set(seqs))
    assert RECORDER.counters["fastq.rescued"] == 0
    assert set(parse_timing(err)) == {"fastq.parse-wait", "fastq.submit",
                                      "fastq.drain"}
    assert (f"[fastq counts] reads-in {len(seqs)} rows-launched "
            f"{len(set(seqs))} rescued 0") in err
    assert not RECORDER.on


def test_a_traced_fastq_pass_counts_the_bytes_it_parsed(
        fastq_job, traced, tmp_path, capsys):
    """The ``[fastq counts]`` line gives the FASTQ's size as the bytes the
    parse took in, and the times its read buffer grew: none, since the
    first buffer holds a chunk of these reads; one library: no row
    stacked."""
    import os

    RECORDER.clear()
    _fastq_pass(fastq_job, tmp_path / "out.tsv")
    err = capsys.readouterr().err
    size = os.path.getsize(fastq_job[0].inputs[0])
    assert RECORDER.counters["fastq.bytes_in"] == size
    assert (f"rescued 0 bytes-in {size} parse.buffer-grows 0 "
            f"rows-stacked 0 fallback-rows 0 {SINGLE_END_PAIRS}\n") in err


def test_an_untraced_fastq_pass_records_nothing(fastq_job, monkeypatch,
                                                 tmp_path, capsys):
    monkeypatch.delenv("NIMBLE_TIMING", raising=False)
    RECORDER.clear()
    _fastq_pass(fastq_job, tmp_path / "out.tsv")
    assert RECORDER.spans == [] and RECORDER.counters == {}
    assert capsys.readouterr().err == ""


def test_a_traced_bam_pass_spans_every_thread_of_each_batch(
        traced, tmp_path, capsys):
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.pipeline.bam_fast import process_fast
    from nimble_tpu_torch.workload import write_bam_workload
    from portbench.trace import parse_timing

    wl = write_bam_workload(str(tmp_path / "wl"), n_features=6, feat_len=300,
                            n_groups=600, seed=3)
    cfg, ref = load_reference_library(wl.library,
                                      LibraryChemistry.UNSTRANDED)
    engine = TorchAlignEngine(build_index(get_reference_sequence_data(ref)[0]),
                              cfg, device="cpu")
    out = str(tmp_path / "out.tsv.gz")
    RECORDER.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast(wl.inputs, [engine], [ref], [cfg], [out], 2, False,
                     batch_records=1024)
    err = capsys.readouterr().err
    threads = {"bam.read": "bam-producer", "bam.queue_wait": "bam-consumer-0",
               "bam.prepare": "bam-consumer-0", "bam.collect": "bam-fetch",
               "bam.collect_wait": "bam-consumer-0",
               "bam.finish": "bam-consumer-0", "bam.gzip_write": "bam-logger"}
    got = _threads_by_chunk(RECORDER.spans, threads)
    batches = sorted(c for c in got if c is not None and "bam.prepare"
                     in got[c])
    assert len(batches) >= 2 and batches == list(range(len(batches)))
    for seq in batches:
        assert got[seq] == {n: {t} for n, t in threads.items()}, seq
    scans = [s for s in RECORDER.spans if s.name == "bam.scan"]
    assert scans and {s.thread_name for s in scans} == {"bam-scan"}
    groups = [s for s in RECORDER.spans if s.name == "bam.group"]
    by_id = {s.id: s for s in RECORDER.spans}
    assert groups and all(by_id[s.parent].name == "bam.read" for s in groups)
    for name, thread in (("bam.validate", "bam-logger"),
                         ("bam.open", "bam-producer")):
        assert [s.thread_name for s in RECORDER.spans
                if s.name == name] == [thread]
    with gzip.open(out, "rb") as f:
        rows = f.read().count(b"\n") - 1  # the header
    counts = RECORDER.counters
    assert counts["bam.records_in"] == 8 * 600 - 8  # the last group dropped
    assert 0 < counts["bam.rows_launched"] <= counts["bam.records_in"]
    assert counts["bam.rows_written"] == rows and counts["bam.rescued"] == 0
    assert set(parse_timing(err)) == {
        "bam.read", "bam.prepare", "bam.collect-wait", "bam.finish",
        "bam.queue-wait", "bam.gzip-write"}
    assert (f"[bam_fast counts] records-in {8 * 600 - 8} rows-launched "
            f"{counts['bam.rows_launched']} rescued 0 rows-written {rows}"
            ) in err
    assert err.count("[bam_fast wall] ") == 3


def test_a_traced_bam_pass_waits_for_a_batch_outside_its_finish(
        traced, tmp_path):
    """``bam.queue_wait`` times only a consumer's wait for its next batch:
    no ``bam.collect_wait`` or ``bam.finish`` span, nor any other, opens
    inside it."""
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.pipeline.bam_fast import process_fast
    from nimble_tpu_torch.workload import write_bam_workload

    wl = write_bam_workload(str(tmp_path / "wl"), n_features=6, feat_len=300,
                            n_groups=200, seed=4)
    cfg, ref = load_reference_library(wl.library,
                                      LibraryChemistry.UNSTRANDED)
    engine = TorchAlignEngine(build_index(get_reference_sequence_data(ref)[0]),
                              cfg, device="cpu")
    RECORDER.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast(wl.inputs, [engine], [ref], [cfg],
                     [str(tmp_path / "out.tsv.gz")], 2, False,
                     batch_records=256)
    by_id = {s.id: s for s in RECORDER.spans}
    for name in ("bam.collect_wait", "bam.finish"):
        assert len([s for s in RECORDER.spans if s.name == name]) >= 2
    assert [s.name for s in RECORDER.spans if s.parent is not None
            and by_id[s.parent].name == "bam.queue_wait"] == []


def test_a_traced_5p_bam_pass_counts_clipped_records_and_oriented_out_pairs(
        traced, tmp_path, capsys):
    """A 10x 5′ BAM (124-base R1s, 150-base R2s) under the ``fiveprime``
    filter: the ``[bam_fast counts]`` line ends with ``records-clipped``,
    the R1 records in, and ``pairs-oriented-out``; each batch opens
    ``bam.orient`` once, inside ``bam.finish`` on the consumer, ``items``
    its distinct combinations."""
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.pipeline.bam_fast import process_fast
    from portbench import fiveprime, generate, spec

    cell = spec.load_cell("basic_fiveprime_bam_tenx5p", spec.benchmark())
    lib = generate.library(cell["config_file"])
    recs = fiveprime.records(lib, cell["traffic_file"], 400, seed=6)
    bam, library = str(tmp_path / "r.bam"), str(tmp_path / "lib.json")
    fiveprime.write_bam(bam, recs)
    generate.write_library(library, lib)
    cfg, ref = load_reference_library(library, LibraryChemistry.FIVE_PRIME)
    engine = TorchAlignEngine(build_index(get_reference_sequence_data(ref)[0]),
                              cfg, device="cpu")
    RECORDER.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast([bam], [engine], [ref], [cfg],
                     [str(tmp_path / "out.tsv.gz")], 2, False,
                     batch_records=512)
    err = capsys.readouterr().err
    counts = RECORDER.counters
    records = 8 * 400 - 8  # the last group dropped
    assert counts["bam.records_in"] == records
    assert counts["bam.records_clipped"] == records // 2
    out = counts["bam.pairs_oriented_out"]
    assert 0 < out < records // 2
    assert err.rstrip("\n").endswith(
        f"records-clipped {records // 2} pairs-oriented-out {out}")
    by_id = {s.id: s for s in RECORDER.spans}
    orients = [s for s in RECORDER.spans if s.name == "bam.orient"]
    finishes = [s for s in RECORDER.spans if s.name == "bam.finish"]
    assert len(orients) == len(finishes) >= 2
    for s in orients:
        assert by_id[s.parent].name == "bam.finish"
        assert s.thread_name == "bam-consumer-0"
    assert 0 < sum(s.items for s in orients)


def _entropy_spans(name, parent):
    """The spans ``name``, each inside a span ``parent`` on its thread."""
    by_id = {s.id: s for s in RECORDER.spans}
    spans = [s for s in RECORDER.spans if s.name == name]
    assert spans
    for s in spans:
        assert by_id[s.parent].name == parent
        assert by_id[s.parent].thread == s.thread
    return spans


def test_a_traced_fastq_pass_spans_the_entropy_gate_of_each_launch(
        fastq_job, traced, tmp_path, capsys):
    """``fastq.collect.entropy``, inside ``fastq.collect``, counts the
    rows of every launch; the native count leaves ``entropy.fallback_rows``
    at 0."""
    from nimble_tpu_torch import native

    assert native.available()
    RECORDER.clear()
    _fastq_pass(fastq_job, tmp_path / "out.tsv")
    err = capsys.readouterr().err
    spans = _entropy_spans("fastq.collect.entropy", "fastq.collect")
    assert sum(s.items for s in spans) == RECORDER.counters[
        "fastq.rows_launched"]
    assert RECORDER.counters.get("entropy.fallback_rows", 0) == 0
    assert f"fallback-rows 0 {SINGLE_END_PAIRS}\n" in err


def test_a_traced_bam_pass_spans_the_entropy_gate_of_each_launch(
        traced, tmp_path, capsys):
    """``bam.collect.entropy``, inside ``bam.collect`` on the fetcher,
    counts the distinct rows of every launch: ``bam.rows_launched`` in
    all; the native count leaves ``entropy.fallback_rows`` at 0."""
    from nimble_tpu_torch import native
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.pipeline.bam_fast import process_fast
    from nimble_tpu_torch.workload import write_bam_workload

    assert native.available()
    wl = write_bam_workload(str(tmp_path / "wl"), n_features=6, feat_len=300,
                            n_groups=300, seed=5)
    cfg, ref = load_reference_library(wl.library,
                                      LibraryChemistry.UNSTRANDED)
    engine = TorchAlignEngine(build_index(get_reference_sequence_data(ref)[0]),
                              cfg, device="cpu")
    RECORDER.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast(wl.inputs, [engine], [ref], [cfg],
                     [str(tmp_path / "out.tsv.gz")], 2, False,
                     batch_records=512)
    err = capsys.readouterr().err
    spans = _entropy_spans("bam.collect.entropy", "bam.collect")
    assert len(spans) >= 2
    assert {s.thread_name.rsplit("_", 1)[0] for s in spans} == {"bam-fetch"}
    assert sum(s.items for s in spans) == RECORDER.counters[
        "bam.rows_launched"] > 0
    assert RECORDER.counters.get("entropy.fallback_rows", 0) == 0
    out = RECORDER.counters.get("bam.pairs_oriented_out", 0)
    assert (f"rows-stacked 0 fallback-rows 0 rows-decoded 0 records-clipped 0 "
            f"pairs-oriented-out {out}\n") in err


@pytest.mark.parametrize("multiple", [False, True])
def test_a_traced_stacked_bam_pass_gates_entropy_once_a_launch(
        traced, tmp_path, capsys, multiple):
    """Two libraries in one stacked pass: ``bam.collect.entropy`` opens
    in ``bam.collect`` once a launch, outside each library's
    ``bam.collect.library``, so its items sum to ``bam.rows_launched``;
    ``bam.rows_decoded`` reads 0 unless a library turns its
    multiple-match gate on."""
    import dataclasses

    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.aligner import TorchAlignEngine
    from nimble_tpu_torch.pipeline.bam_fast import process_fast
    from nimble_tpu_torch.workload import write_multi_bam_workload

    wl = write_multi_bam_workload(str(tmp_path / "wl"),
                                  libraries=[(6, 300), (4, 300)],
                                  n_groups=300, seed=6)
    engines, refs, cfgs, outs = [], [], [], []
    for i, path in enumerate(wl.libraries):
        cfg, ref = load_reference_library(path, LibraryChemistry.UNSTRANDED)
        if i == 1:
            cfg = dataclasses.replace(cfg, discard_multiple_matches=multiple)
        engines.append(TorchAlignEngine(
            build_index(get_reference_sequence_data(ref)[0]), cfg,
            device="cpu"))
        refs.append(ref)
        cfgs.append(cfg)
        outs.append(str(tmp_path / f"out{i}.tsv.gz"))
    RECORDER.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        process_fast(wl.inputs, engines, refs, cfgs, outs, 2, False,
                     batch_records=512)
    err = capsys.readouterr().err
    spans = _entropy_spans("bam.collect.entropy", "bam.collect")
    counts = RECORDER.counters
    assert len(spans) >= 2
    assert sum(s.items for s in spans) == counts["bam.rows_launched"] \
        == counts["bam.rows_stacked"] > 0
    collects = [s for s in RECORDER.spans if s.name == "bam.collect"]
    libraries = [s for s in RECORDER.spans if s.name == "bam.collect.library"]
    assert len(libraries) == 2 * len(collects)
    decoded = counts.get("bam.rows_decoded", 0)
    assert (decoded > 0) == multiple
    assert decoded <= counts["bam.rows_launched"]
    assert (f"rows-stacked {counts['bam.rows_stacked']} fallback-rows 0 "
            f"rows-decoded {decoded} records-clipped 0 pairs-oriented-out "
            f"{counts.get('bam.pairs_oriented_out', 0)}\n") in err


def test_the_pass_annotations_tie_the_recorder_to_a_profiler_trace(
        fastq_job, traced, tmp_path, capsys):
    from torch.profiler import ProfilerActivity, profile

    RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _fastq_pass(fastq_job, tmp_path / "out.tsv")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    traced = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                    for e in events if e.get("name") == "fastq.pass"
                    and e.get("ph") == "X")
    recorded = sorted((s.start_ns * 1e-9, s.end_ns * 1e-9)
                      for s in RECORDER.spans if s.name == "fastq.pass")
    assert len(traced) == len(recorded) == 3
    # a pass's offset: the less of its start's and its end's (a wait
    # between the program's clock read and the annotation's is one-sided)
    offsets = [min(t[0] - r[0], t[1] - r[1])
               for t, r in zip(traced, recorded)]
    offset = statistics.median(offsets)
    assert all(abs(o - offset) < 1e-4 for o in offsets), offsets
    for t, r in zip(traced, recorded):
        assert abs(t[0] - (r[0] + offset)) < 3e-3  # the first opening's cost
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    # the main thread's stages are annotations too
    assert {"fastq.parse_wait", "fastq.drain", "fastq.finalize"} <= names
