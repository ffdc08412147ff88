"""The paired-end FASTQ job of the benchmark's ``basic_fastq_paired150`` cell on
the CPU: nimble's R1/R2 job against the published ``basic`` library, through
the CLI's ``fastq_pipeline.process([r1, r2], ...)``.

For seeded pairs drawn by the benchmark's own generator
(``portbench/paired.py``) at a small size, the output must equal the plain
paired reference (``portbench.reference.paired.fastq_pair_tsv``) byte for
byte: under the library's published filters, and with the filters the cell
leaves at their defaults turned on (``require_valid_pair``,
``intersect_level`` 1 and 2), each of which changes the output (the pair
check drops every FR pair: its mates hit a row and the reverse complement
of a row, whose eq classes differ).  A traced pass counts the pairs and
the reads of both files, opens the pair's spans and parses each file on a
thread of its own.  Both parse threads start with the pass, before the
loop asks for a chunk, and stop, closing their files, when the loop is
abandoned.
"""

import contextlib
import io
import json
import os
import threading

import numpy as np
import pytest

from nimble_tpu_torch.utils.metrics import RECORDER
from portbench import spec
from portbench.paths import fastq_paired
from portbench.reference import paired as reference

SEEDS = (3, 2**31 + 7, 2**44 + 9)
PAIRS = 1500
CHUNK = 512   # reads a chunk: several chunks, the last one short
FILTERS = {"published": {}, "valid_pair": {"require_valid_pair": True},
           "intersect_1": {"intersect_level": 1},
           "intersect_2": {"intersect_level": 2}}


def _library(inputs, filters, work):
    """The cell's library JSON with ``filters`` changed, for the program and
    the reference alike."""
    with open(inputs["library"]) as f:
        obj = json.load(f)
    obj[0].update(filters)
    path = os.path.join(work, "library.json")
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def _engines(library, n=1):
    from nimble_tpu_torch.config import LibraryChemistry
    from nimble_tpu_torch.index.build import build_index
    from nimble_tpu_torch.library import (
        get_reference_sequence_data,
        load_reference_library,
    )
    from nimble_tpu_torch.models.aligner import TorchAlignEngine

    cfg, ref = load_reference_library(library, LibraryChemistry.UNSTRANDED)
    index = build_index(get_reference_sequence_data(ref)[0])
    return ([TorchAlignEngine(index, cfg, device="cpu") for _ in range(n)],
            [ref] * n, [cfg] * n)


def _process(inputs, library, outs, traced=False):
    from nimble_tpu_torch.pipeline.fastq_pipeline import process

    engines, refs, cfgs = _engines(library, len(outs))
    previous = os.environ.get("NIMBLE_TIMING")
    if traced:
        os.environ["NIMBLE_TIMING"] = "1"
        RECORDER.clear()
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            process(inputs["inputs"], engines, refs, cfgs, outs,
                    chunk_reads=CHUNK)
    finally:
        if previous is None:
            os.environ.pop("NIMBLE_TIMING", None)
        else:
            os.environ["NIMBLE_TIMING"] = previous
    result = []
    for out in outs:
        with open(out, "rb") as f:
            result.append(f.read())
    return result


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    """The cell's inputs at ``PAIRS`` pairs, a seed."""
    done = {}

    def get(seed):
        if seed not in done:
            cell = dict(spec.load_cell("basic_fastq_paired150",
                                       spec.benchmark()))
            cell["pairs_per_pass"] = PAIRS
            work = str(tmp_path_factory.mktemp(f"paired{seed}"))
            done[seed] = fastq_paired.make_inputs(cell, seed, work)
        return done[seed]

    return get


@pytest.fixture(scope="module")
def jobs(drawn, tmp_path_factory):
    """(the program's TSV, the reference's) of a seed under ``filters``."""
    done = {}

    def get(seed, filters):
        if (seed, filters) not in done:
            inputs = drawn(seed)
            work = str(tmp_path_factory.mktemp(f"{filters}{seed}"))
            library = _library(inputs, FILTERS[filters], work)
            (got,) = _process(inputs, library,
                              [os.path.join(work, "out.tsv")])
            want = reference.fastq_pair_tsv(
                library, inputs["strand_filter"], inputs["r1"], inputs["r2"],
                "cpu")
            done[seed, filters] = got, want
        return done[seed, filters]

    return get


@pytest.mark.parametrize("filters", sorted(FILTERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_paired_job_equals_the_reference(jobs, seed, filters):
    got, want = jobs(seed, filters)
    assert got == want
    if filters == "valid_pair":
        # an FR pair's mates hit a row and the other row's reverse
        # complement: their eq classes differ, so the check drops it
        assert got == b"feature\tscore\n"
    else:
        assert got.count(b"\n") > 2  # calls, not just the header
    if filters != "published":
        assert got != jobs(seed, "published")[0]


def test_a_traced_pass_counts_pairs_and_the_reads_of_both_files(
        drawn, tmp_path):
    inputs = drawn(SEEDS[0])
    _process(inputs, inputs["library"], [str(tmp_path / "out.tsv")],
             traced=True)
    c = RECORDER.counters
    assert c["fastq.pairs_in"] == PAIRS
    assert c["fastq.reads_in"] == 2 * PAIRS
    assert c["fastq.pairs_both"] > 0 and c["fastq.pairs_one_mate"] > 0
    assert c["fastq.pairs_both"] + c["fastq.pairs_one_mate"] <= PAIRS
    assert c.get("fastq.pairs_invalid", 0) == 0  # the published filters
    assert c["fastq.rows_launched"] <= c["fastq.reads_in"]
    assert 0 <= c.get("fastq.mate_ready", 0) <= -(-PAIRS // CHUNK)
    names = {s.name for s in RECORDER.spans}
    assert {"fastq.parse_wait.mate", "fastq.stack_pair"} <= names
    mate_waits = [s for s in RECORDER.spans
                  if s.name == "fastq.parse_wait.mate"]
    assert len(mate_waits) == -(-PAIRS // CHUNK) and all(
        s.wait for s in mate_waits)
    assert {s.thread_name for s in RECORDER.spans
            if s.name == "fastq.parse"} == {"fastq-parse", "fastq-parse-r2"}
    stacks = [s for s in RECORDER.spans if s.name == "fastq.stack_pair"]
    assert sum(s.items for s in stacks) == c["fastq.rows_launched"]


def test_a_single_end_traced_pass_counts_no_mate_ready(drawn, tmp_path):
    inputs = drawn(SEEDS[0])
    _process(dict(inputs, inputs=inputs["inputs"][:1]), inputs["library"],
             [str(tmp_path / "out.tsv")], traced=True)
    c = RECORDER.counters
    assert c["fastq.reads_in"] == PAIRS
    assert c.get("fastq.mate_ready", 0) == c.get("fastq.pairs_in", 0) == 0
    assert {s.thread_name for s in RECORDER.spans
            if s.name == "fastq.parse"} == {"fastq-parse"}
    assert not any(s.name == "fastq.parse_wait.mate" for s in RECORDER.spans)


def test_the_pair_check_counts_the_pairs_it_drops(drawn, tmp_path):
    inputs = drawn(SEEDS[1])
    library = _library(inputs, FILTERS["valid_pair"], str(tmp_path))
    _process(inputs, library, [str(tmp_path / "out.tsv")], traced=True)
    c = RECORDER.counters
    assert 0 < c["fastq.pairs_invalid"] <= PAIRS
    # nothing is counted: every pair with a call is an FR pair
    assert c.get("fastq.pairs_both", 0) == c.get("fastq.pairs_one_mate", 0) == 0


def test_a_two_library_paired_job_stacks_the_pair_once(drawn, jobs,
                                                       tmp_path):
    """Two engines share the stacked pass (``_dispatch_multi``): the pair's
    stack opens there, and each library's output is the reference's."""
    inputs = drawn(SEEDS[2])
    outs = [str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")]
    got = _process(inputs, inputs["library"], outs, traced=True)
    want = jobs(SEEDS[2], "published")[1]
    assert got == [want, want]
    assert any(s.name == "fastq.stack_pair" for s in RECORDER.spans)
    assert RECORDER.counters["fastq.rows_stacked"] == RECORDER.counters[
        "fastq.rows_launched"]


# --- the parse threads' start and stop -----------------------------------


class _Chunks:
    """A stub chunk iterator: ``n`` chunks of ``rows`` reads, ``first``
    called before the first is handed out; it records its close."""

    def __init__(self, n, first=None, rows=4):
        self.n, self.first, self.rows = n, first, rows
        self.given = 0
        self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if not self.given and self.first is not None:
            self.first()
        if self.given >= self.n:
            raise StopIteration
        self.given += 1
        return (np.zeros((self.rows, 8), np.int8),
                np.full(self.rows, 8, np.int32))

    def close(self):
        self.closed = True


def _loop(r1, r2):
    from nimble_tpu_torch.pipeline.fastq_pipeline import _run_fast_loop

    _run_fast_loop(r1, r2, [], None, None, None, [])


def _assert_parse_threads_stopped():
    for t in threading.enumerate():
        if t.name in ("fastq-parse", "fastq-parse-r2"):
            t.join(2)
            assert not t.is_alive(), t.name


def test_both_parse_threads_start_before_the_first_chunk_is_handed_over():
    """R1's first chunk comes only once R2's parse has begun: a loop that
    asked for R2 after R1's first chunk had come would wait in vain."""
    r2_started = threading.Event()

    def r1_first():
        if not r2_started.wait(5):
            raise TimeoutError("R2's parse did not start beside R1's")

    r1 = _Chunks(3, first=r1_first)
    r2 = _Chunks(3, first=r2_started.set)
    errors = []

    def run():
        try:
            _loop(r1, r2)
        except BaseException as e:  # noqa: BLE001 — checked below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert errors == []
    assert r1.given == r2.given == 3
    assert r1.closed and r2.closed
    _assert_parse_threads_stopped()


@pytest.mark.parametrize("fault", ["r1_raises", "r1_longer"])
def test_an_abandoned_loop_stops_both_parse_threads(fault):
    """R1's error, or R1 longer than R2, reaches the caller as it is; both
    parse threads stop and close their iterators, R2's while it parses
    ahead of a loop that will never ask for it."""
    if fault == "r1_raises":
        r2_parsing, r1_raised = threading.Event(), threading.Event()

        def r1_first():
            r2_parsing.wait(5)
            r1_raised.set()
            raise RuntimeError("R1 is unreadable")

        def r2_first():
            r2_parsing.set()
            r1_raised.wait(5)

        r1, r2 = _Chunks(3, first=r1_first), _Chunks(10**6, first=r2_first)
        error, message = RuntimeError, "R1 is unreadable"
    else:
        r1, r2 = _Chunks(3), _Chunks(2)
        error, message = ValueError, "do not have matching lengths"
    with pytest.raises(error, match=message):
        _loop(r1, r2)
    _assert_parse_threads_stopped()
    assert r1.closed and r2.closed
