"""FASTQ counting over one or several libraries in one pass over the input.

Parity target: `src/process/fastq.rs:7-30` — for each reference library,
align the input file(s) (second file supplies mates) and append a
``feature\tscore`` TSV per library.  With :class:`TorchAlignEngine`
engines the fast branch streams chunks, each input file parsed ahead on a
thread of its own (``fastq-parse``, and ``fastq-parse-r2`` for the mates'
file), a pair's R1 and R2 rows sent to the card in one stacked launch.
With more than one engine, every chunk of the input is parsed once,
deduped once, uploaded once and aligned against all libraries in one
device pass per slice
(``models.multi_aligner.TorchMultiLibraryDispatcher``); each library's
``FastCounter`` then takes its slice of the shared result.  Engines that
cannot share a pass (a ``ValueError`` from the dispatcher: other geometry,
walk or device) are launched one by one, still over one parse of the
input.  Several mesh engines on one mesh (``models.mesh_aligner``) share
the mesh's data-parallel stacked pass (``mesh_aligner.stacked_dispatcher``)
and their counters decode through single-device engines of the same
libraries, as in the JAX package.  Other engines
(``core.calls.HostAlignEngine``, the NumPy oracle) take the reference's
per-library ``call`` path.
"""

from __future__ import annotations

import itertools
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

from nimble_tpu_torch.config import AlignFilterConfig
from nimble_tpu_torch.core.calls import AlignEngine, call
from nimble_tpu_torch.core.fast_count import (
    FastCounter, split_stacked, stack_pair, submit_transaction)
from nimble_tpu_torch.io.fastq import iter_fastq_matrix_chunks, read_fastq_codes
from nimble_tpu_torch.io.writers import write_to_tsv
from nimble_tpu_torch.library import Reference
from nimble_tpu_torch.models.mesh_aligner import (
    TorchMeshAlignEngine,
    stacked_dispatcher,
)
from nimble_tpu_torch.models.multi_aligner import TorchMultiLibraryDispatcher
from nimble_tpu_torch.utils.metrics import RECORDER, count, span, traced_pass

# streaming chunk size for the fast path (reads per device batch)
DEFAULT_CHUNK_READS = 1 << 17
# chunks in flight before the oldest drains: chunk N's host counting
# overlaps chunks N+1 and N+2's upload and device work (the JAX package's
# A/B measured 3 best; 1 left the device idle during every count)
_DEPTH = 3
# a traced pass's counters, printed as its ``[fastq counts]`` line
# (``fastq.reads_in`` counts the reads of both files on paired input; the
# ``fastq.pairs_*`` counters and ``fastq.mate_ready``, the chunks whose R2
# chunk had been parsed when R1's came, stay 0 on single-end input)
COUNTERS = ("fastq.reads_in", "fastq.rows_launched", "fastq.rescued",
            "fastq.bytes_in", "fastq.parse.buffer_grows",
            "fastq.rows_stacked", "entropy.fallback_rows", "fastq.pairs_in",
            "fastq.pairs_both", "fastq.pairs_one_mate", "fastq.pairs_invalid",
            "fastq.mate_ready")
# the end of a prefetcher's iterator
_END = object()

def _drain_pending(pending, multi, chunk=None) -> None:
    """Process buffered chunk handles; with the multi-library dispatcher the
    shared launch is collected ONCE and each counter gets its library's
    slice.  The call is the span ``fastq.drain`` of ``chunk``."""
    with span("fastq.drain", chunk=chunk, wait=True):
        _drain(pending, multi)


def _drain(pending, multi) -> None:
    if multi is None:
        for counter, handle in pending:
            counter.process(handle)
        return
    if not pending:
        return
    handle = pending[0][1]
    if not isinstance(handle, tuple):
        handle = handle.result()  # pipelined dispatch future
    mat, lens, mate_mat, mate_lens, st1, prededuped = handle
    if not mat.shape[0]:
        return
    raws1 = st1.result() if hasattr(st1, "result") else multi.collect(st1)
    if mate_mat is None:
        raws2 = [None] * len(pending)
    else:
        # stacked R1+R2 launch: each library's raw splits by row
        split = [split_stacked(raw, mat.shape[0]) for raw in raws1]
        raws1, raws2 = [a for a, _ in split], [b for _, b in split]
    for (counter, _), raw1, raw2 in zip(pending, raws1, raws2):
        counter._add_with_raw(mat, lens, mate_mat, mate_lens, raw1, raw2,
                              prededuped=prededuped)


def process(
    input_files: Sequence[str],
    engines: Sequence[AlignEngine],
    references: Sequence[Reference],
    aligner_configs: Sequence[AlignFilterConfig],
    output_paths: Sequence[str],
    chunk_reads: int = DEFAULT_CHUNK_READS,
) -> None:
    """Count ``input_files`` (R1, and R2 when given) against every library
    (one engine each) and write one ``feature\tscore`` TSV per library.

    With ``NIMBLE_TIMING`` set the pass is traced (``utils.metrics``) and
    prints its ``[fastq loop]`` and ``[fastq counts]`` lines to stderr."""
    with traced_pass("fastq.pass") as whole:
        before = dict(RECORDER.counters)
        _process(input_files, engines, references, aligner_configs,
                 output_paths, chunk_reads)
        if whole.recorded:
            print(RECORDER.counts_line("fastq counts", COUNTERS, before),
                  file=sys.stderr)


def _process(input_files, engines, references, aligner_configs, output_paths,
             chunk_reads) -> None:
    if not all(hasattr(e, "align_raw_compact_from_matrix") for e in engines):
        reads = read_fastq_codes(input_files[0])
        mates: Optional[List] = (
            read_fastq_codes(input_files[1]) if len(input_files) > 1 else None
        )
        for i, engine in enumerate(engines):
            results, _alignment_metadata, _ = call(
                reads, mates, [], engine, references[i], aligner_configs[i]
            )
            write_to_tsv(
                [(features, entry[0]) for features, entry in results],
                output_paths[i],
            )
        return

    multi = fetcher = dispatcher = None
    count_engines = list(engines)
    if len(engines) > 1:
        try:
            if all(isinstance(e, TorchMeshAlignEngine) for e in engines):
                multi = stacked_dispatcher(engines)
                count_engines = multi.engines
            else:
                multi = TorchMultiLibraryDispatcher(engines)
        except ValueError:
            multi = None  # incompatible engines: per-engine launches
            count_engines = list(engines)
        if multi is not None:
            # one worker each keeps transfer order deterministic
            fetcher = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="fastq-fetch")
            dispatcher = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fastq-dispatch")
    counters = [FastCounter(e, r, c)
                for e, r, c in zip(count_engines, references, aligner_configs)]
    r1_chunks = iter_fastq_matrix_chunks(input_files[0], chunk_reads)
    r2_chunks = (iter_fastq_matrix_chunks(input_files[1], chunk_reads)
                 if len(input_files) > 1 else None)
    pending: List = []
    try:
        _run_fast_loop(r1_chunks, r2_chunks, counters, multi, fetcher,
                       dispatcher, pending)
    finally:
        for pool in (dispatcher, fetcher):
            if pool is not None:
                pool.shutdown(wait=True)
    with span("fastq.finalize"):
        for counter, out in zip(counters, output_paths):
            results = counter.finalize()
            write_to_tsv([(features, entry[0])
                          for features, entry in results], out)


def _dispatch_multi(multi, fetcher, mat, lens, mate_mat, mate_lens,
                    chunk=None):
    """Dedupe + launch one chunk through the multi-library dispatcher
    (the single-library FastCounter.dispatch disciplines, applied once for
    all libraries)."""
    with span("fastq.dispatch", items=mat.shape[0], chunk=chunk):
        mat, lens, mate_mat, mate_lens, prededuped = (
            multi.dedupe(mat, lens, mate_mat, mate_lens)
        )
        if mat.shape[0]:
            # one device transaction for all libraries (stacked R1+R2 when
            # paired, split back in drain): dispatched here, collected on
            # the fetcher
            if mate_mat is not None:
                with span("fastq.stack_pair", items=2 * mat.shape[0]):
                    launch_args = stack_pair(mat, lens, mate_mat, mate_lens)
            else:
                launch_args = (mat, lens)
            st1 = submit_transaction(
                fetcher, multi.dispatch, multi.collect, launch_args,
                "fastq.collect")
        else:
            st1 = None
    return (mat, lens, mate_mat, mate_lens, st1, prededuped)


class _Prefetcher:
    """Run an iterator up to ``depth`` items ahead on its own thread,
    ``name``, started here, when the pass starts.

    The FASTQ chunk parse (one read, then the C++ scan and matrix fill,
    both GIL-releasing) would otherwise serialize with the count stage on
    the main thread.  A single ordered worker per input file hides it
    behind the device stage: ``fastq-parse`` for R1, ``fastq-parse-r2``
    for R2.  Both start before the loop first asks for a chunk, so the
    two files' first chunks parse side by side.  Exceptions re-raise at
    the same consume point.  Each item's parse is the span
    ``fastq.parse`` on either thread, its chunk the item's index.
    :meth:`close` stops the worker and closes ``it``.
    """

    def __init__(self, it, name: str, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._work, args=(it,),
                                        name=name, daemon=True)
        self._thread.start()

    def _work(self, it) -> None:
        try:
            for chunk in itertools.count():
                if self._stop.is_set():
                    return
                with span("fastq.parse", chunk=chunk):
                    item = next(it, _END)
                if item is _END:
                    break
                self._queue.put(("ok", item))
        except BaseException as e:  # noqa: BLE001 — replayed at consume
            self._queue.put(("exc", e))
            return
        finally:
            # on this thread: a generator cannot be closed while it runs
            close = getattr(it, "close", None)
            if close is not None:
                close()
        self._queue.put(("end", None))

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        kind, val = self._queue.get()
        if kind == "ok":
            return val
        self._done = True
        if kind == "exc":
            raise val
        raise StopIteration

    def ready(self) -> bool:
        """Whether the next item (or the end) is already in the queue."""
        return not self._queue.empty()

    def close(self) -> None:
        """Stop the worker and wait for it to close the iterator.

        Abandoned mid-stream (consumer exception, mismatched R1/R2 raise),
        the worker may be blocked in ``put()``: drain the queue so it wakes,
        observes ``stop`` and exits — otherwise the thread and its open
        FASTQ handle leak for the process lifetime (ADVICE r4)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                self._thread.join(0.05)


def _run_fast_loop(r1_chunks, r2_chunks, counters, multi, fetcher,
                   dispatcher, pending) -> None:
    mark = RECORDER.mark()
    in_flight: List = []
    # both parse threads start here, before the first chunk is asked for
    r1_chunks = _Prefetcher(r1_chunks, "fastq-parse")
    if r2_chunks is not None:
        r2_chunks = _Prefetcher(r2_chunks, "fastq-parse-r2")
    try:
        for chunk in itertools.count():
            with span("fastq.parse_wait", chunk=chunk, wait=True):
                nxt = next(r1_chunks, None)
                if nxt is not None and r2_chunks is not None:
                    count("fastq.mate_ready", r2_chunks.ready())
                    # the wait for R2's chunk once R1's has come
                    with span("fastq.parse_wait.mate", wait=True):
                        try:
                            mate_mat, mate_lens = next(r2_chunks)
                        except StopIteration:
                            mate_mat, mate_lens = None, None
            if nxt is None:
                break
            mat, lens = nxt
            if r2_chunks is not None:
                if mate_mat is None or mate_mat.shape[0] < mat.shape[0]:
                    raise ValueError(
                        "Error -- read and reverse read files do not have "
                        "matching lengths: "
                    )
                count("fastq.pairs_in", mat.shape[0])
                count("fastq.reads_in", 2 * mat.shape[0])
            else:
                mate_mat, mate_lens = None, None
                count("fastq.reads_in", mat.shape[0])
            if multi is not None:
                # pipelined dispatch: dedupe + pack + upload run on the
                # dispatcher thread, overlapping the previous chunk's
                # host-side counting (see FastCounter.dispatch_async)
                with span("fastq.submit", items=mat.shape[0], chunk=chunk):
                    fut = dispatcher.submit(
                        _dispatch_multi, multi, fetcher,
                        mat, lens, mate_mat, mate_lens, chunk,
                    )
                handles = [fut] * len(counters)
            else:
                handles = [
                    counter.dispatch_async(mat, lens, mate_mat, mate_lens,
                                           chunk=chunk)
                    for counter in counters
                ]
            in_flight.append((chunk, list(zip(counters, handles))))
            if len(in_flight) >= _DEPTH:
                drained, batch = in_flight.pop(0)
                _drain_pending(batch, multi, chunk=drained)
    finally:
        r1_chunks.close()
        if r2_chunks is not None:
            r2_chunks.close()
    while in_flight:
        drained, batch = in_flight.pop(0)
        _drain_pending(batch, multi, chunk=drained)
    if RECORDER.on:
        t = RECORDER.sums(mark, threading.get_ident())
        print(f"[fastq loop] parse-wait {t.get('fastq.parse_wait', 0.0):.3f}s"
              f" submit {t.get('fastq.submit', 0.0):.3f}s drain "
              f"{t.get('fastq.drain', 0.0):.3f}s", file=sys.stderr)
