"""The BAM forensic path over one or several libraries on a torch device.

The port of ``nimble_tpu.pipeline.bam_fast.process_fast``: one reader
thread, ``num_cores - 1`` consumer threads and one gzip logger thread turn a
10x BAM into one gzipped forensic TSV per library, byte-identical to the
JAX package's.  It differs only in where it picks the device dispatcher:
several ``TorchAlignEngine`` instances whose libraries share their trim
settings go through ``models.multi_aligner.TorchMultiLibraryDispatcher``
(one upload, one stacked pass and one fetch per batch for all libraries);
otherwise each engine launches alone.  The JAX package's function decides
this by importing its jax engine, which a machine without jax cannot do.
The batch preparation, the per-library workers and row assembly are that
module's jax-free helpers, reused unchanged.
"""

from __future__ import annotations

import gzip
import os
import queue
import sys
import threading
from typing import Dict, Sequence

from nimble_tpu.config import AlignFilterConfig
from nimble_tpu.io.bam_columnar import ColumnarGroupStream
from nimble_tpu.library import Reference
from nimble_tpu.pipeline.bam_fast import (
    _finish_batch,
    _LibraryWorker,
    _prepare_batch,
)
from nimble_tpu.pipeline.bam_pipeline import log_header, validate_gzip
from nimble_tpu_torch.models.multi_aligner import (
    TorchMultiLibraryDispatcher,
    uniform_trim,
)


def process_fast(
    input_files: Sequence[str],
    engines: Sequence,
    references: Sequence[Reference],
    aligner_configs: Sequence[AlignFilterConfig],
    output_paths: Sequence[str],
    num_cores: int,
    force_bam_paired: bool,
    parity_quirks: bool = True,
    batch_records: int = 16384,
) -> None:
    """``nimble_tpu.pipeline.bam_fast.process_fast`` with the port's
    stacked dispatcher: byte-identical forensic TSVs, one per library.

    Needs engines with ``full_dispatch`` / ``full_collect``
    (:class:`TorchAlignEngine`) and the native host library.  Several
    libraries with the same trim settings share one stacked device pass per
    batch; otherwise each engine launches alone.  The interpreter's thread
    switch interval, which the pipeline lowers while it runs, is restored
    on return.
    """
    interval = sys.getswitchinterval()
    try:
        _process_fast(input_files, engines, references, aligner_configs,
                      output_paths, num_cores, force_bam_paired,
                      parity_quirks, batch_records)
    finally:
        sys.setswitchinterval(interval)


def _process_fast(input_files, engines, references, aligner_configs,
                  output_paths, num_cores, force_bam_paired, parity_quirks,
                  batch_records) -> None:
    workers = [
        _LibraryWorker(e, r, c)
        for e, r, c in zip(engines, references, aligner_configs)
    ]
    # N>1 libraries with uniform trim: one stacked device pass serves all
    multi = None
    if len(engines) > 1 and uniform_trim(aligner_configs):
        try:
            multi = TorchMultiLibraryDispatcher(engines)
        except ValueError:
            multi = None  # incompatible engines: per-engine launches

    # num_cores - 1 consumers, as the reference runs; blocks carry their
    # batch sequence number and the logger writes them in order
    n_consumers = max(1, num_cores - 1)
    log_queue: "queue.Queue" = queue.Queue()
    work_queue: "queue.Queue" = queue.Queue(maxsize=8)  # batches in flight

    def logger() -> None:
        import time as _time

        print("Spawning logging thread.")
        # the parity contract is the decompressed bytes; the level (the
        # JAX package's default 1, NIMBLE_GZIP_LEVEL) only changes the
        # container
        level = int(os.environ.get("NIMBLE_GZIP_LEVEL", "1"))
        files = [
            gzip.open(p, "wb", compresslevel=level) for p in output_paths
        ]
        header = (log_header() + "\n").encode()
        first_write = [True] * len(files)
        buffered: Dict[int, list] = {}
        next_seq = 0
        t_gzip = 0.0
        n_bytes = 0

        def write_blocks(per_lib: list) -> None:
            nonlocal t_gzip, n_bytes
            ts = _time.time()
            for index, block in enumerate(per_lib):
                if not block:
                    continue
                if first_write[index]:
                    print(f"Writing header for file {index}")
                    files[index].write(header)
                    first_write[index] = False
                files[index].write(block)
                n_bytes += len(block)
            t_gzip += _time.time() - ts

        while True:
            msg = log_queue.get()
            if msg is None:
                break
            seq, per_lib = msg
            buffered[seq] = per_lib
            while next_seq in buffered:
                write_blocks(buffered.pop(next_seq))
                next_seq += 1
        if buffered:
            # a sequence gap at shutdown means a consumer died mid-batch:
            # completed later batches must NOT be silently dropped
            for f in files:
                f.close()
            raise RuntimeError(
                f"output truncated at batch {next_seq}: "
                f"{len(buffered)} completed batch(es) follow a failed one"
            )
        ts = _time.time()
        for i, f in enumerate(files):
            f.close()
            print(f"Successfully flushed and closed file {i}")
        t_gzip += _time.time() - ts
        if os.environ.get("NIMBLE_TIMING"):
            print(f"[bam_fast logger] gzip-write {t_gzip:.2f}s "
                  f"({n_bytes/1e6:.1f} MB raw)", file=sys.stderr)
        for p in output_paths:
            print(f"Validating GZIP file: {p}")
            validate_gzip(p)
        print("Logging thread terminating.")

    def producer() -> None:
        import time as _time

        print("Spawning reader thread.")
        stream = ColumnarGroupStream(input_files[0], force_bam_paired)
        prev = None
        total_groups = 0
        t_read = 0.0
        seq = 0
        clean_eof = False
        try:
            it = stream.batches(batch_records)
            while True:
                ts = _time.time()
                b = next(it, None)
                t_read += _time.time() - ts
                if b is None:
                    clean_eof = True
                    break
                total_groups += b.n_groups
                if prev is not None:
                    work_queue.put((seq, prev))
                    seq += 1
                prev = b
            if os.environ.get("NIMBLE_TIMING"):
                print(f"[bam_fast producer] read {t_read:.2f}s",
                      file=sys.stderr)
        finally:
            # final-group quirk: on a clean end of stream the last group of
            # a multi-group BAM is dropped (the stream knows whether an
            # undelivered open group ends the sequence); after a stream
            # error the buffered batch is flushed whole
            if prev is not None:
                if (clean_eof and parity_quirks
                        and stream.final_open_group_pending):
                    prev = prev.drop_last_group()
                if len(prev):
                    work_queue.put((seq, prev))
                    seq += 1
            print("Finished reading UMIs from input file.")

    def consumer(thread_num: int) -> None:
        import time as _time

        from nimble_tpu.utils.metrics import METRICS

        t_prep = t_wait = t_fin = t_get = 0.0
        pending = None  # (seq, ctx, n_records) — dispatched, not packaged
        # NIMBLE_BAM_EAGER=1 finishes the dispatched batch while the queue
        # is empty (off by default, as in the JAX package)
        eager = os.environ.get("NIMBLE_BAM_EAGER", "0") == "1"

        def finish(p) -> None:
            nonlocal t_wait, t_fin
            seq, ctx, n_records = p
            with METRICS.meter("bam_align").measure(n_records):
                if ctx is not None:
                    ts = _time.time()
                    collected = [fut.result() for fut in ctx[1]]
                    t_wait += _time.time() - ts
                else:
                    collected = None
                ts = _time.time()
                per_lib = _finish_batch(ctx, workers, collected)
                t_fin += _time.time() - ts
            log_queue.put(
                (seq, [b"".join(rows) if rows else b"" for rows in per_lib])
            )

        while True:
            ts = _time.time()
            try:
                if not eager:
                    raise queue.Empty
                msg = work_queue.get_nowait()
            except queue.Empty:
                if pending is not None:
                    finish(pending)
                    pending = None
                msg = work_queue.get()
            t_get += _time.time() - ts
            if msg is None:
                work_queue.put(None)  # release sibling consumers
                break
            seq, batch = msg
            # dispatch batch N+1 before packaging batch N: device alignment
            # overlaps the host-side row building
            ts = _time.time()
            ctx = _prepare_batch(batch, workers, multi)
            t_prep += _time.time() - ts
            if pending is not None:
                finish(pending)
            pending = (seq, ctx, len(batch))
        if pending is not None:
            finish(pending)
        if os.environ.get("NIMBLE_TIMING"):
            print(
                f"[bam_fast consumer {thread_num}] prepare {t_prep:.2f}s "
                f"collect-wait {t_wait:.2f}s finish {t_fin:.2f}s "
                f"queue-wait {t_get:.2f}s",
                file=sys.stderr,
            )

    # worker exceptions are captured and re-raised from the main thread —
    # a dying thread must fail the run, not silently truncate the output
    errors: list = []

    def guarded(fn, *fn_args):
        try:
            fn(*fn_args)
        except BaseException as e:  # noqa: BLE001 — re-raised in main
            errors.append(e)

    def consumer_guarded(tn: int) -> None:
        try:
            consumer(tn)
        except BaseException as e:  # noqa: BLE001 — re-raised in main
            errors.append(e)
            # keep the shutdown protocol alive: drain work (unblocking the
            # bounded-queue producer) until the main thread's None sentinel,
            # which is re-put for sibling consumers
            while True:
                msg = work_queue.get()
                if msg is None:
                    work_queue.put(None)
                    break

    import time as _time

    # a short switch interval lets a thread that leaves a GIL-releasing
    # C++ call resume sooner (NIMBLE_GIL_SWITCH seconds; empty: unchanged);
    # process_fast restores the caller's interval
    _sw = os.environ.get("NIMBLE_GIL_SWITCH", "0.001")
    if _sw:
        sys.setswitchinterval(float(_sw))

    _t0 = _time.time()
    _timing = os.environ.get("NIMBLE_TIMING")

    def _mark(label: str) -> None:
        if _timing:
            print(f"[bam_fast wall] {label} @ {_time.time()-_t0:.3f}s",
                  file=sys.stderr)

    log_thread = threading.Thread(target=guarded, args=(logger,))
    log_thread.start()
    producer_thread = threading.Thread(target=guarded, args=(producer,))
    producer_thread.start()

    consumer_threads = []
    for tn in range(n_consumers):
        print(f"Spawning consumer thread {tn}")
        t = threading.Thread(target=consumer_guarded, args=(tn,))
        t.start()
        consumer_threads.append(t)

    producer_thread.join()
    _mark("producer joined")
    print("Joined on producer.")
    work_queue.put(None)
    for t in consumer_threads:
        t.join()
    _mark("consumers joined")
    print("Joined on consumer.")
    log_queue.put(None)
    log_thread.join()
    _mark("logger joined")
    if errors:
        # surface the original exception
        raise errors[0]
    from nimble_tpu.utils.metrics import METRICS

    meter = METRICS.meter("bam_align")
    if meter.items:
        print(meter.summary())
    print("Joined on logging; terminating.")
