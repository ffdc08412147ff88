"""FASTQ counting over one or several libraries in one pass over the input.

The fast branch of ``nimble_tpu.pipeline.fastq_pipeline.process`` with the
port's stacked dispatcher: with more than one :class:`TorchAlignEngine`,
every chunk of the input is parsed once, deduped once, uploaded once and
aligned against all libraries in one device pass per slice
(``models.multi_aligner.TorchMultiLibraryDispatcher``); each library's
``FastCounter`` then takes its slice of the shared result.  Engines that
cannot share a pass (a ``ValueError`` from the dispatcher: other geometry,
walk or device) are launched one by one, still over one parse of the
input.  The chunk loop, dedupe, counting and the TSV writer are the JAX
package's jax-free host code, reused unchanged.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

from nimble_tpu.config import AlignFilterConfig
from nimble_tpu.core.fast_count import FastCounter
from nimble_tpu.io.fastq import iter_fastq_matrix_chunks
from nimble_tpu.io.writers import write_to_tsv
from nimble_tpu.library import Reference
from nimble_tpu.pipeline import fastq_pipeline as shared
from nimble_tpu.utils.metrics import METRICS
from nimble_tpu_torch.models.multi_aligner import TorchMultiLibraryDispatcher

DEFAULT_CHUNK_READS = shared.DEFAULT_CHUNK_READS


def process(
    input_files: Sequence[str],
    engines: Sequence,
    references: Sequence[Reference],
    aligner_configs: Sequence[AlignFilterConfig],
    output_paths: Sequence[str],
    chunk_reads: int = DEFAULT_CHUNK_READS,
) -> None:
    """Count ``input_files`` (R1, and R2 when given) against every library
    (one :class:`TorchAlignEngine` each) and write one ``feature\\tscore``
    TSV per library."""
    multi = fetcher = dispatcher = None
    if len(engines) > 1:
        try:
            multi = TorchMultiLibraryDispatcher(engines)
        except ValueError:
            multi = None  # incompatible engines: per-engine launches
        if multi is not None:
            # one worker each keeps transfer order deterministic
            fetcher = ThreadPoolExecutor(max_workers=1)
            dispatcher = ThreadPoolExecutor(max_workers=1)
    counters = [FastCounter(e, r, c)
                for e, r, c in zip(engines, references, aligner_configs)]
    r1_chunks = iter_fastq_matrix_chunks(input_files[0], chunk_reads)
    r2_chunks = (iter_fastq_matrix_chunks(input_files[1], chunk_reads)
                 if len(input_files) > 1 else None)
    meter = METRICS.meter("fastq_align")
    pending: List = []
    try:
        shared._run_fast_loop(r1_chunks, r2_chunks, counters, multi, fetcher,
                              dispatcher, meter, pending)
    finally:
        for pool in (dispatcher, fetcher):
            if pool is not None:
                pool.shutdown(wait=True)
    print(meter.summary())
    for counter, out in zip(counters, output_paths):
        results = counter.finalize()
        write_to_tsv([(features, entry[0]) for features, entry in results],
                     out)
