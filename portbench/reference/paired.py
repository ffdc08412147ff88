"""The count TSV nimble writes for paired-end FASTQ, worked out from the pairs
alone.

``fastq_pair_tsv`` is the output of ``fastq_pipeline.process([r1, r2],
...)`` for one library, as nimble's reference path computes it
(``src/process/fastq.rs``, ``src/align.rs:475-729``): the distinct pairs,
keyed by the concatenation R1 + R2 as nimble's score map is
(``src/align.rs:574-579``); each mate aligned by
:func:`portbench.reference.align.align`; the mates combined, checked
(``require_valid_pair``), oriented, intersected (``intersect_level``) and
counted by the frozen host calls of :mod:`portbench.reference.host`
(``score_sequences`` through ``get_calls``, then ``sort_score_vector``).
It reads the library JSON file the program reads and takes the pairs the
harness generated, not the files the program parses.

What a distinct pair adds to the counts depends only on its mates' eq
classes (``score_sequences`` decides a pair's state and validity from
them, ``filter_and_coerce_sequence_call_orientations`` its callset), so
the distinct pairs are grouped by the two eq classes, ``get_calls`` runs
once a group on one of its pairs, and the group's callset counts once a
pair of the group.

Departure from nimble: none in the counts.  nimble's score map keeps the
last pair of a key and the port the first; with mates of one fixed length,
as the harness draws them, two pairs of one key are the same pair.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from portbench.reference import align, expected, host


def distinct_pairs(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """The distinct pairs, each R1 then R2 in one row: the pairs' keys, in
    the order of their bytes."""
    both = np.ascontiguousarray(np.concatenate([r1, r2], axis=1))
    keys = both.view(np.dtype((np.void, both.shape[1]))).ravel()
    return both[np.unique(keys, return_index=True)[1]]


def fastq_pair_tsv(library_path: str, strand_filter: str, r1: np.ndarray,
                   r2: np.ndarray, device,
                   overrides: Optional[dict] = None) -> bytes:
    """The count TSV of the pairs (N, L1) and (N, L2) int8, R1 and R2 in
    file order.  ``overrides`` changes fields of the library's filter
    configuration, as in :func:`portbench.reference.expected.load`."""
    cfg, ref = expected.load(library_path, strand_filter, overrides)
    uniq = distinct_pairs(r1, r2)
    mates1, mates2 = list(uniq[:, : r1.shape[1]]), list(uniq[:, r1.shape[1]:])
    index = expected.index_of(ref, device)
    res1, res2 = align.align(index, mates1, cfg), align.align(index, mates2,
                                                            cfg)
    groups: Dict[tuple, List[int]] = {}
    for i, (a1, a2) in enumerate(zip(res1, res2)):
        key = (tuple(a1[0][0]) if a1[0] else (),
               tuple(a2[0][0]) if a2[0] else ())
        groups.setdefault(key, []).append(i)
    counts: Dict[tuple, int] = {}
    for members in groups.values():
        i = members[0]
        engine = host.PrecomputedEngine([res1[i]], [res2[i]])
        results, _read_matches, _reasons = host.get_calls(
            [mates1[i]], [mates2[i]], [], engine, ref, cfg)
        for features, _entry in results:
            key = tuple(features)
            counts[key] = counts.get(key, 0) + len(members)
    rows = host.sort_score_vector([(list(f), n) for f, n in counts.items()])
    return ("feature\tscore\n" + "".join(
        "\t".join(f) + f"\t{n}\n" for f, n in rows)).encode("utf-8")
