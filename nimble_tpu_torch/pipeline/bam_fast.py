"""The BAM forensic path over one or several libraries on a torch device.

Produces gzipped forensic TSVs byte-identical to
:func:`nimble_tpu_torch.pipeline.bam_pipeline.process` (the parity port of
`src/process/bam.rs:45-243`), restructured for throughput:

  * records stream through
    :class:`nimble_tpu_torch.io.bam_columnar.ColumnarGroupStream` (C++ batch
    decode + metadata derivation; no per-record Python objects);
  * alignment runs once per batch of groups per library through the engine's
    columnar full-output interface (`full_dispatch`/`full_collect`) — exact
    f64 gates, vectorized; several ``TorchAlignEngine`` instances whose
    libraries share their trim settings go through
    ``models.multi_aligner.TorchMultiLibraryDispatcher`` (one upload, one
    stacked pass and one fetch per batch for all libraries), otherwise each
    engine launches alone;
  * the per-pair score-map/orientation logic (`src/align.rs:475-729,178-252`)
    runs on byte keys with the orientation pipeline memoized per equivalence-
    class combination;
  * output rows are assembled as bytes and written in blocks by one gzip
    logger thread; one reader thread and ``num_cores - 1`` consumer threads.

Quirk parity (same as the slow pipeline): r1/r2 metadata column swap and
filter-column crossover, dropped final UMI group of multi-group BAMs
(`parity_quirks=True`), duplicate zero-score rows via last-qname-per-callset.

ROW-ORDER CAVEAT: with ``num_cores > 2`` (more than one consumer) this
pipeline emits rows in BATCH-SEQUENCE order, while the slow path (and the
reference, `src/process/bam.rs:59-146`) emits in consumer-completion
order — nondeterministic in the reference itself.  Row SETS are always
identical; single-consumer runs are byte-identical in order too.  The
byte-parity guarantee therefore weakens to set-parity exactly when
multiple consumers are configured.
"""

from __future__ import annotations

import gzip
import sys
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nimble_tpu_torch.config import (
    FILTER_REASONS,
    AlignFilterConfig,
    AlignmentOrientation,
    FilterReason,
)
from nimble_tpu_torch.core.orientation import (
    filter_and_coerce_sequence_call_orientations,
)
from nimble_tpu_torch.core.fast_count import submit_transaction
from nimble_tpu_torch.core.trim import maxinfo_batch
from nimble_tpu_torch import native
from nimble_tpu_torch.io.bam_columnar import ColumnarGroupStream, EmittedBatch
from nimble_tpu_torch.library import Reference
from nimble_tpu_torch.pipeline.bam_pipeline import (
    MAX_UMIS_IN_CHANNEL,
    log_header,
    validate_gzip,
)
from nimble_tpu_torch.models.multi_aligner import (
    TorchMultiLibraryDispatcher,
    uniform_trim,
)
from nimble_tpu_torch.utils.dna import revcomp
from nimble_tpu_torch.utils.metrics import RECORDER, count, span, traced_pass

_REASON_B = [str(r).encode("utf-8") for r in FILTER_REASONS]
_CODE_SKIPPED = FILTER_REASONS.index(
    FilterReason.SKIPPED_ALIGN_DUE_TO_UNPAIRED_DUMMY
)
_CODE_SUCCESS = FILTER_REASONS.index(FilterReason.SUCCESSFUL_MATCH)
_CODE_NOT_MATCHING = FILTER_REASONS.index(FilterReason.NOT_MATCHING_PAIR)
_NONE_B = b"None"
_ZERO_B = b"0"
_NONE_PAIR = (_NONE_B, _ZERO_B)

# the forensic TSVs' gzip level: the parity contract is the decompressed
# bytes, so the level only changes the container; 1 as in the JAX package,
# whose same-process A/B measured it faster end to end than 6, with 0 a tie
_GZIP_LEVEL = 1
# the interpreter's thread switch interval while a pass runs (seconds): a
# short one lets a thread that leaves a GIL-releasing C++ call resume sooner
_GIL_SWITCH_S = 0.001

_DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)

# byte-level revcomp mirroring utils.revcomp (`src/utils.rs:61-94`):
# case-preserving ACGT, U/u -> A/a, N/n -> N, panic on anything else
_RC_TABLE = bytes.maketrans(b"acgtuACGTUnN", b"tgcaaTGCAANN")
_RC_VALID = b"acgtuACGTUnN"


def _revcomp_bytes(b: bytes) -> bytes:
    if b.translate(None, _RC_VALID):
        # invalid character: delegate for the reference's panic message
        revcomp(b.decode("latin-1"))
    return b.translate(_RC_TABLE)[::-1]


def _parse_rev_flags(rev2) -> np.ndarray:
    """parse_str_as_bool over the REVERSE metadata column — a columnar
    (offsets, flat) _Col — (`src/process/bam.rs:417-423`).

    Fast path: values of length 4/5 must be exactly b"true"/b"false" —
    vectorized byte compares validate the whole column; anything else
    falls to the per-value loop for the reference's error message.
    """
    n = len(rev2)
    lens = rev2.lens()
    if n and lens.min() >= 4 and lens.max() <= 5:
        arr = rev2.flat
        starts = rev2.offs[:-1]
        is4 = lens == 4
        ok = np.ones(n, dtype=bool)
        for word, mask in ((b"true", is4), (b"false", ~is4)):
            idx = starts[mask]
            for off, ch in enumerate(word):
                ok[mask] &= arr[idx + off] == ch
        if ok.all():
            return is4
    out = np.empty(n, dtype=bool)
    for i in range(n):
        v = rev2.get(i)
        if v == b"true":
            out[i] = True
        elif v == b"false":
            out[i] = False
        else:
            raise ValueError(
                f'Could not parse revcomp field "{v.decode("latin-1")}" as boolean'
            )
    return out


class _LibraryWorker:
    """Per-library state: interned eq contents, orientation memo, byte memos.

    Equivalence-class CONTENT is interned to small integer ids so the
    per-pair logic compares ints; the orientation pipeline runs once per
    distinct (cid1, cid2) combination for the whole run.
    """

    def __init__(self, engine, reference: Reference, config: AlignFilterConfig):
        self.engine = engine
        self.reference = reference
        self.config = config
        # interning/orient state is shared across consumer threads; the
        # mutating prep sections run under this lock (the C++ row assembly
        # reads only snapshot tables and runs outside it)
        self.lock = threading.RLock()
        self.content_intern: Dict = {}       # rows-bytes / tuple -> cid
        self.content_eq: List[tuple] = []    # cid -> ordered eq tuple
        self.content_sorted: List[tuple] = []  # cid -> sorted eq tuple
        self.orient_memo: Dict[tuple, tuple] = {}
        # interned callsets: csid -> tuple / joined bytes (per-pair loops
        # then hash small ints, not tuples of strings)
        self.callset_intern: Dict[tuple, int] = {}
        self.callsets: List[tuple] = []
        self.callsets_b: List[bytes] = []
        # sorted-content ids: scid[cid1] == scid[cid2] iff the sorted eq
        # tuples are equal (the require_valid_pair test, `src/align.rs:732`)
        self.sorted_intern: Dict[tuple, int] = {}
        self.scid: List[int] = []

    def _intern_sorted(self, sorted_eq: tuple) -> None:
        sid = self.sorted_intern.setdefault(sorted_eq, len(self.sorted_intern))
        self.scid.append(sid)

    # intern_rows/intern_list/orient mutate shared state: they self-lock
    # (re-entrant, so the already-locked prep section pays nothing)

    def intern_rows(self, rows_padded: np.ndarray) -> np.ndarray:
        """Intern each padded-row vector (sorted distinct, device order) to a
        content id; returns (M,) int64 ids."""
        pad = self.engine.EQ_ROW_PAD
        out = np.empty(rows_padded.shape[0], dtype=np.int64)
        intern = self.content_intern
        with self.lock:
            return self._intern_rows_locked(rows_padded, pad, out, intern)

    def _intern_rows_locked(self, rows_padded, pad, out, intern):
        for j in range(rows_padded.shape[0]):
            b = rows_padded[j].tobytes()
            cid = intern.get(b)
            if cid is None:
                eq = tuple(int(x) for x in rows_padded[j] if x != pad)
                cid = len(self.content_eq)
                intern[b] = cid
                self.content_eq.append(eq)
                self.content_sorted.append(eq)  # device rows are sorted
                self._intern_sorted(eq)
            out[j] = cid
        return out

    def intern_list(self, eq: list) -> int:
        """Intern a host-oracle eq list (order preserved)."""
        key = ("h", tuple(eq))
        with self.lock:
            return self._intern_list_locked(key, eq)

    def _intern_list_locked(self, key, eq):
        cid = self.content_intern.get(key)
        if cid is None:
            cid = len(self.content_eq)
            self.content_intern[key] = cid
            self.content_eq.append(tuple(eq))
            srt = tuple(sorted(eq))
            self.content_sorted.append(srt)
            self._intern_sorted(srt)
        return cid

    def orient(self, c1: int, c2: int) -> tuple:
        """Memoized orientation pipeline for one (cid1, cid2) combination.

        Returns ("c", callset_id) or ("t", (reason, orientation)); resolve
        callset ids through :attr:`callsets` / :attr:`callsets_b`.
        """
        memo_key = (c1, c2)
        r = self.orient_memo.get(memo_key)
        if r is not None:
            return r
        with self.lock:
            return self._orient_locked(memo_key, c1, c2)

    def _orient_locked(self, memo_key, c1, c2):
        r = self.orient_memo.get(memo_key)
        if r is None:
            e1 = self.content_eq[c1] if c1 >= 0 else ()
            e2 = self.content_eq[c2] if c2 >= 0 else ()
            call = (
                None,
                (list(e1), 0.0) if e1 else None,
                (list(e2), 0.0) if e2 else None,
                [],
                [],
            )
            tmp: dict = {}
            tkeys: dict = {}
            filter_and_coerce_sequence_call_orientations(
                call, tmp, self.reference, self.config, "", tkeys
            )
            if tmp:
                callset = next(iter(tmp.keys()))
                csid = self.callset_intern.get(callset)
                if csid is None:
                    csid = len(self.callsets)
                    self.callset_intern[callset] = csid
                    self.callsets.append(callset)
                    self.callsets_b.append(",".join(callset).encode("utf-8"))
                r = ("c", csid)
            else:
                r = ("t", tkeys[""])
            self.orient_memo[memo_key] = r
        return r


def _prepare_batch(batch, workers: List[_LibraryWorker], multi=None):
    """Trim + DISPATCH one flat batch (device work is async); returns an
    opaque context for :func:`_finish_batch`, which waits for the collect
    that runs on the fetcher thread meanwhile.  With ``multi`` (a
    MultiLibraryDispatcher), one stacked launch serves every library."""
    n_rec = len(batch)
    if n_rec == 0:
        return None

    # paired interleaving invariant: every group must de-interleave into
    # equal R1/R2 lists; an odd group means a mate went missing and the
    # slow path raises the reference's error (`src/align.rs:540`,
    # bam_pipeline.py:188-193) — never silently floor-pair
    go = np.asarray(batch.group_off, dtype=np.int64)
    if ((go[1:] - go[:-1]) % 2 != 0).any():
        raise ValueError(
            "Error -- read and reverse read files do not have matching "
            "lengths: "
        )

    rev = _parse_rev_flags(batch.rev2)
    lens = batch.seq.lens().astype(np.int32)
    W = max(int(lens.max()), 1)
    # oriented matrix (`src/process/bam.rs:322-326` revcomp correction) +
    # its ASCII decode (score-map key material, `src/align.rs:576-579`;
    # row i spans [i*W, i*W+lens[i])) — one C++ pass when available: the
    # NumPy chain below held the GIL for ~18 ms per 16k batch, serializing
    # against the producer on the 4-core host
    od = native.orient_decode(batch.seq.offs, batch.seq.flat, rev, W)
    if od is not None:
        oriented, dec_flat = od
    else:
        mat = np.zeros((n_rec, W), dtype=np.int8)
        # vectorized padded fill from the flat ragged codes
        valid0 = np.arange(W, dtype=np.int32)[None, :] < lens[:, None]
        mat[valid0] = batch.seq.flat.view(np.int8)
        ar = np.arange(W, dtype=np.int32)[None, :]
        ridx = np.clip(lens[:, None] - 1 - ar, 0, W - 1)
        idx = np.where(rev[:, None], ridx, ar)
        om = np.take_along_axis(mat, idx, axis=1)
        valid = ar < lens[:, None]
        oriented = np.where(
            rev[:, None] & valid, 3 - om, np.where(valid, om, 0)
        )
        dec_flat = _DECODE_LUT[oriented].tobytes()

    skip_mask = batch.skip_true
    active = ~skip_mask

    # ---- per-library: trim + dispatch (async), then collect ----
    states = []
    if multi is not None:
        # ONE stacked launch + ONE fetch serves every library (uniform
        # trim settings -> one packed buffer is valid for all)
        cfg = workers[0].config
        trim_lens = np.minimum(
            maxinfo_batch(
                batch.qual, cfg.trim_target_length, cfg.trim_strictness
            ).astype(np.int32),
            lens,
        )
        # dispatch here, collect on the fetcher thread (see
        # fast_count.submit_transaction)
        shared = submit_transaction(
            _fetcher(), multi.full_dispatch, multi.full_collect,
            (oriented, trim_lens, active), "bam.collect")
        states = [_SliceFuture(shared, li) for li in range(len(workers))]
    else:
        for w in workers:
            cfg = w.config
            trim_lens = maxinfo_batch(
                batch.qual, cfg.trim_target_length, cfg.trim_strictness
            ).astype(np.int32)
            # r1[:trim_len] clamps at the read length (aux-QU quirk can make
            # the quality string longer than the sequence)
            trim_lens = np.minimum(trim_lens, lens)
            states.append(submit_transaction(
                _fetcher(), w.engine.full_dispatch, w.engine.full_collect,
                (oriented, trim_lens, active), "bam.collect"))
    return (batch, states, rev, skip_mask, (dec_flat, W, lens), n_rec)


class _SliceFuture:
    """Per-library view of one shared multi-library collect future."""

    def __init__(self, fut, i: int):
        self._fut, self._i = fut, i

    def result(self):
        return self._fut.result()[self._i]


_FETCHER = None
_FETCHER_LOCK = threading.Lock()


def _fetcher():
    """Single-worker executor serializing device collects (wire transfers).
    Locked lazy init: concurrent first calls from multiple consumers must
    not create two executors, which would defeat the serialization."""
    global _FETCHER
    if _FETCHER is None:
        with _FETCHER_LOCK:
            if _FETCHER is None:
                from concurrent.futures import ThreadPoolExecutor

                _FETCHER = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="bam-fetch")
    return _FETCHER


def _pack_bytes_col(items: List[bytes]):
    off = np.zeros(len(items) + 1, dtype=np.int64)
    if items:
        np.cumsum(np.fromiter((len(b) for b in items), dtype=np.int64,
                              count=len(items)), out=off[1:])
        flat = np.frombuffer(b"".join(items), dtype=np.uint8)
    else:
        flat = np.zeros(0, dtype=np.uint8)
    return off, flat


_REASONS_COL = _pack_bytes_col(_REASON_B)


def _orient_batch(go: np.ndarray, w: _LibraryWorker, cid: np.ndarray,
                  require_pair: bool) -> None:
    """Run the orientation memo over every distinct admitted (content1,
    content2) combination of a batch's pairs (caller holds ``w.lock``), so
    that the batch's rows read only memoized outcomes.  Span
    ``bam.orient`` (``items`` the distinct combos); counter
    ``bam.pairs_oriented_out``: the admitted pairs whose outcome is a
    triage, each pair counted."""
    N = len(w.content_eq)
    starts = go[:-1]
    cnts = (go[1:] - starts) // 2
    total_pairs = int(cnts.sum())
    if not total_pairs:
        return
    # the pairs' first records (vectorized pair index build)
    rep_start = np.repeat(starts, cnts)
    csum = np.cumsum(cnts) - cnts
    inner = np.arange(total_pairs, dtype=np.int64) - np.repeat(csum, cnts)
    i1 = rep_start + 2 * inner
    c1 = cid[i1]
    c2 = cid[i1 + 1]
    admitted = (c1 >= 0) | (c2 >= 0)
    if require_pair:
        scid_arr = np.asarray(w.scid, dtype=np.int64)
        if not len(scid_arr):
            # nothing interned yet (no read aligned); the index-0 pad is
            # never semantically used because c1>=0 gates the comparison
            scid_arr = np.zeros(1, dtype=np.int64)
        g1 = np.where(c1 >= 0, c1, 0)
        g2 = np.where(c2 >= 0, c2, 0)
        admitted &= (
            (c1 >= 0) & (c2 >= 0)
            & ((c1 == c2) | (scid_arr[g1] == scid_arr[g2]))
        )
    keys, per_key = np.unique(((c1 + 1) * (N + 1) + (c2 + 1))[admitted],
                              return_counts=True)
    with span("bam.orient", items=len(keys)):
        triaged = np.fromiter(
            (w.orient(int(k // (N + 1)) - 1, int(k % (N + 1)) - 1)[0] == "t"
             for k in keys), dtype=bool, count=len(keys))
    count("bam.pairs_oriented_out", int(per_key[triaged].sum()))


def _native_rows_args(batch, w: _LibraryWorker, cid, s_arr, code_arr, rev,
                      dec_flat, W, dlens, require_pair):
    """Argument tuple for native.bam_rows (caller holds ``w.lock``).

    Runs the orientation pipeline in Python for every distinct admitted
    (content1, content2) combination (memoized across batches) and builds
    SNAPSHOT tables, so the native call itself can run outside the lock.
    Returns None when the native library is unavailable.
    """
    from nimble_tpu_torch import native

    if not native.available():
        return None
    go = np.ascontiguousarray(batch.group_off, dtype=np.int64)
    n_groups = batch.n_groups
    N = len(w.content_eq)
    _orient_batch(go, w, cid, require_pair)

    # combo tables from the (cross-batch) memo; keys use THIS N
    combo_keys = np.empty(len(w.orient_memo), dtype=np.int64)
    combo_kind = np.empty(len(w.orient_memo), dtype=np.uint8)
    combo_csid = np.empty(len(w.orient_memo), dtype=np.int64)
    tri_items: List[bytes] = []
    for j, ((cc1, cc2), r) in enumerate(w.orient_memo.items()):
        combo_keys[j] = (cc1 + 1) * (N + 1) + (cc2 + 1)
        if r[0] == "c":
            combo_kind[j] = 0
            combo_csid[j] = r[1]
            tri_items.append(b"")
        else:
            combo_kind[j] = 1
            combo_csid[j] = -1
            tri_items.append(
                str(r[1][0]).encode() + b"\t" + str(r[1][1]).encode()
            )

    # global lexicographic ranks of the interned callsets
    order = sorted(range(len(w.callsets)), key=w.callsets.__getitem__)
    cs_rank = np.empty(len(order), dtype=np.int64)
    for rank, idx in enumerate(order):
        cs_rank[idx] = rank

    scid_of = np.asarray(w.scid, dtype=np.int64)
    if not len(scid_of):
        scid_of = np.zeros(1, dtype=np.int64)

    return (
        len(batch), W, dec_flat, dlens.astype(np.int64),
        np.ascontiguousarray(cid, dtype=np.int64), scid_of,
        np.ascontiguousarray(s_arr, dtype=np.int64),
        np.ascontiguousarray(code_arr, dtype=np.int64),
        np.ascontiguousarray(rev, dtype=np.uint8),
        go, n_groups, require_pair,
        _CODE_NOT_MATCHING, N,
        combo_keys, combo_kind, combo_csid, _pack_bytes_col(tri_items),
        cs_rank, _pack_bytes_col(w.callsets_b),
        (batch.qn.offs, batch.qn.flat),
        (batch.seq15.offs, batch.seq15.flat),
        (batch.meta.offs, batch.meta.flat),
        (batch.skipb.offs, batch.skipb.flat),
        _REASONS_COL,
    )


def _finish_batch(ctx, workers: List[_LibraryWorker], collected=None):
    """Collect the dispatched alignment + build the per-library output rows."""
    if ctx is None:
        return [[] for _ in workers]
    batch, states, rev, skip_mask, (dec_flat, W, dlens), n_rec = ctx
    if collected is None:
        collected = [fut.result() for fut in states]
    # slicers are built lazily: when the C++ assembler handles every
    # library, the whole-column copies are never needed
    slicers: List = []

    def _slicers():
        if not slicers:
            slicers.extend((batch.qn.slicer(), batch.seq15.slicer(),
                            batch.meta.slicer(), batch.skipb.slicer()))
        return slicers

    # ---- per-group packaging ----
    out_rows: List[List[bytes]] = [[] for _ in workers]
    go = np.ascontiguousarray(batch.group_off, dtype=np.int64)
    group_bounds = [
        (int(go[gi]), int(go[gi + 1])) for gi in range(batch.n_groups)
    ]

    for li, w in enumerate(workers):
        res = collected[li]
        reason = res["reason"]
        eq_key = res["eq_key"]
        rescued = res["rescued"]
        cfg = w.config
        rows = out_rows[li]
        require_pair = cfg.require_valid_pair

        from nimble_tpu_torch import native

        with w.lock:
            passed = reason == -1
            # vectorized eq-content interning: decode all distinct device
            # combos once, map every read to a content id (-1 = no eq class)
            cid = np.full(n_rec, -1, dtype=np.int64)
            dev_idx = np.flatnonzero(passed & (eq_key >= 0))
            if len(dev_idx):
                u, inv = np.unique(eq_key[dev_idx], return_inverse=True)
                rows_p = w.engine.decode_rows_padded(u)
                cid[dev_idx] = w.intern_rows(rows_p)[inv]
            for i in np.flatnonzero(passed & (eq_key <= -2)):
                cid[i] = w.intern_list(rescued[int(eq_key[i])])

            # per-read forensic reason code + reported score, vectorized
            s_arr = np.where(passed, res["score"], 0).astype(np.int64)
            r16 = reason.astype(np.int64)
            code_arr = np.where(
                skip_mask, _CODE_SKIPPED,
                np.where(passed | (r16 < 0), _CODE_SUCCESS, r16),
            ).astype(np.int64)
            c_sorted = w.content_sorted

            if not native.available():
                _orient_batch(go, w, cid, require_pair)
            native_args = _native_rows_args(
                batch, w, cid, s_arr, code_arr, rev, dec_flat, W, dlens,
                require_pair,
            )
        if native_args is not None:
            # snapshot tables only: runs outside the lock (GIL-releasing)
            native_rows = native.bam_rows(*native_args)
            if native_rows is not None:
                if native_rows:
                    rows.append(native_rows)
                continue
        qn_get, seq15_get, meta_get, skipb_get = _slicers()

        for lo, hi in group_bounds:
            n_pairs = (hi - lo) // 2
            if n_pairs == 0:
                continue
            filter_reasons: Dict[bytes, tuple] = {}
            score_map: Dict[bytes, tuple] = {}

            for p in range(n_pairs):
                i1 = lo + 2 * p
                i2 = i1 + 1
                c1 = cid[i1]
                c2 = cid[i2]
                s1 = int(s_arr[i1])
                s2 = int(s_arr[i2])
                o1 = i1 * W
                o2 = i2 * W
                key = (dec_flat[o1 : o1 + dlens[i1]]
                       + dec_flat[o2 : o2 + dlens[i2]])

                if require_pair and (
                    c1 < 0 or c2 < 0
                    or (c1 != c2 and c_sorted[c1] != c_sorted[c2])
                ):
                    filter_reasons[key] = (
                        (_CODE_NOT_MATCHING, s1), (_CODE_NOT_MATCHING, s2)
                    )
                    continue

                filter_reasons[key] = (
                    (int(code_arr[i1]), s1), (int(code_arr[i2]), s2)
                )
                if c1 >= 0 or c2 >= 0:
                    score_map[key] = (int(c1), int(c2), i1, i2)

            # orientation + results accumulation (`src/align.rs:440-449`)
            results: Dict[int, list] = {}      # callset id -> [count, g1, g2]
            post_triaged: Dict[bytes, tuple] = {}
            for key, (c1, c2, g1, g2) in score_map.items():
                r = w.orient(c1, c2)
                if r[0] == "c":
                    entry = results.setdefault(r[1], [0, 0, 0])
                    entry[0] += 1
                    entry[1] = g1
                    entry[2] = g2
                else:
                    post_triaged[key] = r[1]

            # sort_score_vector (`src/utils.rs:54-59`)
            csets = w.callsets
            s_entries = sorted(results.items(), key=lambda kv: csets[kv[0]])
            if not s_entries:
                # reference: `if s.len() == 0 { continue }` — no zero rows
                # for a library with no scored callsets (`bam.rs:315-330`)
                continue

            scored_qnames = set(qn_get(e[1][1]) for e in s_entries)
            zero_rows = []
            for p in range(n_pairs):
                g1, g2 = lo + 2 * p, lo + 2 * p + 1
                if qn_get(g2) in scored_qnames:
                    continue
                zero_rows.append((None, (0, g1, g2)))

            for csid, entry in list(s_entries) + zero_rows:
                count, g1, g2 = entry[0], entry[1], entry[2]
                feat_b = w.callsets_b[csid] if csid is not None else b""
                # forensic re-key from metadata SEQ/REVERSE
                # (`src/process/bam.rs:355-396`)
                r1k = seq15_get(g1)
                if rev[g1]:
                    r1k = _revcomp_bytes(r1k)
                r2k = seq15_get(g2)
                if rev[g2]:
                    r2k = _revcomp_bytes(r2k)
                v = filter_reasons.get(r1k + r2k)
                if v is not None:
                    v0 = (_REASON_B[v[0][0]], str(v[0][1]).encode())
                    v1 = (_REASON_B[v[1][0]], str(v[1][1]).encode())
                    t = post_triaged.get(r1k + r2k)
                    if t is not None:
                        triage_b = str(t[0]).encode()
                        orient_b = str(t[1]).encode()
                    else:
                        triage_b = _NONE_B
                        orient_b = _NONE_B
                else:
                    v0 = v1 = _NONE_PAIR
                    triage_b = _NONE_B
                    orient_b = _NONE_B
                v2 = v3 = _NONE_PAIR

                m1b = meta_get(g1) + b"\t" + skipb_get(g1)
                m2b = meta_get(g2) + b"\t" + skipb_get(g2)
                # r1/r2 swap quirk (`src/process/bam.rs:103-120`): the "r1"
                # block gets mate metadata, r1 filter columns get the R2
                # filter record
                rows.append(b"\t".join((
                    feat_b,
                    str(count).encode(),
                    m2b,
                    m1b,
                    v1[0], v1[1],
                    v3[0], v3[1],
                    v0[0], v0[1],
                    v2[0], v2[1],
                    triage_b,
                    orient_b,
                )) + b"\n")

    return out_rows


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
    """Drop-in replacement for ``bam_pipeline.process``: byte-identical
    forensic TSVs, one per library.

    Needs engines with ``full_dispatch`` / ``full_collect``
    (:class:`TorchAlignEngine`, ``TorchMeshAlignEngine``) and the native
    host library.  Several
    libraries with the same trim settings share one stacked device pass per
    batch; otherwise each engine launches alone.  The interpreter's thread
    switch interval, which the pipeline lowers while it runs, is restored
    on return.
    """
    interval = sys.getswitchinterval()
    with traced_pass("bam.pass") as whole:
        before = dict(RECORDER.counters)
        try:
            _process_fast(input_files, engines, references, aligner_configs,
                          output_paths, num_cores, force_bam_paired,
                          parity_quirks, batch_records, whole)
        finally:
            sys.setswitchinterval(interval)
        if whole.recorded:
            print(RECORDER.counts_line("bam_fast counts", COUNTERS, before),
                  file=sys.stderr)


# a traced pass's counters, printed as its ``[bam_fast counts]`` line
COUNTERS = ("bam.records_in", "bam.rows_launched", "bam.rescued",
            "bam.rows_written", "bam.rows_stacked", "entropy.fallback_rows",
            "bam.rows_decoded", "bam.records_clipped",
            "bam.pairs_oriented_out")


def _process_fast(input_files, engines, references, aligner_configs,
                  output_paths, num_cores, force_bam_paired, parity_quirks,
                  batch_records, whole) -> None:
    workers = [
        _LibraryWorker(e, r, c)
        for e, r, c in zip(engines, references, aligner_configs)
    ]
    # N>1 libraries with uniform trim: one stacked device pass serves all.
    # Only single-device engines stack here, as in the JAX package: mesh
    # engines (models.mesh_aligner) refuse the dispatcher and launch alone
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
    # each thread renders its NIMBLE_TIMING line from its own spans
    mark = RECORDER.mark()

    def own() -> Dict[str, float]:
        return RECORDER.sums(mark, threading.get_ident())

    def logger() -> None:
        print("Spawning logging thread.")
        files = [
            gzip.open(p, "wb", compresslevel=_GZIP_LEVEL)
            for p in output_paths
        ]
        header = (log_header() + "\n").encode()
        first_write = [True] * len(files)
        buffered: Dict[int, list] = {}
        next_seq = 0
        n_bytes = 0

        def write_blocks(seq: int, per_lib: list) -> None:
            nonlocal n_bytes
            with span("bam.gzip_write", chunk=seq):
                for index, block in enumerate(per_lib):
                    if not block:
                        continue
                    if first_write[index]:
                        print(f"Writing header for file {index}")
                        files[index].write(header)
                        first_write[index] = False
                    files[index].write(block)
                    n_bytes += len(block)
            if RECORDER.on:
                count("bam.rows_written", sum(b.count(b"\n")
                                              for b in per_lib))

        while True:
            msg = log_queue.get()
            if msg is None:
                break
            seq, per_lib = msg
            buffered[seq] = per_lib
            while next_seq in buffered:
                write_blocks(next_seq, buffered.pop(next_seq))
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
        with span("bam.gzip_write"):
            for i, f in enumerate(files):
                f.close()
                print(f"Successfully flushed and closed file {i}")
        if RECORDER.on:
            print(f"[bam_fast logger] gzip-write "
                  f"{own().get('bam.gzip_write', 0.0):.2f}s "
                  f"({n_bytes/1e6:.1f} MB raw)", file=sys.stderr)
        for p in output_paths:
            print(f"Validating GZIP file: {p}")
            with span("bam.validate"):
                validate_gzip(p)
        print("Logging thread terminating.")

    def put(seq: int, batch) -> None:
        # the records of the batch whose SEQ the 10x 124-base rule clipped
        count("bam.records_clipped", int(np.count_nonzero(batch.clipped)))
        work_queue.put((seq, batch))

    def producer() -> None:
        print("Spawning reader thread.")
        with span("bam.open"):  # the file's header, read and inflated
            stream = ColumnarGroupStream(input_files[0], force_bam_paired)
        prev = None
        total_groups = 0
        seq = 0
        clean_eof = False
        try:
            it = stream.batches(batch_records)
            while True:
                # the batch read now is put as sequence number ``seq + 1``
                # (``seq`` for the first)
                with span("bam.read", chunk=seq + (prev is not None),
                          wait=True):
                    b = next(it, None)
                if b is None:
                    clean_eof = True
                    break
                total_groups += b.n_groups
                if prev is not None:
                    put(seq, prev)
                    seq += 1
                prev = b
            if RECORDER.on:
                print(f"[bam_fast producer] read "
                      f"{own().get('bam.read', 0.0):.2f}s", file=sys.stderr)
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
                    put(seq, prev)
                    seq += 1
            print("Finished reading UMIs from input file.")

    def consumer(thread_num: int) -> None:
        while True:
            with span("bam.queue_wait", wait=True) as waited:
                msg = work_queue.get()
                if msg is not None:
                    waited.tag(msg[0])
            if msg is None:
                work_queue.put(None)  # release sibling consumers
                break
            seq, batch = msg
            count("bam.records_in", len(batch))
            with span("bam.prepare", items=len(batch), chunk=seq):
                ctx = _prepare_batch(batch, workers, multi)
            if ctx is not None:
                with span("bam.collect_wait", chunk=seq, wait=True):
                    collected = [fut.result() for fut in ctx[1]]
            else:
                collected = None
            with span("bam.finish", chunk=seq):
                per_lib = _finish_batch(ctx, workers, collected)
            log_queue.put(
                (seq, [b"".join(rows) if rows else b"" for rows in per_lib])
            )
        if RECORDER.on:
            t = own()
            print(
                f"[bam_fast consumer {thread_num}] prepare "
                f"{t.get('bam.prepare', 0.0):.2f}s collect-wait "
                f"{t.get('bam.collect_wait', 0.0):.2f}s finish "
                f"{t.get('bam.finish', 0.0):.2f}s queue-wait "
                f"{t.get('bam.queue_wait', 0.0):.2f}s",
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

    # process_fast restores the caller's interval
    sys.setswitchinterval(_GIL_SWITCH_S)

    def _mark(label: str) -> None:
        if whole.recorded:
            at = (time.perf_counter_ns() - whole.start_ns) / 1e9
            print(f"[bam_fast wall] {label} @ {at:.3f}s", file=sys.stderr)

    log_thread = threading.Thread(target=guarded, args=(logger,),
                                  name="bam-logger")
    log_thread.start()
    producer_thread = threading.Thread(target=guarded, args=(producer,),
                                       name="bam-producer")
    producer_thread.start()

    consumer_threads = []
    for tn in range(n_consumers):
        print(f"Spawning consumer thread {tn}")
        t = threading.Thread(target=consumer_guarded, args=(tn,),
                             name=f"bam-consumer-{tn}")
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
    print("Joined on logging; terminating.")
