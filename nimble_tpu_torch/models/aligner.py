"""TorchAlignEngine: the compact and full engine interfaces on a torch device.

Counterpart of ``nimble_tpu.models.aligner.DeviceAlignEngine``'s two
columnar interfaces, which the host pipelines drive by duck typing:

- compact (``core.fast_count.FastCounter``, ``pipeline.fastq_pipeline``):
  ``compact_dispatch`` / ``compact_collect`` /
  ``align_raw_compact_from_matrix`` plus the combo decoders.  Reads are
  grouped by length bucket, packed 2-bit on the host, uploaded once per
  bucket and run through ``ops.compact.probe_walk_filter`` in
  ``launch_batch``-read launches.  At collect, the host applies the exact
  f64 entropy gate; reads the device cannot bound (postings overflow,
  fingerprint collision, longer than the largest bucket) come back flagged
  ``needs_host`` for the exact host rescue.
- full (``pipeline.bam_fast.process_fast``, the BAM forensic path):
  ``full_dispatch`` / ``full_collect``.  Each bucket's packed rows are
  deduped (:func:`dedupe_packed_rows`) before the upload and run through
  ``ops.full.probe_walk_full``; collect applies every gate exactly on the
  host, rescues what the device cannot bound, and scatters the results back
  over the duplicates.
- ``align_batch`` (the ``AlignEngine`` interface of ``core.calls`` and
  ``pipeline.bam_pipeline``): per-read results over the same full pass, in
  the host order of ``DeviceAlignEngine._run_bucket``.

The host side of all three lives in :class:`BucketedEngine`, which the mesh
engine (``models.mesh_aligner``) shares.

``process_fast`` calls dispatch and collect from several host threads, and
``bam_pipeline``'s consumers call ``align_batch`` from several threads: the
kernel wrappers launch on the calling thread's current stream and count
launches under a lock, and a collect first waits for the stream that its
dispatch launched on.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from nimble_tpu_torch.config import (
    FILTER_REASON_CODE,
    MIN_ENTROPY_SCORE,
    MIN_READ_LENGTH,
    AlignFilterConfig,
    FilterReason,
)
from nimble_tpu_torch.core.fast_count import _group_rows_exact
from nimble_tpu_torch.core.filters import (
    filter_alignment_by_metrics,
    pseudoalign,
)
from nimble_tpu_torch.index.build import KmerIndex
from nimble_tpu_torch.ops.device_index import build_bucketed_index
from nimble_tpu_torch.ops.compact import (
    WALKS,
    check_c_max,
    probe_walk_filter,
    unpack_compact,
)
from nimble_tpu_torch.ops.device_tables import (
    FilterScalars,
    s_min_table,
    tables_from_bucketed_index,
)
from nimble_tpu_torch.ops.full import probe_walk_full, unpack_full_packed
from nimble_tpu_torch.utils.metrics import count, setup_span, span

# read-length buckets: one launch shape per bucket (the JAX engine's set)
DEFAULT_BUCKETS = (64, 92, 96, 128, 160, 192, 256, 384, 512, 768, 1024)

# per-byte code counts of 2-bit packed reads: _PACKED_COUNT_LUT[byte] =
# (#code0, #code1, #code2, #code3) among the byte's 4 bases
_PACKED_COUNT_LUT = np.zeros((256, 4), dtype=np.uint8)
for _b in range(256):
    for _s in (0, 2, 4, 6):
        _PACKED_COUNT_LUT[_b, (_b >> _s) & 3] += 1


def entropy_pass_packed(buf: np.ndarray, m: int, lens: np.ndarray,
                        nb: int) -> np.ndarray:
    """Exact-f64 Shannon-entropy gate from a packed read buffer.

    Counts bases in one C++ pass when the native library is built, else
    through the byte LUT (the rows it counts are the counter
    ``entropy.fallback_rows``); zero padding packs as code 0 and is
    subtracted.  Then evaluates the reference's expression in its f64
    operation order (A, T, C, G frequency terms summed, negated).
    """
    from nimble_tpu_torch import native

    counts = native.packed_base_counts(buf, m, nb)
    if counts is None:
        count("entropy.fallback_rows", m)
        counts = (
            _PACKED_COUNT_LUT[buf[:m, :nb].reshape(-1)]
            .reshape(m, nb, 4)
            .sum(axis=1, dtype=np.int64)
        )
    lens = lens[:m].astype(np.int64)
    counts[:, 0] -= nb * 4 - lens
    tot = lens.astype(np.float64)
    tot_safe = np.where(tot == 0, 1.0, tot)
    ent = np.zeros(m, dtype=np.float64)
    for code in (0, 3, 1, 2):  # A, T, C, G
        f = counts[:, code] / tot_safe
        with np.errstate(divide="ignore", invalid="ignore"):
            term = np.where(f > 0.0, f * np.log2(np.where(f > 0.0, f, 1.0)), 0.0)
        ent += term
    return -ent >= MIN_ENTROPY_SCORE


def pack_reads(mat: np.ndarray, lens: np.ndarray, bucket: int) -> np.ndarray:
    """(m, width) int8 codes + lens -> (m, ceil(bucket/4) + 2) uint8 rows:
    base j at bits 2*(j%4) of byte j//4, then the uint16 length.  The C++
    packer when the native library is built, else NumPy."""
    from nimble_tpu_torch import native

    m, width = mat.shape
    out = native.pack_reads(mat, lens, bucket, m)
    if out is not None:
        return out
    nb = (bucket + 3) // 4
    buf = np.zeros((m, nb + 2), dtype=np.uint8)
    src = np.zeros((m, nb * 4), dtype=np.uint8)
    take = min(width, bucket)
    src[:, :take] = mat[:, :take].astype(np.uint8) & 3
    q = src.reshape(m, nb, 4)
    buf[:, :nb] = q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4) | (
        q[:, :, 3] << 6)
    buf[:, nb] = (lens & 0xFF).astype(np.uint8)
    buf[:, nb + 1] = (lens >> 8).astype(np.uint8)
    return buf


def dedupe_packed_rows(buf_all: np.ndarray):
    """Group identical packed read rows; returns (first, inv).

    ``buf_all[first]`` are the distinct rows and ``buf_all[first][inv] ==
    buf_all`` row for row: the full result is a pure function of the packed
    row (trim-zeroed codes + length bytes), so duplicates upload and align
    once.  The grouping is ``core.fast_count._group_rows_exact`` over the
    rows viewed as int64 words, as ``nimble_tpu.models.aligner`` does, so
    ``first`` and ``inv`` are the JAX engine's.
    """
    m, w = buf_all.shape
    pad_w = (w + 7) & ~7
    if pad_w != w:
        padded = np.zeros((m, pad_w), dtype=np.uint8)
        padded[:, :w] = buf_all
    else:
        padded = np.ascontiguousarray(buf_all)
    gid, reps = _group_rows_exact(padded.view(np.int64).reshape(m, pad_w // 8))
    return reps, gid


class BucketedDispatch:
    """Dispatch of a chunk in read-length buckets, shared by
    :class:`TorchAlignEngine` and the stacked multi-library dispatcher.

    A subclass sets ``device``, ``buckets`` and ``launch_batch`` and
    provides ``_device_pass(bucket, full)``: the device pass of one launch
    (compact, or with ``full`` the full-output pass).  Dispatch records the
    calling thread's CUDA stream and collect waits on it.
    """

    def _launch(self, buf: np.ndarray, bucket: int, *,
                full: bool = False) -> torch.Tensor:
        """Upload one bucket's packed rows and run the device pass in
        launch_batch slices; returns the (..., m, 2) (or with ``full``,
        (..., m, 3)) int32 device result."""
        dev_in = torch.from_numpy(buf).to(self.device)
        run = self._device_pass(bucket, full)
        outs = [run(dev_in[i : i + self.launch_batch])
                for i in range(0, dev_in.shape[0], self.launch_batch)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)

    def _stream(self):
        """The dispatching thread's CUDA stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    @staticmethod
    def _wait(state) -> None:
        """Wait for a dispatch's launches: collect may run on another host
        thread, whose current stream need not be the dispatching one."""
        if state["stream"] is not None:
            state["stream"].synchronize()

    def compact_dispatch(self, mat: np.ndarray, lens: np.ndarray):
        """Pack, upload and launch one chunk; returns an opaque state for
        :meth:`compact_collect`.  Device work is queued asynchronously.

        PRECONDITION: ``mat`` is zero beyond each row's length (the packed
        entropy gate counts padding as code 0 and subtracts it).
        """
        n = mat.shape[0]
        lens = np.asarray(lens, dtype=np.int32)
        needs_host = lens > self.buckets[-1]
        eligible = (lens >= MIN_READ_LENGTH) & ~needs_host
        count("fastq.rows_launched", np.count_nonzero(eligible))
        launches = []
        if eligible.any():
            bucket_arr = np.asarray(self.buckets)
            bucket_idx = np.searchsorted(bucket_arr, lens)
            present = np.unique(bucket_idx[eligible])
            for bi in present:
                bucket = int(bucket_arr[bi])
                if len(present) == 1 and eligible.all():
                    sel, bmat, blens = None, mat, lens
                else:
                    sel = np.flatnonzero(eligible & (bucket_idx == bi))
                    bmat, blens = mat[sel], lens[sel]
                buf = pack_reads(bmat, blens, bucket)
                launches.append(
                    (bucket, sel, len(blens), self._launch(buf, bucket), buf,
                     blens))
        return {"n": n, "needs_host": needs_host, "launches": launches,
                "stream": self._stream()}

    def full_dispatch(self, mat: np.ndarray, lens: np.ndarray,
                      active: np.ndarray):
        """Pack, dedupe, upload and launch one batch of the BAM path;
        returns an opaque state for :meth:`full_collect`.

        ``active`` marks the reads to align (False: skipped records, which
        get no result).  ``mat`` may hold codes past each (trimmed) length:
        they are zeroed before packing, as the packed entropy gate needs.
        Reads longer than the largest bucket go to host rescue at collect.
        """
        n = mat.shape[0]
        lens = np.asarray(lens, dtype=np.int32)
        act = np.asarray(active, dtype=bool)
        host_rescue = act & (lens > self.buckets[-1])
        eligible = act & (lens >= MIN_READ_LENGTH) & ~host_rescue
        launches = []
        if eligible.any():
            mat_z = np.where(
                np.arange(mat.shape[1], dtype=np.int32)[None, :]
                < lens[:, None], mat, 0).astype(np.int8, copy=False)
            bucket_arr = np.asarray(self.buckets)
            bucket_idx = np.searchsorted(bucket_arr, lens)
            for bi in np.unique(bucket_idx[eligible]):
                bucket = int(bucket_arr[bi])
                sel = np.flatnonzero(eligible & (bucket_idx == bi))
                buf_all = pack_reads(mat_z[sel], lens[sel], bucket)
                first, inv = dedupe_packed_rows(buf_all)
                count("bam.rows_launched", len(first))
                buf = buf_all[first]
                launches.append((sel, len(first),
                                 self._launch(buf, bucket, full=True), buf,
                                 bucket, inv))
        return {"n": n, "mat": mat, "lens": lens, "active": act,
                "host_rescue": host_rescue, "launches": launches,
                "stream": self._stream()}

    def fetch_full(self, state) -> list:
        """Wait for a :meth:`full_dispatch` and do each launch's host work
        that no library changes, once: the fetch, the distinct rows'
        lengths (kept in the packed rows) and the entropy gate (span
        ``bam.collect.entropy``).  Returns ``(sel, m, raw, inv, sub_lens,
        low_ent)`` a launch, ``raw`` the (..., m, 3) result."""
        self._wait(state)
        fetched = []
        for sel, m, out_dev, buf, bucket, inv in state["launches"]:
            raw = out_dev.cpu().numpy()
            nb = (bucket + 3) // 4
            # distinct-row lengths live in the packed rows themselves
            sub_lens = (buf[:, nb].astype(np.int32)
                        | (buf[:, nb + 1].astype(np.int32) << 8))
            with span("bam.collect.entropy", items=m):
                low_ent = ~entropy_pass_packed(buf, m, sub_lens, nb)
            fetched.append((sel, m, raw, inv, sub_lens, low_ent))
        return fetched


class BucketedEngine(BucketedDispatch):
    """The host side of an engine over a bucketed device pass: the exact
    host gates of the compact and full interfaces, ``align_batch`` and the
    combo decoders, shared by :class:`TorchAlignEngine` and the mesh engine
    (``models.mesh_aligner.TorchMeshAlignEngine``).

    A subclass sets ``index``, ``config``, ``c_max`` and ``bidx`` (whose
    ``postings_row`` the device results' ``astart`` indexes) besides what
    :class:`BucketedDispatch` needs.
    """

    EQ_ROW_PAD = np.int64(2**62)

    def compact_collect(self, state, defer_unresolved: bool = False):
        """Fetch the results and assemble the flat result dict (see
        :meth:`align_raw_compact_from_matrix`).  ``defer_unresolved`` is
        accepted for interface compatibility; every read resolves in its
        first launch."""
        n = state["n"]
        self._wait(state)
        astart = np.zeros(n, dtype=np.int64)
        mask = np.zeros(n, dtype=np.int32)
        passed = np.zeros(n, dtype=bool)
        needs_host = state["needs_host"]
        for bucket, sel, m, out_dev, buf, blens in state["launches"]:
            out = unpack_compact(out_dev.cpu().numpy())
            with span("fastq.collect.entropy", items=m):
                ent_ok = entropy_pass_packed(buf, m, blens, (bucket + 3) // 4)
            rows = slice(None) if sel is None else sel
            astart[rows] = out["astart"]
            mask[rows] = out["mask"]
            passed[rows] = out["passed"] & ent_ok
            needs_host[rows] = out["needs_host"] & ent_ok
        result = {"astart": astart, "mask": mask, "passed": passed,
                  "needs_host": needs_host}
        if defer_unresolved:
            result["unresolved"] = np.zeros(n, dtype=bool)
        return result

    def align_raw_compact_from_matrix(self, mat: np.ndarray, lens: np.ndarray):
        """Whole filter chain on device for an (N, W) code matrix.

        Returns dict arrays over N reads: astart (N,) int64 (the anchor's
        postings start), mask (N,) int32 (live candidate lanes), passed (N,)
        bool, needs_host (N,) bool.
        """
        return self.compact_collect(self.compact_dispatch(mat, lens))

    # --- full-output interface (BAM forensic path) -------------------------

    def full_collect(self, state):
        """Fetch the results and apply the exact host gates.

        Returns dict arrays over the N reads: ``reason`` int16 (index into
        ``FILTER_REASONS`` for a filtered read, -1 passed, -2 inactive),
        ``norm`` f64 and ``score`` int32 (the reported scores), ``eq_key``
        int64 (>= 0 a device combo ``astart << c_max | mask``, <= -2 a key
        of ``rescued``, -1 no eq class) and ``rescued`` (id -> eq list).
        The gates run in ``pseudoalign``'s order; rescue ids go to the
        host-rescue rows first, then to each launch's overflow rows, as in
        ``DeviceAlignEngine.full_collect``.
        """
        return self.full_collect_library(state, self.fetch_full(state))

    def full_collect_library(self, state, fetched):
        """:meth:`full_collect` over the launches :meth:`fetch_full`
        fetched, each ``raw`` this library's (m, 3) result: what a stacked
        pass runs once a library."""
        n = state["n"]
        mat, lens, act = state["mat"], state["lens"], state["active"]
        reason = np.full(n, -2, dtype=np.int16)
        norm = np.zeros(n, dtype=np.float64)
        score = np.zeros(n, dtype=np.int32)
        eq_key = np.full(n, -1, dtype=np.int64)
        rescued: dict = {}
        cfg = self.config
        code = FILTER_REASON_CODE

        reason[act & (lens < MIN_READ_LENGTH)] = code[FilterReason.SHORT_READ]
        next_rescue = -2

        def host_align(i):
            nonlocal next_rescue
            alignment, filt = pseudoalign(mat[i, : lens[i]], self.index, cfg,
                                          MIN_READ_LENGTH)
            if alignment is not None:
                eq, nrm, sc = alignment
                rescued[next_rescue] = list(eq)
                eq_key[i] = next_rescue
                next_rescue -= 1
                reason[i] = -1
                norm[i] = nrm
                score[i] = sc
            else:
                reason[i] = code[filt[0]]
                norm[i] = filt[1]
                score[i] = filt[2]

        rescue = np.flatnonzero(state["host_rescue"])
        count("bam.rescued", len(rescue))
        for i in rescue:
            host_align(i)

        for sel, m, raw, inv, sub_lens, low_ent in fetched:
            out = unpack_full_packed(raw)
            ha = out["has_anchor"]
            ov = out["overflow"] & ~low_ent
            sc = out["score"]
            mm = out["mismatches"]
            nrm = sc / sub_lens  # f64, the reference's normalized score
            keys = (out["astart"] << self.c_max) | out["mask"]

            r = np.full(m, -1, dtype=np.int16)
            nr = np.zeros(m, dtype=np.float64)
            s_out = np.zeros(m, dtype=np.int32)
            k_out = np.full(m, -1, dtype=np.int64)

            r[low_ent] = code[FilterReason.HIGH_ENTROPY]
            live = ~low_ent & ~ov
            r[live & ~ha] = code[FilterReason.NO_MATCH]
            cand = live & ha

            # (fails, reason, reports its scores), in pseudoalign's order;
            # the multiple-match gate (None) decodes the rows still in cand
            gates = []
            if cfg.discard_nonzero_mismatch:
                gates.append((mm != 0, FilterReason.DISCARDED_NONZERO_MISMATCH,
                              False))
            gates.append((~((sc >= cfg.score_threshold)
                            & (nrm >= cfg.score_percent)),
                          FilterReason.SCORE_BELOW_THRESHOLD, True))
            if cfg.discard_multiple_matches:
                gates.append((None, FilterReason.DISCARDED_MULTIPLE_MATCH,
                              True))
            gates.append((mm > cfg.num_mismatches,
                          FilterReason.ABOVE_MISMATCH_THRESHOLD, True))
            for fails, why, report in gates:
                if fails is None:
                    fails = self.multiple_matches(keys, cand)
                hit = cand & fails
                r[hit] = code[why]
                if report:
                    nr[hit] = nrm[hit]
                    s_out[hit] = sc[hit]
                cand &= ~hit
            nr[cand] = nrm[cand]
            s_out[cand] = sc[cand]
            k_out[cand] = keys[cand]

            # scatter the per-distinct results over the duplicates
            reason[sel] = r[inv]
            norm[sel] = nr[inv]
            score[sel] = s_out[inv]
            eq_key[sel] = k_out[inv]
            # postings overflow / fingerprint collision: exact host rescue,
            # one rescue id per original row
            rescue = np.flatnonzero(ov[inv])
            count("bam.rescued", len(rescue))
            for j in rescue:
                host_align(int(sel[j]))

        return {"reason": reason, "norm": norm, "score": score,
                "eq_key": eq_key, "rescued": rescued}

    def multiple_matches(self, keys: np.ndarray, cand: np.ndarray
                         ) -> np.ndarray:
        """The multiple-match gate: the rows of ``cand`` whose combo key
        decodes to more than one distinct eq row.  Only those rows are
        decoded (counter ``bam.rows_decoded``); a candidate has an anchor,
        so its key is a device combo."""
        rows = np.flatnonzero(cand)
        count("bam.rows_decoded", len(rows))
        fails = np.zeros(len(keys), dtype=bool)
        fails[rows] = self._decode_counts(
            keys[rows], np.ones(len(rows), dtype=bool)) > 1
        return fails

    # --- AlignEngine interface (core.calls, pipeline.bam_pipeline) -------

    def align_batch(self, seqs: Sequence[Optional[np.ndarray]]) -> list:
        """Per-read ``(alignment, filter)`` results of ``pseudoalign``'s
        semantics: ``DeviceAlignEngine.align_batch``.

        A ``None`` entry gives ``(None, None)``; a read shorter than
        ``MIN_READ_LENGTH`` ``(None, (SHORT_READ, 0.0, 0))``; a read longer
        than the largest bucket goes to host ``pseudoalign``; the rest run
        through the full device pass, one launch per length bucket
        (:meth:`_run_bucket`).
        """
        results: list = [(None, None)] * len(seqs)
        by_bucket: dict = {}
        for i, s in enumerate(seqs):
            if s is None:
                continue
            if len(s) < MIN_READ_LENGTH:
                results[i] = (None, (FilterReason.SHORT_READ, 0.0, 0))
            elif len(s) > self.buckets[-1]:
                results[i] = pseudoalign(s, self.index, self.config,
                                         MIN_READ_LENGTH)
            else:
                bucket = next(b for b in self.buckets if b >= len(s))
                by_bucket.setdefault(bucket, []).append(i)
        for bucket, idxs in by_bucket.items():
            self._run_bucket(seqs, idxs, bucket, results)
        return results

    def _run_bucket(self, seqs, idxs, bucket, results) -> None:
        """One bucket of :meth:`align_batch`: the full pass over the
        distinct packed rows, then ``DeviceAlignEngine._run_bucket``'s host
        order per read: the f64 entropy gate, host rescue of postings
        overflow and fingerprint collisions, no anchor, the nonzero-mismatch
        discard (reported with zero scores), ``filter_alignment_by_metrics``.
        """
        m = len(idxs)
        mat = np.zeros((m, bucket), dtype=np.int8)
        lens = np.zeros(m, dtype=np.int32)
        for j, i in enumerate(idxs):
            mat[j, : len(seqs[i])] = seqs[i]
            lens[j] = len(seqs[i])
        buf_all = pack_reads(mat, lens, bucket)
        low_ent = ~entropy_pass_packed(buf_all, m, lens, (bucket + 3) // 4)
        # the full result is a pure function of the packed row
        first, inv = dedupe_packed_rows(buf_all)
        state = {"stream": self._stream()}
        out_dev = self._launch(buf_all[first], bucket, full=True)
        self._wait(state)
        out = unpack_full_packed(out_dev.cpu().numpy())
        cfg = self.config
        for j, i in enumerate(idxs):
            s, r = seqs[i], inv[j]
            if low_ent[j]:
                results[i] = (None, (FilterReason.HIGH_ENTROPY, 0.0, 0))
            elif out["overflow"][r]:
                results[i] = pseudoalign(s, self.index, cfg, MIN_READ_LENGTH)
            elif not out["has_anchor"][r]:
                results[i] = (None, (FilterReason.NO_MATCH, 0.0, 0))
            else:
                eq = self.decode_combo(int(out["astart"][r]),
                                       int(out["mask"][r]))
                score = int(out["score"][r])
                mismatches = int(out["mismatches"][r])
                if cfg.discard_nonzero_mismatch and mismatches != 0:
                    results[i] = (None, (
                        FilterReason.DISCARDED_NONZERO_MISMATCH, 0.0, 0))
                    continue
                results[i] = filter_alignment_by_metrics(
                    eq, score, score / len(s),  # f64, the reference's
                    cfg.score_threshold, cfg.score_percent,
                    cfg.discard_multiple_matches, cfg.num_mismatches,
                    mismatches)

    # --- combo decoding (host) --------------------------------------------

    def decode_combo(self, astart: int, mask: int) -> List[int]:
        """(astart, mask) -> sorted distinct eq-class row ids."""
        prow = self.bidx.postings_row
        m, c, rows = int(mask), 0, []
        while m:
            if m & 1:
                rows.append(int(prow[int(astart) + c]))
            m >>= 1
            c += 1
        return sorted(set(rows))

    def decode_rows_padded(self, keys: np.ndarray, valid=None) -> np.ndarray:
        """Combo keys (astart << c_max | mask) -> sorted distinct eq rows,
        (M, c_max) int64 padded with EQ_ROW_PAD (duplicates blanked)."""
        c_max = self.c_max
        prow = self.bidx.postings_row
        if valid is None:
            valid = keys >= 0
        astart = np.where(valid, keys >> c_max, 0).astype(np.int64)
        mask = np.where(valid, keys & ((1 << c_max) - 1), 0).astype(np.int64)
        lanes = np.arange(c_max, dtype=np.int64)
        rows = prow[
            np.clip(astart[:, None] + lanes[None, :], 0, len(prow) - 1)
        ].astype(np.int64)
        big = self.EQ_ROW_PAD
        bit = ((mask[:, None] >> lanes[None, :]) & 1).astype(bool)
        rows = np.where(bit & valid[:, None], rows, big)
        rows.sort(axis=1)
        dup = np.zeros_like(rows, dtype=bool)
        dup[:, 1:] = (rows[:, 1:] == rows[:, :-1]) & (rows[:, 1:] != big)
        rows = np.where(dup, big, rows)
        rows.sort(axis=1)
        return rows

    def _decode_counts(self, keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Distinct eq-row count per combo key."""
        rows = self.decode_rows_padded(keys, valid)
        return (rows != self.EQ_ROW_PAD).sum(axis=1).astype(np.int32)


class TorchAlignEngine(BucketedEngine):
    """Batched torch/CUDA alignment engine with host-exact filtering.

    ``walk`` selects the walk kernel of both device passes: ``"fused"``
    (default; the JAX engine's ``use_pallas_walk="fused"``) or ``"double"``
    (relative-coordinate masks + the double-walk kernel;
    ``use_pallas_walk=True``).  Results are identical.
    """

    def __init__(
        self,
        index: KmerIndex,
        config: AlignFilterConfig,
        *,
        device,
        c_max: int = 8,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        launch_batch: int = 8192,
        walk: str = "fused",
    ):
        if int(launch_batch) < 1:
            raise ValueError("launch_batch must be positive")
        if walk not in WALKS:
            raise ValueError(f"walk={walk!r} is not one of {WALKS}")
        check_c_max(int(c_max))
        self.device = torch.device(device)
        self.index = index
        self.config = config
        self.c_max = int(c_max)
        self.buckets = tuple(sorted(buckets))
        self.launch_batch = int(launch_batch)
        self.walk = walk
        with setup_span("setup.index_build"):
            self.bidx = build_bucketed_index(index)
        if self.device.type == "cuda":
            # the engine's first touch of the card makes its context
            with setup_span("setup.device_open"):
                torch.cuda.synchronize(self.device)
        with setup_span("setup.table_upload"):
            self.tables = tables_from_bucketed_index(self.bidx, self.device)
        self.scalars = FilterScalars.from_config(config)
        self._s_min_dev: dict = {}

    # --- compact interface: (B, 2) int32 per launch -----------------------

    def _s_min(self, bucket: int) -> torch.Tensor:
        key = (self.config.score_percent, bucket)
        t = self._s_min_dev.get(key)
        if t is None:
            t = torch.from_numpy(
                s_min_table(self.config.score_percent, bucket)
            ).to(self.device)
            self._s_min_dev[key] = t
        return t

    def _device_pass(self, bucket: int, full: bool):
        kw = dict(t=self.tables, bucket=bucket, c_max=self.c_max,
                  walk=self.walk)
        if full:
            return functools.partial(probe_walk_full, **kw)
        return functools.partial(probe_walk_filter, scalars=self.scalars,
                                 s_min=self._s_min(bucket), **kw)
