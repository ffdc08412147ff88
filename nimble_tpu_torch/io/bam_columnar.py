"""Columnar BAM group streaming: the fast-path equivalent of
SortedBamReader + UMIReader (`src/parse/sorted_bam_reader.rs`,
`src/parse/bam.rs`) with records kept as flat arrays end-to-end — no
per-record Python objects, and per-record bytes are materialized only for
records that are actually emitted.

Records are parsed in bulk by the native C++ scanner (`nimble_bam_scan`),
derived fields (the 38-field metadata row, clipped/normalized sequences,
CB/UMI tags) are computed in one C++ pass (`nimble_bam_meta`), the skip
rules apply as vectorized byte-mask filters, and the UMI-run buffering /
CB sort / dummy-pair / qname-pairing / UMI×CB group-by emission runs in
C++ (`nimble_bam_runs`) with a Python fallback for irregular streams
(whose unpaired-qname warnings need the reference's prints).

Byte-parity contract: the stream of emitted batches (record order +
per-record metadata + group boundaries) equals what `UMIReader` over
`SortedBamReader` yields — the pipeline tests assert the final gzipped
TSVs are byte-identical.
"""

from __future__ import annotations

import queue
import struct
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from nimble_tpu_torch.io.umi import READ_BLOCK_REPORT_SIZE
from nimble_tpu_torch.utils.metrics import span

# the SEQ length the 10x rule clips (`src/parse/bam.rs:258-268`)
_CLIPPED_SEQ_LEN = 124

# bytes-valued columns carried per record: metadata prefix + the metadata
# fields the consumer needs + the grouping keys
_COLS = ("meta", "meta1", "meta15", "rev2", "qn", "sk", "cb", "umi",
         "qname_raw")


@dataclass
class EmittedBatch:
    """Many UMI×CB groups in one flat COLUMNAR batch.

    All bytes-valued per-record data rides (offsets, flat) columns — no
    per-record Python objects; ``group_off`` (int64, n_groups+1) delimits
    groups.  The output metadata block of record i is
    ``meta.get(i) + b"\\t" + skipb.get(i)``; ``skip_true`` is the parsed
    SKIP column (True = the record is an unpaired dummy); ``clipped`` marks
    the records whose SEQ the 10x 124-base rule clipped."""

    meta: "_Col"         # metadata prefix (36 tab-joined fields)
    skipb: "_Col"        # resolved SKIP column bytes (b"TRUE"/b"FALSE")
    skip_true: np.ndarray
    qual: "_Col"
    rev2: "_Col"
    seq15: "_Col"
    qn: "_Col"
    seq: "_Col"          # 2-bit codes as int8, flat ragged layout
    group_off: np.ndarray
    clipped: np.ndarray

    def __len__(self) -> int:
        return len(self.skip_true)

    @property
    def n_groups(self) -> int:
        return len(self.group_off) - 1

    def drop_last_group(self) -> "EmittedBatch":
        """Batch minus its final group (the reference's dropped-final-UMI
        quirk, `src/process/bam.rs:163-179`)."""
        if self.n_groups == 0:
            return self
        return self.slice_groups(0, self.n_groups - 1)

    def slice_groups(self, g_lo: int, g_hi: int) -> "EmittedBatch":
        """Groups [g_lo, g_hi) as a new batch (multi-host group-range
        sharding; zero-copy column views)."""
        g_lo = max(0, g_lo)
        g_hi = min(self.n_groups, g_hi)
        if g_lo >= g_hi:
            g_lo = g_hi = 0
        start = int(self.group_off[g_lo])
        end = int(self.group_off[g_hi])

        def cut(col: "_Col") -> "_Col":
            return col.head(end).drop_front(start)

        return EmittedBatch(
            cut(self.meta), cut(self.skipb), self.skip_true[start:end],
            cut(self.qual), cut(self.rev2), cut(self.seq15), cut(self.qn),
            cut(self.seq), self.group_off[g_lo : g_hi + 1] - start,
            self.clipped[start:end],
        )


_FALSE5 = np.frombuffer(b"FALSE", dtype=np.uint8)
_TRUE4 = np.frombuffer(b"TRUE", dtype=np.uint8)


def _skip_words(is_true: np.ndarray) -> "_Col":
    """Constant-word SKIP column: b"TRUE" where ``is_true`` else b"FALSE"."""
    k = len(is_true)
    lens = np.where(is_true, 4, 5).astype(np.int64)
    offs = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    mat = np.tile(_FALSE5, (k, 1))
    mat[is_true, :4] = _TRUE4
    flat = mat[np.arange(5)[None, :] < lens[:, None]]
    return _Col(offs, flat)


def read_bam_header(f) -> Tuple[str, List[Tuple[str, int]]]:
    """Parse the BAM header from a decompressed stream; returns (text, refs)."""

    def rd(n):
        d = f.read(n)
        if len(d) != n:
            raise EOFError("truncated BAM stream")
        return d

    if rd(4) != b"BAM\x01":
        raise ValueError("not a BAM file")
    l_text = struct.unpack("<i", rd(4))[0]
    text = rd(l_text).decode("ascii", "replace")
    n_ref = struct.unpack("<i", rd(4))[0]
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack("<i", rd(4))[0]
        name = rd(l_name)[:-1].decode("ascii", "replace")
        refs.append((name, struct.unpack("<i", rd(4))[0]))
    return text, refs


class _Col:
    """A variable-length bytes column as (offsets, flat uint8 array)."""

    __slots__ = ("offs", "flat")

    def __init__(self, offs: np.ndarray, flat: np.ndarray):
        self.offs = offs
        self.flat = flat

    @staticmethod
    def empty() -> "_Col":
        return _Col(np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.uint8))

    def __len__(self):
        return len(self.offs) - 1

    def get(self, i: int) -> bytes:
        return self.flat[self.offs[i] : self.offs[i + 1]].tobytes()

    def slicer(self):
        """Fast per-row getter for hot loops: ONE whole-column bytes copy up
        front, then each row read is a plain Python bytes slice (~5x cheaper
        than ndarray slice + tobytes per row)."""
        flat = self.flat.tobytes()
        offs = self.offs.tolist()

        def get(i: int, _f=flat, _o=offs) -> bytes:
            return _f[_o[i] : _o[i + 1]]

        return get

    def lens(self) -> np.ndarray:
        return np.diff(self.offs)

    def filter(self, keep: np.ndarray) -> "_Col":
        """Vectorized row filter (byte-level repeat mask)."""
        from nimble_tpu_torch import native

        res = native.take_rows(self.offs, self.flat, np.flatnonzero(keep))
        if res is not None:
            return _Col(res[0], res[1])
        lens = self.lens()
        byte_keep = np.repeat(keep, lens)
        new_lens = lens[keep]
        offs = np.zeros(len(new_lens) + 1, dtype=np.int64)
        np.cumsum(new_lens, out=offs[1:])
        return _Col(offs, self.flat[: self.offs[-1]][byte_keep])

    def take(self, idx: np.ndarray) -> "_Col":
        """Vectorized row gather (rows in ``idx`` order, repeats allowed)."""
        from nimble_tpu_torch import native

        res = native.take_rows(self.offs, self.flat, idx)
        if res is not None:
            return _Col(res[0], res[1])
        lens = self.lens()[idx]
        offs = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        total = int(offs[-1])
        delta = np.repeat(self.offs[idx] - offs[:-1], lens)
        return _Col(offs, self.flat[delta + np.arange(total, dtype=np.int64)])

    def head(self, n: int) -> "_Col":
        """First ``n`` rows (zero-copy views)."""
        return _Col(self.offs[: n + 1], self.flat[: self.offs[n]])

    def concat(self, other: "_Col") -> "_Col":
        offs = np.concatenate([self.offs, other.offs[1:] + self.offs[-1]])
        return _Col(offs, np.concatenate([self.flat, other.flat]))

    @staticmethod
    def concat_many(cols: "List[_Col]") -> "_Col":
        """One-pass concatenation of N columns (vs N-1 pairwise copies)."""
        if len(cols) == 1:
            return cols[0]
        offs_parts = [cols[0].offs]
        base = int(cols[0].offs[-1])
        for c in cols[1:]:
            offs_parts.append(c.offs[1:] + base)
            base += int(c.offs[-1])
        return _Col(
            np.concatenate(offs_parts),
            np.concatenate([c.flat for c in cols]),
        )

    def drop_front(self, n: int) -> "_Col":
        base = self.offs[n]
        return _Col(self.offs[n:] - base, self.flat[base:])


class _Carry:
    """Pending (not yet emitted) surviving records, columnar."""

    def __init__(self):
        self.cols: Dict[str, _Col] = {c: _Col.empty() for c in _COLS}
        self.seq = _Col.empty()          # int8 codes ride the same layout
        self.oflags = np.zeros(0, dtype=np.uint8)
        self.clipped = np.zeros(0, dtype=bool)

    def __len__(self):
        return len(self.oflags)

    def extend(self, other: "_Carry") -> None:
        for c in _COLS:
            self.cols[c] = self.cols[c].concat(other.cols[c])
        self.seq = self.seq.concat(other.seq)
        self.oflags = np.concatenate([self.oflags, other.oflags])
        self.clipped = np.concatenate([self.clipped, other.clipped])

    def drop_front(self, n: int) -> None:
        for c in _COLS:
            self.cols[c] = self.cols[c].drop_front(n)
        self.seq = self.seq.drop_front(n)
        self.oflags = self.oflags[n:]
        self.clipped = self.clipped[n:]


class _Pend:
    """Pending EMITTED records awaiting batch flush, columnar.

    Holds the batching/withholding semantics of
    :class:`ColumnarGroupStream`: the CURRENT last group is withheld until
    more groups follow or clean EOF."""

    NAMES = ("meta", "skipb", "qual", "rev2", "seq15", "qn", "seq")

    def __init__(self):
        self.cols: Dict[str, _Col] = {c: _Col.empty() for c in self.NAMES}
        self.skip_true = np.zeros(0, dtype=bool)
        self.clipped = np.zeros(0, dtype=bool)
        self.starts: List[int] = []  # absolute group starts in pending
        # emission pieces accumulate in lists and concatenate ONCE per
        # batch flush (_flush_tails): the old per-emission pairwise
        # concat recopied the whole growing pending buffer on every UMI
        # run — O(batch x runs) bytes of producer-thread memcpy
        self._tails: Dict[str, List[_Col]] = {c: [] for c in self.NAMES}
        self._skip_tails: List[np.ndarray] = []
        self._clip_tails: List[np.ndarray] = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def add_taken(self, cols: Dict[str, _Col], skip_true: np.ndarray,
                  clipped: np.ndarray, group_starts) -> None:
        """Append already row-gathered columns + their group starts."""
        base = self._n
        for s in group_starts:
            self.starts.append(base + int(s))
        if len(skip_true):
            for c in self.NAMES:
                self._tails[c].append(cols[c])
            self._skip_tails.append(skip_true)
            self._clip_tails.append(clipped)
            self._n += len(skip_true)

    def _flush_tails(self) -> None:
        if self._skip_tails:
            for c in self.NAMES:
                self.cols[c] = _Col.concat_many(
                    [self.cols[c]] + self._tails[c]
                )
                self._tails[c].clear()
            self.skip_true = np.concatenate(
                [self.skip_true] + self._skip_tails
            )
            self._skip_tails.clear()
            self.clipped = np.concatenate([self.clipped] + self._clip_tails)
            self._clip_tails.clear()

    def make_batch(self, end: int, cut: int) -> EmittedBatch:
        self._flush_tails()
        c = self.cols
        return EmittedBatch(
            c["meta"].head(end), c["skipb"].head(end), self.skip_true[:end],
            c["qual"].head(end), c["rev2"].head(end), c["seq15"].head(end),
            c["qn"].head(end), c["seq"].head(end),
            np.asarray(self.starts[:cut] + [end], dtype=np.int64),
            self.clipped[:end],
        )

    def emit_ready(self, final: bool,
                   target_records: int) -> Iterator[EmittedBatch]:
        n_keep = 0 if final else 1
        while len(self.starts) > n_keep and (
            final or self.starts[-1] >= target_records
        ):
            end = self.starts[-1] if not final else self._n
            cut = len(self.starts) - n_keep
            out = self.make_batch(end, cut)
            for c in self.NAMES:
                self.cols[c] = self.cols[c].drop_front(end)
            self.skip_true = self.skip_true[end:]
            self.clipped = self.clipped[end:]
            self._n = len(self.skip_true)
            rem = [s - end for s in self.starts[cut:]]
            self.starts.clear()
            self.starts.extend(rem)
            yield out
            if final:
                break

    def drop_open_group(self) -> None:
        if self.starts:
            self._flush_tails()
            end = self.starts.pop()
            for c in self.NAMES:
                self.cols[c] = self.cols[c].head(end)
            self.skip_true = self.skip_true[:end]
            self.clipped = self.clipped[:end]
            self._n = len(self.skip_true)


class ColumnarGroupStream:
    """Yields flat multi-group batches (EmittedBatch), reference semantics.

    Requires the native library; callers fall back to the object-based
    UMIReader pipeline when :func:`nimble_tpu_torch.native.available` is false.
    """

    # 4 MB decompressed chunks: the standalone producer sweep (round 4)
    # measured 661k rec/s at 4 MB vs 585k at 8 MB vs 464k at 32 MB — the
    # scan/meta working set stays cache-resident at 4-6 MB
    _CHUNK = 4 << 20

    def __init__(self, path: str, force_bam_paired: bool):
        from nimble_tpu_torch import native
        from nimble_tpu_torch.io.bam import _warn_missing_eof, open_bgzf

        if not native.available():
            raise RuntimeError("columnar BAM stream requires the native library")
        self._native = native
        _warn_missing_eof(path)
        self._f = open_bgzf(path)
        try:
            read_bam_header(self._f)
        except Exception:
            self._f.close()
            raise
        self.force_bam_paired = force_bam_paired
        self.read_counter = 0
        self._tail = b""
        self._eof = False
        self._error: Optional[Exception] = None
        # scan/meta output-buffer pool: every retained column is copied
        # (take_rows/filter) before the next chunk, so reuse is safe and
        # saves the fresh-page faults that dominated the warm producer
        self._pool: dict = {}
        # producer free-pass state (`src/process/bam.rs:163-179`): an
        # empty post-filter run before ANY delivered group sends the
        # (possibly empty) current group and reading continues; any later
        # empty run ends the stream
        self._free_pass_used = False
        self._groups_started_total = 0
        # entries emitted since the last free pass (0 right after a pass:
        # the then-open group counts as DELIVERED); >0 means an
        # UNDELIVERED open group exists
        self._entries_since_pass = 0
        # the scan-ahead thread of batches() and its queue and stop flag
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_q: Optional[queue.Queue] = None
        self._prefetch_stop: Optional[threading.Event] = None
        # set at stream end: True when the final emitted group is an
        # undelivered OPEN group that the reference producer never sends
        # (the dropped-final-group quirk applies to exactly this case)
        self.final_open_group_pending = False

    # -------------------------- chunk ingestion ------------------------

    def _scan_chunk(self) -> Optional[_Carry]:
        """Read, inflate and scan one chunk, derive its metadata and apply
        the skip rules; None at (logical) EOF.

        Owns the sequential stream state (file position, BGZF tail carry,
        EOF flag).  The scan and metadata outputs live in ``self._pool``
        buffers, which are reusable as soon as this returns: every retained
        column is a fresh filter() copy.  This runs on the scan-ahead
        thread, which sets ``self._error`` below and reads it again before
        its next chunk; the consumer reads it in :meth:`_batches_loop` only
        after the thread's end-of-stream item has come through the queue,
        which orders the write before that read.
        """
        if self._error is not None:
            return None  # no reads past a fatal record
        while True:
            if self._eof and not self._tail:
                return None
            if not self._eof:
                chunk = self._f.read(self._CHUNK)
                if len(chunk) < self._CHUNK:
                    self._eof = True
                data = self._tail + chunk
            else:
                data = self._tail
            if not data:
                return None
            res = self._native.bam_scan(data, len(data) // 36 + 1,
                                        pool=self._pool)
            (count, consumed, fixed, qname, seq, qual, aux, _cig) = res
            self._tail = data[consumed:]
            if count:
                break
            if self._eof:
                if self._tail:
                    raise EOFError("truncated BAM stream")
                return None

        cols = self._native.bam_meta(count, fixed, qname, seq, qual,
                                     aux, pool=self._pool)
        oflags = cols["oflags"]
        paired = (oflags & 1) != 0
        has_cb = (oflags & 4) != 0
        has_umi = (oflags & 8) != 0

        # skip rules, reference order (`sorted_bam_reader.rs:45-68`)
        keep = np.ones(count, dtype=bool)
        if self.force_bam_paired:
            keep &= paired
        keep &= has_cb
        bad_umi = keep & ~has_umi
        if bad_umi.any():
            # the reference raises when the reader reaches this record
            first_bad = int(np.flatnonzero(bad_umi)[0])
            keep &= np.arange(count) < first_bad
            self._error = ValueError("Error -- Could not read UMI.")

        # whitelisted-UMI filter (vectorized 10-byte compare)
        umi_off, umi_flat = cols["umi"]
        umi_lens = np.diff(umi_off[: count + 1])
        cand = keep & (umi_lens == 10)
        if cand.any():
            idx = np.flatnonzero(cand)
            win = umi_flat[
                umi_off[idx][:, None] + np.arange(10, dtype=np.int64)[None, :]
            ]
            keep[idx[(win == ord("A")).all(axis=1)]] = False

        out = _Carry()
        for name in _COLS:
            if name == "qname_raw":
                offs, flat = qname
                offs = offs[: count + 1]
            else:
                offs, flat = cols[name]
                offs = offs[: count + 1]
            col = _Col(np.ascontiguousarray(offs, dtype=np.int64),
                       flat[: offs[-1]])
            out.cols[name] = col.filter(keep)
        s_offs, s_flat = cols["seq2"]
        out.seq = _Col(
            np.ascontiguousarray(s_offs[: count + 1], dtype=np.int64),
            s_flat[: s_offs[count]].view(np.uint8),
        ).filter(keep)
        out.oflags = oflags[keep]
        # the 10x rule clips a SEQ of exactly 124 bases (``nimble_bam_meta``)
        raw_lens = np.diff(seq[0][: count + 1])
        out.clipped = (raw_lens == _CLIPPED_SEQ_LEN)[keep]
        return out

    # ----------------- Python fallback (irregular runs) ----------------

    def _run_entries_python(self, c: _Carry, lo: int, hi: int,
                            is_final: bool) -> List[Tuple[int, bytes]]:
        """CB-sort + dummy-pair + qname-pair one UMI run; reference
        semantics incl. the unpaired-qname warnings
        (`src/parse/sorted_bam_reader.rs:85-162`)."""
        cb = c.cols["cb"]
        qn = c.cols["qname_raw"]
        order = list(range(lo, hi))
        if not is_final:
            order.sort(key=lambda i: cb.get(i))

        if not self.force_bam_paired:
            buf: List[Tuple[int, bytes]] = []
            for i in order:
                buf.append((i, b"FALSE"))
                if not (c.oflags[i] & 1):
                    buf.append((i, b"TRUE"))
        else:
            sk = c.cols["sk"]
            buf = [(i, sk.get(i)) for i in order]

        entries: List[Tuple[int, bytes]] = []
        n = len(buf)
        j = 0
        seen_qnames: Optional[set] = None
        while j < n:
            if j + 1 >= n:
                break
            i1, s1 = buf[j]
            i2, s2 = buf[j + 1]
            q1 = qn.get(i1)
            if q1 == qn.get(i2):
                if c.oflags[i1] & 16:
                    entries.append((i1, s1))
                    entries.append((i2, s2))
                else:
                    entries.append((i2, s2))
                    entries.append((i1, s1))
                if seen_qnames is not None:
                    seen_qnames.add(q1)
                j += 2
            else:
                print("Warning: Unpaired qname!")
                if seen_qnames is None:
                    seen_qnames = set(qn.get(i) for i, _ in entries)
                if q1 in seen_qnames:
                    print(
                        f"Warning: Read with qname "
                        f"'{q1.decode('latin-1')}' has been deleted "
                        "but was seen before."
                    )
                seen_qnames.add(q1)
                j += 1
        return entries

    def _fallback_runs(self, carry: _Carry, at_eof: bool):
        """Run-split + emit one carry the slow way (irregular streams whose
        unpaired-qname warnings need the reference's exact prints).

        Returns ``(e_idx, e_skip, g_starts, keep_from, truncated)`` and
        updates ``self._free_pass_used`` / ``self._entries_since_pass``.
        """
        n = len(carry)
        umi = carry.cols["umi"]
        umis = [umi.get(i) for i in range(n)]
        boundaries = [0]
        for i in range(1, n):
            if umis[i] != umis[i - 1]:
                boundaries.append(i)
        boundaries.append(n)
        runs = [
            (a, b)
            for a, b in zip(boundaries[:-1], boundaries[1:]) if a < b
        ]
        process_final = at_eof and self._error is None
        if not process_final and runs:
            keep_from = runs[-1][0]
            runs = runs[:-1]
        else:
            keep_from = n
        cbc = carry.cols["cb"]
        e_idx: List[int] = []
        e_skip: List[int] = []
        g_starts: List[int] = []
        last_key = None
        truncated = False
        pass_at = None
        for lo, hi in runs:
            is_final_run = process_final and hi == n
            entries = self._run_entries_python(carry, lo, hi, is_final_run)
            if not entries:
                # empty post-filter run: BamTruncatedRecord in the
                # reference — ends the stream iff a group was already
                # delivered, else consumes the producer's one free pass
                # (`src/process/bam.rs:163-179`)
                aligned = (
                    self._free_pass_used
                    or self._groups_started_total + len(g_starts) >= 2
                )
                if not aligned:
                    self._free_pass_used = True
                    pass_at = len(e_idx)
                    last_key = None  # key state resets
                    continue
                truncated = True
                break
            for i, skip_val in entries:
                cbv = cbc.get(i)
                key = umis[i] + cbv[: max(len(cbv) - 2, 0)]
                if key != last_key:
                    g_starts.append(len(e_idx))
                    last_key = key
                e_idx.append(i)
                e_skip.append(
                    2 if self.force_bam_paired
                    else (1 if skip_val == b"TRUE" else 0)
                )
        if pass_at is not None:
            self._entries_since_pass = len(e_idx) - pass_at
        else:
            self._entries_since_pass += len(e_idx)
        return e_idx, e_skip, g_starts, keep_from, truncated

    # ------------------- batch iteration (fast pipeline) ----------------

    def _count_progress(self, k: int) -> None:
        """Progress print parity (`src/parse/bam.rs:121-127`)."""
        before = self.read_counter
        self.read_counter += k
        blk = READ_BLOCK_REPORT_SIZE
        for mark in range((before // blk) + 1,
                          (self.read_counter // blk) + 1):
            print(f"Aligned reads {(mark - 1) * blk}-{mark * blk}")

    def _add_emitted(self, pend: _Pend, c: _Carry, emit_idx, emit_skip,
                     group_starts) -> None:
        """Row-gather ``emit_idx`` from the carry into the pend buffer."""
        self._groups_started_total += len(group_starts)
        idx = np.asarray(emit_idx, dtype=np.int64)
        k = len(idx)
        taken: Dict[str, _Col] = {}
        skip_true = clipped = np.zeros(0, dtype=bool)
        if k:
            codes = np.asarray(emit_skip, dtype=np.int8)
            if (codes == 2).all():
                # force_bam_paired path: the sk column holds the BAM's
                # own SK:Z: aux value verbatim — the skip test is exact
                # string equality with "TRUE" (`src/align.rs:527-531`,
                # slow path: m[37] == "TRUE"), not a length heuristic
                skipb = c.cols["sk"].take(idx)
                sl = skipb.lens()
                skip_true = np.zeros(k, dtype=bool)
                four = np.flatnonzero(sl == 4)
                if len(four):
                    o = skipb.offs[:-1][four]
                    eq = np.ones(len(four), dtype=bool)
                    for j, ch in enumerate(b"TRUE"):
                        eq &= skipb.flat[o + j] == ch
                    skip_true[four] = eq
            else:
                skip_true = codes == 1
                skipb = _skip_words(skip_true)
            for name, src in (
                ("meta", "meta"), ("qual", "meta1"), ("rev2", "rev2"),
                ("seq15", "meta15"), ("qn", "qn"),
            ):
                taken[name] = c.cols[src].take(idx)
            taken["skipb"] = skipb
            taken["seq"] = c.seq.take(idx)
            clipped = c.clipped[idx]
        pend.add_taken(taken, skip_true, clipped, group_starts)
        self._count_progress(k)

    def _end_batches(self, pend: _Pend, target_records: int,
                     drop_open_on_error: bool = False) -> list:
        """The final-group verdict, and the last batches."""
        open_exists = self._entries_since_pass > 0
        delivered = self._groups_started_total - (1 if open_exists else 0)
        # has_aligned at the final truncation: a group was delivered
        # before (free pass counts) -> the open group is never sent
        self.final_open_group_pending = open_exists and (
            self._free_pass_used or delivered >= 1
        )
        if drop_open_on_error and open_exists:
            # fatal error: delivered groups are logged, the partial
            # open group was never returned by the reader
            pend.drop_open_group()
        return list(pend.emit_ready(final=True,
                                    target_records=target_records))

    def _stop_prefetch(self) -> None:
        """Stop the scan-ahead thread and wait for it (idempotent).

        Must run BEFORE the file handle closes: the thread may be inside
        self._f.read(), and a concurrent close() would race it.  Draining
        the bounded queue wakes a blocked put() so the thread can observe
        the stop flag and exit.
        """
        t = self._prefetch_thread
        if t is None:
            return
        self._prefetch_stop.set()
        while t.is_alive():
            try:
                self._prefetch_q.get_nowait()
            except queue.Empty:
                t.join(0.02)
        self._prefetch_thread = None

    def close(self) -> None:
        self._stop_prefetch()
        self._f.close()

    def batches(self, target_records: int = 16384) -> Iterator[EmittedBatch]:
        """Yield flat multi-group COLUMNAR batches in stream order.

        The stream's CURRENT last group is withheld until more groups
        follow or clean EOF — exactly when the object-based reader would
        surface it (and never, like the reference, when a fatal record
        error interrupts the stream first).

        One scan-ahead thread, ``bam-scan``, runs the scan half (read +
        parallel BGZF inflate + C++ scan/meta + filters) up to two chunks
        ahead of the run/group emission here.  Each scanned chunk is the
        span ``bam.scan`` on that thread; the emission is ``bam.group``.
        An exception on the thread re-raises where its chunk is consumed,
        as an inline call would.
        """
        carry = _Carry()
        pend = _Pend()
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def scan_ahead() -> None:
            while not stop.is_set():
                try:
                    with span("bam.scan"):
                        item = self._scan_chunk()
                except BaseException as e:  # noqa: BLE001 — replayed
                    q.put(("exc", e))
                    return
                q.put(("ok", item))
                if item is None:
                    return

        def fetch() -> Optional[_Carry]:
            kind, val = q.get()
            if kind == "exc":
                raise val
            return val

        self._prefetch_q = q
        self._prefetch_stop = stop
        self._prefetch_thread = threading.Thread(
            target=scan_ahead, name="bam-scan", daemon=True)
        self._prefetch_thread.start()
        # the try/finally guards ABANDONMENT (consumer exception or an
        # early generator close): without it the thread would keep
        # scanning, block forever on the bounded queue, and hold the BAM
        # file handle open for the process lifetime.  Normal termination
        # reaches close() in _batches_loop, which also stops the thread
        # before the handle closes.
        try:
            yield from self._batches_loop(fetch, carry, pend, target_records)
        finally:
            self._stop_prefetch()

    def _batches_loop(self, fetch, carry, pend,
                      target_records: int) -> Iterator[EmittedBatch]:
        while True:
            batch = fetch()
            with span("bam.group"):
                ready, end = self._group(batch, carry, pend, target_records)
            yield from ready
            if end:
                self.close()
                if end == "error":
                    raise self._error
                return

    def _group(self, batch, carry, pend, target_records: int):
        """Pair and group the carry with one more scanned chunk (None at
        EOF) into ``pend``; returns the batches ready and how the stream
        ends: None (it goes on), "end", or "error" (raise ``_error``)."""
        at_eof = batch is None
        if batch is not None:
            carry.extend(batch)
        n = len(carry)
        if n == 0 and at_eof:
            return self._final_batches(pend, target_records)

        res = None
        if n:
            umi = carry.cols["umi"]
            cb = carry.cols["cb"]
            qname = carry.cols["qname_raw"]
            res = self._native.bam_runs(
                (umi.offs, umi.flat), (cb.offs, cb.flat),
                (qname.offs, qname.flat), carry.oflags, n,
                self.force_bam_paired,
                at_eof and self._error is None,
                free_pass_used=self._free_pass_used,
                groups_started_before=self._groups_started_total,
            )
        if res is not None:
            (emit_idx, emit_skip, group_off, consumed, truncated,
             free_used, entries_after_pass) = res
            if free_used:
                self._free_pass_used = True
                self._entries_since_pass = int(entries_after_pass)
            else:
                self._entries_since_pass += len(emit_idx)
            self._add_emitted(pend, carry, emit_idx, emit_skip,
                              group_off[:-1])
            carry.drop_front(consumed)
            if truncated:
                # a run paired down to nothing after has_aligned: the
                # reference stream ends here (BamTruncatedRecord ->
                # UMIReader None); everything past it is never read
                return self._end_batches(pend, target_records), "end"
        elif n:
            # Python fallback (irregular stream: reference warnings)
            e_idx, e_skip, g_starts, keep_from, truncated = (
                self._fallback_runs(carry, at_eof)
            )
            self._add_emitted(pend, carry, e_idx,
                              np.asarray(e_skip, dtype=np.int8), g_starts)
            if truncated:
                return self._end_batches(pend, target_records), "end"
            carry.drop_front(keep_from)

        if at_eof:
            return self._final_batches(pend, target_records)
        return list(pend.emit_ready(final=False,
                                    target_records=target_records)), None

    def _final_batches(self, pend: _Pend, target_records: int):
        """At EOF: the last batches, without the open group after a fatal
        record (then "error")."""
        if self._error is not None:
            return self._end_batches(pend, target_records,
                                     drop_open_on_error=True), "error"
        return self._end_batches(pend, target_records), "end"
