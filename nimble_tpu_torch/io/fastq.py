"""FASTQ reading (plain or gzip) into coded read arrays.

Parity target: `src/parse/fastq.rs` — niffler compression sniffing + bio fastq
records mapped to `DnaString::from_acgt_bytes` (unknown bases -> 'A').
Malformed records (e.g. separator/quality-length mismatches) raise
``ValueError("Unable to read sequence")`` like the reference's error-checked
iterator (`src/parse/fastq.rs:35-41`).
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List

import numpy as np

from nimble_tpu_torch.utils.dna import encode_bases


def _open_maybe_gzip(path: str):
    """Sniff gzip by magic bytes (niffler-style, `src/parse/fastq.rs:25-29`)."""
    try:
        f = open(path, "rb")
    except OSError:
        raise ValueError(
            f"Error -- could not determine compression format for {path}"
        ) from None
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def iter_fastq_codes(path: str) -> Iterator[np.ndarray]:
    """Yield int8 base-code arrays for each FASTQ record in order."""
    with _open_maybe_gzip(path) as f:
        text = io.BufferedReader(f) if not isinstance(f, io.BufferedReader) else f
        while True:
            header = text.readline()
            if not header:
                return
            header = header.strip()
            if not header:
                continue
            seq = text.readline().strip()
            sep = text.readline().strip()
            qual_line = text.readline()
            # bio's fastq reader validates the record structure ('@' header,
            # '+' separator, quality line present) but NOT the quality length
            # (the repo's mismatch.fastq has longer qual lines than sequences).
            if (
                not header.startswith(b"@")
                or not sep.startswith(b"+")
                or not qual_line
            ):
                raise ValueError("Unable to read sequence")
            yield encode_bases(seq)


def read_fastq_codes(path: str) -> List[np.ndarray]:
    """Eagerly read a whole FASTQ file as coded arrays."""
    return list(iter_fastq_codes(path))


def _matrix_from_scan(buf, offsets, lens):
    """Padded (N, Lmax) fill from scanned record spans (C++ memcpy rows)."""
    from nimble_tpu_torch import native

    codes = native.encode_bases_bulk(buf)
    lmax = int(lens.max()) if len(lens) else 1
    mat = native.fill_matrix(codes, offsets, lens, lmax)
    return mat, lens.astype(np.int32)


def iter_fastq_matrix_chunks(path: str, chunk_reads: int):
    """Yield (codes_matrix, lengths) chunks of EXACTLY ``chunk_reads``
    records (final chunk smaller).

    The exact chunk size is a contract: paired-end pipelines zip the R1 and
    R2 chunk iterators in lockstep, so both files must chunk at identical
    record counts regardless of record byte sizes.

    Streaming form of :func:`read_fastq_matrix` for inputs too large to hold
    as one matrix.  Native fast path: fixed-size byte blocks scanned by the
    C++ record scanner (complete records committed, partial tail carried)
    and filled with memcpy rows — no per-record Python work.
    """
    from nimble_tpu_torch import native

    if not native.available():
        from nimble_tpu_torch.core.fast_count import pack_matrix

        batch = []
        for codes in iter_fastq_codes(path):
            batch.append(codes)
            if len(batch) >= chunk_reads:
                yield pack_matrix(batch)
                batch = []
        if batch:
            yield pack_matrix(batch)
        return

    # pending scanned-but-unemitted records: (raw_block, offsets, lens)
    # segments — rows encode during the matrix fill (fill_matrix_encode),
    # so the block's non-sequence bytes (~4x the sequence volume: headers,
    # plus lines, qualities) are never LUT-encoded at all
    segments: list = []
    pend = 0

    def emit(n: int):
        nonlocal pend
        take = []
        need = n
        while need:
            raw, offs, ls = segments[0]
            if len(offs) <= need:
                take.append(segments.pop(0))
                need -= len(offs)
            else:
                take.append((raw, offs[:need], ls[:need]))
                segments[0] = (raw, offs[need:], ls[need:])
                need = 0
        pend -= n
        all_lens = np.concatenate([t[2] for t in take])
        lmax = int(all_lens.max()) if n else 1
        mat = np.zeros((n, max(lmax, 1)), dtype=np.int8)
        row = 0
        for raw, offs, ls in take:
            if not native.fill_matrix_encode(raw, offs, ls, lmax, out=mat,
                                             row0=row):
                native.fill_matrix(native.encode_bases_bulk(raw), offs, ls,
                                   lmax, out=mat, row0=row)
            row += len(offs)
        return mat, all_lens.astype(np.int32)

    with _open_maybe_gzip(path) as f:
        tail = b""
        eof = False
        est = 256.0  # bytes/record estimate, refined from the first block
        while True:
            while pend < chunk_reads and not (eof and not tail):
                if not eof:
                    want = max(
                        int((chunk_reads - pend) * est) - len(tail), 1 << 16
                    )
                    data = f.read(want)
                    if len(data) < want:
                        eof = True
                    buf = tail + data if tail else data
                else:
                    buf = tail
                if not buf:
                    break
                offsets, lens, consumed = native.fastq_scan2(
                    buf, eof, len(buf) // 5 + 1
                )
                tail = buf[consumed:]
                if len(offsets) == 0:
                    if eof and not tail:
                        break  # only blanks (scan2 raised if malformed)
                    est *= 2  # record larger than the block: grow and retry
                    continue
                est = max(consumed / len(offsets), 16.0)
                segments.append((buf, offsets, lens))
                pend += len(offsets)
            if pend == 0:
                return
            yield emit(min(pend, chunk_reads))


def is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _fastq_boundary(f, offset: int, size: int) -> int:
    """First FASTQ record start at/after byte ``offset`` (deterministic:
    a pure function of the file bytes, so adjacent hosts computing the
    shared split point agree).  A line is a record start iff it begins
    with '@' and the line after next begins with '+' — a quality line
    starting with '@' fails this because the line 2 below it is a
    sequence line."""
    if offset <= 0:
        return 0
    if offset >= size:
        return size
    start = offset - 1  # back up one byte: catches a record starting AT offset
    f.seek(start)
    window = 1 << 20
    buf = b""
    while True:
        buf += f.read(window)
        at_eof = start + len(buf) >= size
        pos = 0
        while True:
            nl = buf.find(b"\n", pos)
            if nl < 0 or nl + 1 >= len(buf):
                break
            s = nl + 1
            if buf[s : s + 1] == b"@":
                e1 = buf.find(b"\n", s)
                if e1 < 0:
                    break
                e2 = buf.find(b"\n", e1 + 1)
                if e2 < 0:
                    if not at_eof:
                        break
                    e2 = len(buf) - 1
                # a record start is an '@' line whose line-after-next is the
                # '+' separator; EOF there instead means this '@' line is a
                # quality line of the final record (quality bytes can be
                # '@' = Phred Q31), NOT a record start
                if buf[e2 + 1 : e2 + 2] == b"+":
                    return start + s
            pos = nl + 1
        if at_eof:
            return size
        window *= 2


def read_fastq_matrix_byterange(path: str, byte_lo: int, byte_hi: int):
    """Records whose START offset falls in the record-boundary-snapped
    range [boundary(byte_lo), boundary(byte_hi)) as a code matrix + lengths.

    The multi-host feed shards a plain FASTQ this way so each host reads
    and parses only ~1/n of the file (SURVEY.md §2c "host feed sharded
    per-host over input files/record ranges").  Requires an uncompressed
    file (gzip streams are not seekable — callers fall back to record-range
    slicing of a full parse)."""
    import os
    import sys
    import time as _time

    from nimble_tpu_torch import native

    _timing = bool(os.environ.get("NIMBLE_TIMING"))
    _t0 = _time.time()
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        blo = _fastq_boundary(f, byte_lo, size)
        bhi = _fastq_boundary(f, byte_hi, size)
        _t1 = _time.time()
        f.seek(blo)
        buf = f.read(bhi - blo)
    _t2 = _time.time()

    if native.available():
        offsets, lens = native.fastq_scan(buf, max_records=len(buf) // 5 + 1)
        _t3 = _time.time()
        out = _matrix_from_scan(buf, offsets, lens)
        if _timing:
            print(f"[byterange] boundary {_t1-_t0:.2f}s read {_t2-_t1:.2f}s "
                  f"scan {_t3-_t2:.2f}s encode+fill {_time.time()-_t3:.2f}s",
                  file=sys.stderr)
        return out

    from nimble_tpu_torch.core.fast_count import pack_matrix

    codes = []
    text = io.BufferedReader(io.BytesIO(buf))
    while True:
        header = text.readline()
        if not header:
            break
        header = header.strip()
        if not header:
            continue
        seq = text.readline().strip()
        sep = text.readline().strip()
        qual_line = text.readline()
        if (not header.startswith(b"@") or not sep.startswith(b"+")
                or not qual_line):
            raise ValueError("Unable to read sequence")
        codes.append(encode_bases(seq))
    return pack_matrix(codes)


def read_fastq_matrix(path: str):
    """Whole FASTQ file as a padded (N, Lmax) int8 code matrix + lengths.

    Fast path: read the (decompressed) buffer once, scan record boundaries
    and translate bases with the native C++ ops; falls back to the Python
    record iterator when the native library is unavailable.
    """
    from nimble_tpu_torch import native

    with _open_maybe_gzip(path) as f:
        buf = f.read()

    scanned = None
    if native.available():
        # generous record bound: every record needs >= 5 bytes
        scanned = native.fastq_scan(buf, max_records=len(buf) // 5 + 1)

    if scanned is None:
        from nimble_tpu_torch.core.fast_count import pack_matrix

        return pack_matrix(read_fastq_codes(path))

    offsets, lens = scanned
    return _matrix_from_scan(buf, offsets, lens)
