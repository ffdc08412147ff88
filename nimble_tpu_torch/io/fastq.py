"""FASTQ reading (plain or gzip) into coded read arrays.

Parity target: `src/parse/fastq.rs` — niffler compression sniffing + bio fastq
records mapped to `DnaString::from_acgt_bytes` (unknown bases -> 'A').
Malformed records (e.g. separator/quality-length mismatches) raise
``ValueError("Unable to read sequence")`` like the reference's error-checked
iterator (`src/parse/fastq.rs:35-41`).
"""

from __future__ import annotations

import ctypes
import gzip
import io
from typing import Iterator, List

import numpy as np

from nimble_tpu_torch.utils.dna import encode_bases
from nimble_tpu_torch.utils.metrics import count, span


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
    """Padded (N, Lmax) base-code matrix of the scanned record spans of
    ``buf``, encoded and zero-padded by the native fill."""
    from nimble_tpu_torch import native

    lmax = int(lens.max()) if len(lens) else 0
    mat = np.empty((len(lens), max(lmax, 1)), dtype=np.int8)
    native.fill_matrix_encode(buf, offsets, lens, lmax, mat)
    return mat, lens.astype(np.int32)


# bytes a record is taken to hold until the first chunk is scanned; after
# that, the bytes a record of the last chunk
FIRST_BYTES_PER_RECORD = 256


def _chunk_bytes(chunk_reads: int, per_record: float) -> int:
    """Bytes read ahead for a chunk: its records at ``per_record`` bytes
    each, and an eighth more for records longer than that."""
    return int(chunk_reads * per_record * 9 / 8) + 64


def iter_fastq_matrix_chunks(path: str, chunk_reads: int):
    """Yield (codes_matrix, lengths) chunks of EXACTLY ``chunk_reads``
    records (final chunk smaller).

    The exact chunk size is a contract: paired-end pipelines zip the R1 and
    R2 chunk iterators in lockstep, so both files must chunk at identical
    record counts regardless of record byte sizes.

    Streaming form of :func:`read_fastq_matrix` for inputs too large to hold
    as one matrix.  Native path: the iterator owns one byte buffer, sized
    for a chunk from the bytes a record seen so far and grown only when a
    chunk's records do not fit.  A chunk is one ``readinto`` after the
    carried tail, one C scan for its records and one C fill that encodes
    their bases into the zero-padded rows of the chunk's matrix, as wide as
    its longest read.  The C calls run without the GIL.
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

    offsets = np.empty(chunk_reads, dtype=np.int64)
    lens = np.empty(chunk_reads, dtype=np.int64)
    per_record = float(FIRST_BYTES_PER_RECORD)
    buf = np.empty(_chunk_bytes(chunk_reads, per_record), dtype=np.uint8)
    have = 0       # bytes of buf read and not yet handed out
    consumed = 0   # bytes at buf's front the last chunk took
    eof = False
    # each read and scan, and each chunk's fill, is a span
    # (``fastq.parse.read``, ``.scan``, ``.fill``)
    with _open_maybe_gzip(path) as f:
        while True:
            want = min(len(buf), _chunk_bytes(chunk_reads, per_record))
            while True:
                with span("fastq.parse.read"):
                    if consumed:
                        have -= consumed
                        ctypes.memmove(buf.ctypes.data,
                                       buf.ctypes.data + consumed, have)
                        consumed = 0
                    view = memoryview(buf)
                    while not eof and have < want:
                        got = f.readinto(view[have:want])
                        eof = not got
                        have += got
                with span("fastq.parse.scan"):
                    n, taken, lmax = native.fastq_scan2(
                        view[:have], eof, offsets, lens)
                if n == chunk_reads or eof:
                    break
                # the chunk's records run past the bytes read: read on to
                # the buffer's end, then into a larger buffer
                if want < len(buf):
                    want = len(buf)
                    continue
                size = 2 * len(buf)
                if n:
                    size = max(size, _chunk_bytes(chunk_reads, taken / n))
                grown = np.empty(size, dtype=np.uint8)
                grown[:have] = buf[:have]
                buf, want = grown, size
                count("fastq.parse.buffer_grows", 1)
            count("fastq.bytes_in", taken)
            if n == 0:
                return  # the end of the file (the scan raised if malformed)
            with span("fastq.parse.fill", items=n):
                mat = np.empty((n, max(lmax, 1)), dtype=np.int8)
                native.fill_matrix_encode(view[:have], offsets[:n],
                                          lens[:n], lmax, mat)
                chunk = mat, lens[:n].astype(np.int32)
            consumed = taken
            per_record = max(taken / n, 16.0)
            yield chunk


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

    from nimble_tpu_torch import native

    with span("fastq.parse.read"):
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            blo = _fastq_boundary(f, byte_lo, size)
            bhi = _fastq_boundary(f, byte_hi, size)
            f.seek(blo)
            buf = f.read(bhi - blo)

    if native.available():
        with span("fastq.parse.scan"):
            offsets, lens = native.fastq_scan(buf,
                                              max_records=len(buf) // 5 + 1)
        with span("fastq.parse.fill"):
            return _matrix_from_scan(buf, offsets, lens)

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
