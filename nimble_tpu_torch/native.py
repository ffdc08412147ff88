"""ctypes bindings for the C++ native host ops (with pure-Python fallback).

The shared library (``csrc/nimble_host.cpp``) is compiled with g++ at first
use into ``nimble_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the flags, and written under a temporary name then renamed, so
that processes building at once never load a half-written file.  Every
binding has a NumPy fallback so the package works without a toolchain.  Use
:func:`available` to check whether the native path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "nimble_host.cpp"
_BUILD_DIR = _PKG / "_build"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LINK_FLAGS = ("-lz", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_GXX_FLAGS + _LINK_FLAGS).encode()
    ).hexdigest()
    return _BUILD_DIR / f"libnimble_host-{digest[:16]}.so"


def _build(so: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_GXX_FLAGS, str(_SRC), "-o", tmp, *_LINK_FLAGS],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.nimble_fastq_scan2.restype = ctypes.c_int64
            lib.nimble_fastq_scan2.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p]
            lib.nimble_fill_matrix_encode.restype = ctypes.c_int64
            lib.nimble_fill_matrix_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            lib.nimble_extract_kmer_keys.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
            lib.nimble_build_bucket_table.restype = ctypes.c_int32
            lib.nimble_build_bucket_table.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int32]
            lib.nimble_bam_scan.restype = ctypes.c_int64
            lib.nimble_bam_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.nimble_bam_meta.restype = ctypes.c_int32
            lib.nimble_bam_meta.argtypes = (
                [ctypes.c_void_p] * 9 + [ctypes.c_int64]
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] * 9
                + [ctypes.c_void_p]
            )
            lib.nimble_bam_runs.restype = ctypes.c_int32
            lib.nimble_bam_runs.argtypes = (
                [ctypes.c_void_p] * 7
                + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_int64]
                + [ctypes.c_void_p] * 8
            )
            lib.nimble_pack_reads.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int32]
            lib.nimble_packed_base_counts.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p]
            lib.nimble_take_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            lib.nimble_orient_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int32]
            lib.nimble_maxinfo.restype = ctypes.c_int32
            lib.nimble_maxinfo.argtypes = [
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.nimble_bam_rows.restype = ctypes.c_int32
            lib.nimble_bam_rows.argtypes = (
                [ctypes.c_int64, ctypes.c_int64]          # n_rec, W
                + [ctypes.c_void_p] * 7                   # dec..rev
                + [ctypes.c_void_p, ctypes.c_int64]       # group_off, n_groups
                + [ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
                + [ctypes.c_void_p] * 5 + [ctypes.c_int64]  # combo tables
                + [ctypes.c_void_p] * 3                   # cs tables
                + [ctypes.c_void_p] * 8                   # qn/s15/meta/skip
                + [ctypes.c_void_p] * 2                   # reasons
                + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            )
            lib.nimble_owner_hash.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            lib.nimble_bgzf_sizes.restype = ctypes.c_int32
            lib.nimble_bgzf_sizes.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.nimble_bgzf_inflate.restype = ctypes.c_int32
            lib.nimble_bgzf_inflate.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
            lib.nimble_dedupe_new.restype = ctypes.c_void_p
            lib.nimble_dedupe_free.argtypes = [ctypes.c_void_p]
            lib.nimble_dedupe_size.restype = ctypes.c_int64
            lib.nimble_dedupe_size.argtypes = [ctypes.c_void_p]
            lib.nimble_dedupe_insert.restype = ctypes.c_int64
            lib.nimble_dedupe_insert.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def fastq_scan(buf, max_records: int) -> tuple[np.ndarray, np.ndarray] | None:
    """(seq_offsets, seq_lens) of the FASTQ records of a whole file held in
    ``buf``; None if native absent.

    Raises ValueError("Unable to read sequence") on malformed records.
    """
    if _load() is None:
        return None
    offsets = np.empty(max_records, dtype=np.int64)
    lens = np.empty(max_records, dtype=np.int64)
    n = fastq_scan2(buf, True, offsets, lens)[0]
    return offsets[:n], lens[:n]


def fastq_scan2(buf, is_final: bool, offsets: np.ndarray, lens: np.ndarray
                ) -> tuple[int, int, int] | None:
    """Streaming FASTQ scan of ``buf`` (bytes or a uint8 array) into the
    caller's int64 arrays ``offsets`` and ``lens``: at most ``len(offsets)``
    COMPLETE records.  Returns (records, consumed bytes, longest sequence);
    the caller carries ``buf[consumed:]`` into its next read.  None if
    native absent; raises the reference's ValueError on malformed input."""
    lib = _load()
    if lib is None:
        return None
    for a in (offsets, lens):
        if a.dtype != np.int64 or not a.flags.c_contiguous:
            raise ValueError("fastq_scan2: offsets and lens must be "
                             "contiguous int64 arrays")
    if len(lens) < len(offsets):
        raise ValueError(f"fastq_scan2: {len(lens)} lengths for "
                         f"{len(offsets)} offsets")
    arr = np.frombuffer(buf, dtype=np.uint8)
    stats = np.zeros(2, dtype=np.int64)
    n = lib.nimble_fastq_scan2(
        arr.ctypes.data, len(arr), 1 if is_final else 0,
        offsets.ctypes.data, lens.ctypes.data, len(offsets),
        stats.ctypes.data,
    )
    if n < 0:
        raise ValueError("Unable to read sequence")
    return n, int(stats[0]), int(stats[1])


def fill_matrix_encode(raw, offsets: np.ndarray, lens: np.ndarray,
                       W: int, out: np.ndarray, row0: int = 0) -> bool:
    """Fill rows [row0, row0+n) of the C-contiguous (N, W) int8 matrix
    ``out`` straight from the RAW FASTQ text ``raw`` (bytes or a uint8
    array): row i holds the base codes of ``raw[offsets[i]:][:lens[i]]``
    (A/a=0 C/c=1 G/g=2 T/t=3, anything else 0, as utils.dna.encode_bases)
    and zeros past them, so ``out`` may come from ``np.empty``; a row is
    ``out.shape[1]`` wide (``W`` is kept for the JAX package's signature).
    Returns False when native is unavailable.  Raises ValueError, writing
    nothing, when a span is longer than a row of ``out``, the rows run past
    ``out``, or a span runs past ``raw``.
    """
    lib = _load()
    if lib is None:
        return False
    n = len(offsets)
    if out.dtype != np.int8 or out.ndim != 2 or not out.flags.c_contiguous:
        raise ValueError("fill_matrix_encode: out must be a C-contiguous "
                         "2-D int8 array")
    if row0 < 0 or row0 + n > out.shape[0]:
        raise ValueError(f"fill_matrix_encode: rows {row0}..{row0 + n} "
                         f"run past the {out.shape[0]} rows of out")
    raw_c = np.frombuffer(raw, dtype=np.uint8)
    offsets_c = np.ascontiguousarray(offsets, dtype=np.int64)
    lens_c = np.ascontiguousarray(lens, dtype=np.int64)
    if len(lens_c) != n:
        raise ValueError(f"fill_matrix_encode: {len(lens_c)} lengths for "
                         f"{n} offsets")
    bad = lib.nimble_fill_matrix_encode(
        raw_c.ctypes.data, len(raw_c), offsets_c.ctypes.data,
        lens_c.ctypes.data, n, out.shape[1], out[row0:].ctypes.data,
    )
    if bad >= 0:
        off, ln = int(offsets_c[bad]), int(lens_c[bad])
        if not 0 <= ln <= out.shape[1]:
            raise ValueError(f"fill_matrix_encode: a length of {ln} exceeds "
                             f"the row width {out.shape[1]}")
        raise ValueError(f"fill_matrix_encode: a span ends at byte "
                         f"{off + ln} of a {len(raw_c)}-byte buffer")
    return True


def extract_kmer_keys(codes: np.ndarray, k: int) -> np.ndarray | None:
    """Rolling 60-bit keys; None if native absent (use pack_kmer_keys)."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.uint64)
    out = np.empty(n - k + 1, dtype=np.uint64)
    lib.nimble_extract_kmer_keys(codes.ctypes.data, n, k, out.ctypes.data)
    return out


def owner_hash(mat, lens, n_hosts: int, mate_mat=None, mate_lens=None,
               n_threads: int = 4):
    """Per-read owner host from exact content bytes (FNV-1a over lens[i]
    bytes + length, mate included when paired); None if native absent.
    Raises ValueError when a lengths array or the mate matrix does not hold
    one entry per row of ``mat``: the C++ loop checks neither."""
    lib = _load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    n, w = mat.shape
    if len(lens32) != n or (mate_mat is not None and not (
            np.shape(mate_mat)[0] == len(mate_lens) == n)):
        raise ValueError(f"owner_hash: {n} rows need {n} lengths (and mate "
                         "rows and lengths)")
    out = np.empty(n, dtype=np.int64)
    if mate_mat is not None:
        mate_mat = np.ascontiguousarray(mate_mat, dtype=np.int8)
        ml32 = np.ascontiguousarray(mate_lens, dtype=np.int32)
        lib.nimble_owner_hash(
            mat.ctypes.data, n, w, lens32.ctypes.data,
            mate_mat.ctypes.data, mate_mat.shape[1], ml32.ctypes.data,
            n_hosts, n_threads, out.ctypes.data)
    else:
        lib.nimble_owner_hash(
            mat.ctypes.data, n, w, lens32.ctypes.data,
            None, 0, None, n_hosts, n_threads, out.ctypes.data)
    return out


def bgzf_inflate_chunk(buf: bytes, n_threads: int = 4):
    """Inflate the complete BGZF members in ``buf`` with a thread pool.

    Fills htslib's multi-threaded BGZF decompression role (the reference
    inherits it via rust-htslib, `src/parse/sorted_bam_reader.rs:1`).

    Returns ``(status, consumed_bytes, out_bytes)`` — status 0 ok, 1 not
    BGZF at offset 0 (caller falls back to plain gzip), 2 malformed header,
    3 inflate error, 4 CRC mismatch, 5 ISIZE mismatch.  ``None`` when the
    native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(buf, dtype=np.uint8)
    consumed = np.zeros(1, dtype=np.int64)
    total = np.zeros(1, dtype=np.int64)
    rc = lib.nimble_bgzf_sizes(arr.ctypes.data, len(arr),
                               consumed.ctypes.data, total.ctypes.data)
    if rc:
        return int(rc), 0, b""
    out = np.empty(int(total[0]), dtype=np.uint8)
    rc = lib.nimble_bgzf_inflate(arr.ctypes.data, len(arr),
                                 out.ctypes.data, len(out), n_threads)
    if rc:
        return int(rc), 0, b""
    return 0, int(consumed[0]), out.tobytes()


def _pool_empty(pool, key, size, dtype):
    """np.empty with optional reuse: a pool dict caches the largest buffer
    seen per key, so steady-state streaming pays no fresh-page faults.

    ONLY safe when the caller guarantees the previous call's outputs are no
    longer referenced when the next call runs (ColumnarGroupStream copies
    every retained column via take_rows/filter before the next chunk).
    """
    size = max(int(size), 1)
    if pool is None:
        return np.empty(size, dtype=dtype)
    buf = pool.get(key)
    if buf is None or buf.size < size or buf.dtype != dtype:
        buf = np.empty(size, dtype=dtype)
        pool[key] = buf
    return buf[:size]


def bam_scan(buf: bytes, max_records: int, pool=None):
    """Parse a decompressed BAM record stream into flat arrays; None when
    the native library is unavailable.

    Returns (count, consumed_bytes, fixed (count,8) int32, and
    (qname_off, qname_flat), (seq_off, seq_flat), (qual_off, qual_flat),
    (aux_off, aux_flat)) — aux_flat holds only Z/H tags as
    [tag 2B][len u16][bytes] entries.
    """
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(buf, dtype=np.uint8)
    n = len(arr)
    fixed = _pool_empty(pool, "sc_fixed", max_records * 8,
                        np.int32).reshape(max_records, 8)
    qname_off = _pool_empty(pool, "sc_qno", max_records + 1, np.int64)
    qname_flat = _pool_empty(pool, "sc_qnf", n, np.uint8)
    seq_off = _pool_empty(pool, "sc_sqo", max_records + 1, np.int64)
    seq_flat = _pool_empty(pool, "sc_sqf", 2 * n, np.uint8)
    qual_off = _pool_empty(pool, "sc_qlo", max_records + 1, np.int64)
    qual_flat = _pool_empty(pool, "sc_qlf", n, np.uint8)
    aux_off = _pool_empty(pool, "sc_axo", max_records + 1, np.int64)
    aux_flat = _pool_empty(pool, "sc_axf", 2 * n, np.uint8)
    cigar_off = _pool_empty(pool, "sc_cgo", max_records + 1, np.int64)
    cigar_flat = _pool_empty(pool, "sc_cgf", n // 4 + 1, np.uint32)
    consumed = np.zeros(1, dtype=np.int64)
    count = lib.nimble_bam_scan(
        arr.ctypes.data, n, max_records,
        fixed.ctypes.data,
        qname_off.ctypes.data, qname_flat.ctypes.data,
        seq_off.ctypes.data, seq_flat.ctypes.data,
        qual_off.ctypes.data, qual_flat.ctypes.data,
        aux_off.ctypes.data, aux_flat.ctypes.data,
        cigar_off.ctypes.data, cigar_flat.ctypes.data,
        consumed.ctypes.data,
    )
    return (
        int(count), int(consumed[0]), fixed,
        (qname_off, qname_flat), (seq_off, seq_flat),
        (qual_off, qual_flat), (aux_off, aux_flat),
        (cigar_off, cigar_flat),
    )


def bam_meta(count, fixed, qname, seq, qual, aux, pool=None):
    """Columnar per-record metadata derivation (see nimble_bam_meta).

    Inputs are bam_scan outputs (count + (off, flat) pairs).  Returns None
    when native is unavailable; else a dict of columns:
      meta/meta1/meta15/rev2/qn/cb/umi/sk — (offsets int64 (n+1), flat uint8)
      seq2 — (offsets, flat int8 codes)
      oflags — (n,) uint8: bit0 paired, bit1 reverse, bit2 has_cb, bit3 has_umi
    """
    lib = _load()
    if lib is None:
        return None
    n = count
    qname_off, qname_flat = qname
    seq_off, seq_flat = seq
    qual_off, qual_flat = qual
    aux_off, aux_flat = aux
    seq_total = int(seq_off[n])
    qual_total = int(qual_off[n])
    aux_total = int(aux_off[n])
    qn_total = int(qname_off[n])

    caps = {
        "meta": qn_total + aux_total * 16 + 240 * n + 64,
        "seq2": seq_total + 64,
        "meta1": qual_total + aux_total + 64,
        "meta15": seq_total + aux_total + 64,
        "rev2": 5 * n + aux_total + 64,
        "qn": qn_total + aux_total + 64,
        "cb": aux_total + 64,
        "umi": aux_total + 64,
        "sk": aux_total + 64,
    }
    while True:
        bufs = {}
        offs = {}
        for name, cap in caps.items():
            dt = np.int8 if name == "seq2" else np.uint8
            bufs[name] = _pool_empty(pool, "mt_" + name, cap, dt)
            offs[name] = _pool_empty(pool, "mt_o_" + name, n + 1, np.int64)
        oflags = _pool_empty(pool, "mt_oflags", n, np.uint8)
        args = [
            fixed.ctypes.data,
            qname_off.ctypes.data, qname_flat.ctypes.data,
            seq_off.ctypes.data, seq_flat.ctypes.data,
            qual_off.ctypes.data, qual_flat.ctypes.data,
            aux_off.ctypes.data, aux_flat.ctypes.data,
            n,
        ]
        for name in ("meta", "seq2", "meta1", "meta15", "rev2", "qn", "cb",
                     "umi", "sk"):
            args += [bufs[name].ctypes.data, offs[name].ctypes.data,
                     caps[name]]
        args.append(oflags.ctypes.data)
        rc = lib.nimble_bam_meta(*args)
        if rc == 0:
            out = {
                name: (offs[name], bufs[name])
                for name in bufs
            }
            out["oflags"] = oflags[:n]
            return out
        caps = {k: v * 2 for k, v in caps.items()}


def bam_runs(umi, cb, qn, oflags, n, force_paired, is_final,
             free_pass_used=False, groups_started_before=0):
    """Run/group emission over columnar records (see nimble_bam_runs).

    ``umi``/``cb``/``qn`` are (offsets int64 (n+1), flat uint8) pairs;
    ``oflags`` is the bam_meta flag byte per record.  Returns None when the
    native library is unavailable OR the stream has a qname irregularity
    (caller uses the Python path, which prints the reference's warnings);
    else (emit_idx, emit_skip, group_off, consumed, truncated,
    free_pass_now_used, entries_after_pass) — ``truncated`` True when a
    run paired down to nothing AFTER a group was already delivered, which
    ends the reference's stream (`src/parse/sorted_bam_reader.rs:164-185`
    + `src/process/bam.rs:163-179`); an empty run BEFORE any delivered
    group consumes the producer's one free pass instead (the open group
    at that moment counts as DELIVERED — ``entries_after_pass`` lets the
    caller track whether an undelivered open group exists afterwards).
    ``free_pass_used``/``groups_started_before`` carry state across
    calls.
    """
    lib = _load()
    if lib is None:
        return None
    umi_off, umi_flat = umi
    cb_off, cb_flat = cb
    qn_off, qn_flat = qn
    cap = 2 * max(n, 1) + 2
    emit_idx = np.empty(cap, dtype=np.int64)
    emit_skip = np.empty(cap, dtype=np.int8)
    emit_cnt = np.zeros(1, dtype=np.int64)
    group_off = np.empty(cap + 1, dtype=np.int64)
    n_groups = np.zeros(1, dtype=np.int64)
    consumed = np.zeros(1, dtype=np.int64)
    free_used = np.zeros(1, dtype=np.int32)
    ec_at_pass = np.zeros(1, dtype=np.int64)
    rc = lib.nimble_bam_runs(
        umi_off.ctypes.data, umi_flat.ctypes.data,
        cb_off.ctypes.data, cb_flat.ctypes.data,
        qn_off.ctypes.data, qn_flat.ctypes.data,
        oflags.ctypes.data,
        n, 1 if force_paired else 0, 1 if is_final else 0,
        1 if free_pass_used else 0, int(groups_started_before),
        emit_idx.ctypes.data, emit_skip.ctypes.data, emit_cnt.ctypes.data,
        group_off.ctypes.data, n_groups.ctypes.data, consumed.ctypes.data,
        free_used.ctypes.data, ec_at_pass.ctypes.data,
    )
    if rc not in (0, 1):
        return None
    ec = int(emit_cnt[0])
    ng = int(n_groups[0])
    go = group_off[: ng + 1].copy()
    go[ng] = ec
    entries_after_pass = ec - int(ec_at_pass[0]) if free_used[0] else None
    return (emit_idx[:ec], emit_skip[:ec], go, int(consumed[0]), rc == 1,
            bool(free_used[0]), entries_after_pass)


def bam_rows(
    n_rec, W, dec_flat, dlens, cid, scid_of, score, code, rev,
    group_off, n_groups, require_pair, code_not_matching, n_contents,
    combo_keys, combo_kind, combo_csid, combo_tri,
    cs_rank, cs,
    qn, s15, meta, skipb, reasons,
):
    """Forensic-row assembly (see nimble_bam_rows).

    Columnar (offsets, flat) pairs throughout; returns the rows blob as
    bytes, or None when native is unavailable / the batch needs the Python
    path (invalid revcomp character -> the reference's panic message).
    """
    lib = _load()
    if lib is None:
        return None
    tri_off, tri_flat = combo_tri
    cs_off, cs_flat = cs
    qn_off, qn_flat = qn
    s15_off, s15_flat = s15
    meta_off, meta_flat = meta
    skip_off, skip_flat = skipb
    reason_off, reason_flat = reasons
    dec_arr = np.frombuffer(dec_flat, dtype=np.uint8)
    cap = 256 * max(n_rec, 1) + int(meta_off[n_rec]) * 2 + 4096
    out_len = np.zeros(1, dtype=np.int64)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        rc = lib.nimble_bam_rows(
            n_rec, W,
            dec_arr.ctypes.data,
            dlens.ctypes.data, cid.ctypes.data, scid_of.ctypes.data,
            score.ctypes.data, code.ctypes.data, rev.ctypes.data,
            group_off.ctypes.data, n_groups,
            1 if require_pair else 0, code_not_matching, n_contents,
            combo_keys.ctypes.data, combo_kind.ctypes.data,
            combo_csid.ctypes.data,
            tri_off.ctypes.data, tri_flat.ctypes.data, len(combo_keys),
            cs_rank.ctypes.data, cs_off.ctypes.data, cs_flat.ctypes.data,
            qn_off.ctypes.data, qn_flat.ctypes.data,
            s15_off.ctypes.data, s15_flat.ctypes.data,
            meta_off.ctypes.data, meta_flat.ctypes.data,
            skip_off.ctypes.data, skip_flat.ctypes.data,
            reason_off.ctypes.data, reason_flat.ctypes.data,
            out.ctypes.data, cap, out_len.ctypes.data,
        )
        if rc == 0:
            return out[: int(out_len[0])].tobytes()
        if rc == -1:
            cap *= 2
            continue
        return None  # -2 invalid revcomp char (or -3 guard): Python path


def pack_reads(mat: np.ndarray, lens: np.ndarray, bucket: int, B: int,
               n_threads: int = 4) -> "np.ndarray | None":
    """2-bit launch-buffer pack (see nimble_pack_reads): (m, width) int8
    codes + lens -> (B, ceil(bucket/4)+2) uint8, rows [m, B) zero.  Returns
    None when the native library is unavailable (callers fall back to the
    NumPy pack)."""
    lib = _load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    m, width = mat.shape
    if m > B:
        # the C++ kernel writes m rows into a (B, nb+2) buffer; guard the
        # B >= m invariant here so a future caller gets a loud error (the
        # NumPy fallback raises) instead of silent heap corruption
        raise ValueError(f"pack_reads: m={m} rows exceed launch batch B={B}")
    nb = (bucket + 3) // 4
    out = np.zeros((B, nb + 2), dtype=np.uint8)
    lib.nimble_pack_reads(mat.ctypes.data, m, width, lens.ctypes.data,
                          bucket, out.ctypes.data, n_threads)
    return out


def packed_base_counts(buf: np.ndarray, m: int, nb: int
                       ) -> "np.ndarray | None":
    """Per-row base-code counts of packed launch rows (see
    nimble_packed_base_counts): rows [0, m) of the C-contiguous 2-D uint8
    ``buf``, the first ``nb`` bytes of each -> (m, 4) int64, the count of
    each 2-bit code among the row's ``nb * 4`` slots.  The same counts as
    ``models.aligner``'s byte-LUT sum.  None when the native library is
    unavailable.  Raises ValueError when ``buf`` is not a C-contiguous 2-D
    uint8 array, when ``nb + 2`` bytes (the codes and the length) overrun
    its rows, or when ``m`` is negative or above its rows."""
    lib = _load()
    if lib is None:
        return None
    if buf.dtype != np.uint8 or buf.ndim != 2 or not buf.flags.c_contiguous:
        raise ValueError("packed_base_counts: buf must be a C-contiguous "
                         "2-D uint8 array")
    if nb < 0 or nb + 2 > buf.shape[1]:
        raise ValueError(f"packed_base_counts: nb={nb} code bytes and the "
                         f"length overrun the {buf.shape[1]}-byte rows")
    if not 0 <= m <= buf.shape[0]:
        raise ValueError(f"packed_base_counts: m={m} rows of a "
                         f"{buf.shape[0]}-row buffer")
    counts = np.empty((m, 4), dtype=np.int64)
    lib.nimble_packed_base_counts(buf.ctypes.data, m, buf.shape[1], nb,
                                  counts.ctypes.data)
    return counts


def orient_decode(offs: np.ndarray, flat: np.ndarray, rev: np.ndarray,
                  W: int, n_threads: int = 4
                  ) -> "tuple[np.ndarray, bytes] | None":
    """Oriented padded code matrix + ASCII decode in one C++ pass (see
    nimble_orient_decode): ragged codes + rev flags -> ((n, W) int8
    oriented matrix, n*W decode bytes).  Byte-identical to the NumPy
    matrix-fill / revcomp-gather / _DECODE_LUT chain it replaces
    (pipeline/bam_fast._prepare_batch).  None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    flat = np.ascontiguousarray(flat, dtype=np.int8)
    rev = np.ascontiguousarray(rev, dtype=np.uint8)
    n = len(offs) - 1
    oriented = np.empty((n, W), dtype=np.int8)
    dec = np.empty(n * W, dtype=np.uint8)
    lib.nimble_orient_decode(
        flat.ctypes.data, offs.ctypes.data, rev.ctypes.data,
        n, W, oriented.ctypes.data, dec.ctypes.data, n_threads)
    return oriented, dec.tobytes()


def take_rows(offs: np.ndarray, flat: np.ndarray,
              idx: np.ndarray) -> "tuple[np.ndarray, np.ndarray] | None":
    """Ragged row gather (see nimble_take_rows): returns (offs_out,
    flat_out) for rows ``idx``, or None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    k = len(idx)
    lens = offs[1:] - offs[:-1]
    offs_out = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(lens[idx], out=offs_out[1:])
    flat_out = np.empty(int(offs_out[-1]), dtype=np.uint8)
    lib.nimble_take_rows(
        np.ascontiguousarray(offs, dtype=np.int64).ctypes.data,
        np.ascontiguousarray(flat, dtype=np.uint8).ctypes.data,
        idx.ctypes.data, k, offs_out.ctypes.data, flat_out.ctypes.data,
    )
    return offs_out, flat_out


def maxinfo_ragged(offs: np.ndarray, flat: np.ndarray,
                   ls: np.ndarray, qp: np.ndarray) -> "np.ndarray | None":
    """Single-pass MAXINFO over a ragged quality column (see
    nimble_maxinfo); returns None when the native library is unavailable.

    ``ls``/``qp`` are the normalized i64 fixed-point tables from
    :func:`nimble_tpu_torch.core.trim._tables`.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(offs) - 1
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    out = np.empty(n, dtype=np.int64)
    lib.nimble_maxinfo(
        n, offs.ctypes.data, flat.ctypes.data,
        ls.ctypes.data, qp.ctypes.data, out.ctypes.data,
    )
    return out


class DedupeSet:
    """Native global read-pair dedupe set; None-like when native is absent.

    Use :func:`make_dedupe_set` which returns None without the native lib.
    """

    def __init__(self, lib):
        self._lib = lib
        self._handle = lib.nimble_dedupe_new()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.nimble_dedupe_free(self._handle)
            self._handle = None

    def __len__(self) -> int:
        return int(self._lib.nimble_dedupe_size(self._handle))

    def insert_batch(
        self,
        flat1: np.ndarray, offsets1: np.ndarray,
        flat2: np.ndarray | None, offsets2: np.ndarray | None,
    ) -> np.ndarray:
        """Insert n pairs (flattened exact-length bytes + n+1 offsets);
        returns a bool mask of which pairs were new."""
        n = len(offsets1) - 1
        out = np.empty(n, dtype=np.uint8)
        flat1 = np.ascontiguousarray(flat1, dtype=np.int8)
        offsets1 = np.ascontiguousarray(offsets1, dtype=np.int64)
        if flat2 is not None:
            flat2 = np.ascontiguousarray(flat2, dtype=np.int8)
            offsets2 = np.ascontiguousarray(offsets2, dtype=np.int64)
            p2, o2 = flat2.ctypes.data, offsets2.ctypes.data
        else:
            p2, o2 = None, None
        self._lib.nimble_dedupe_insert(
            self._handle,
            flat1.ctypes.data, offsets1.ctypes.data,
            p2, o2, n, out.ctypes.data,
        )
        return out.astype(bool)


def make_dedupe_set() -> DedupeSet | None:
    lib = _load()
    return DedupeSet(lib) if lib is not None else None


def build_bucket_table(keys, starts, counts, bkey_lo, bkey_hi,
                       bstart, bcount, width: int) -> int | None:
    """Native bucketized-table insertion; returns max_probe (bucket hops)
    or None when the library is unavailable.  ``bkey_lo``/``bkey_hi`` must
    be pre-filled with the empty sentinel; all four table arrays must be
    C-contiguous (n_buckets, width)."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    for t in (bkey_lo, bkey_hi, bstart, bcount):
        if not t.flags.c_contiguous:  # in-place write contract
            raise ValueError("bucket table arrays must be C-contiguous")
    return int(
        lib.nimble_build_bucket_table(
            keys.ctypes.data, starts.ctypes.data, counts.ctypes.data,
            len(keys),
            bkey_lo.ctypes.data, bkey_hi.ctypes.data,
            bstart.ctypes.data, bcount.ctypes.data,
            bkey_lo.shape[0], int(width),
        )
    )
