"""The bucketed k-mer index and the filter scalars as torch tensors.

Counterpart of ``DeviceAlignEngine.__init__``'s ``_dev_fast`` /
``_dev_scalars`` and ``DeviceAlignEngine._s_min_table``.  The tables are the
very numpy arrays of ``ops.device_index.build_bucketed_index``,
moved to an explicit device.  uint32 arrays (key halves, fingerprints,
packed reference words) are stored as int32 bit patterns: equality compares
and the CUDA kernel's ``uint32_t`` view need no conversion, and the tables
keep the JAX engine's byte size.

Several libraries stack along a leading library axis (:func:`stack_tables`,
the counterpart of ``MultiLibraryDispatcher.__init__``): the device passes
then take a per-row library index and read every table through
:func:`take`.  A mesh rank holds one model shard of a table split by key
hash (:func:`tables_from_sharded_index`, the per-shard slice of
``sharded_fast.sharded_device_arrays``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from nimble_tpu_torch.config import AlignFilterConfig
from nimble_tpu_torch.index.build import KmerIndex
from nimble_tpu_torch.ops.device_index import (
    BucketedDeviceIndex,
    build_bucketed_index,
)

_TABLE_FIELDS = (
    "bkey_lo", "bkey_hi", "bkey_fp", "bstart", "bcount",
    "postings_row", "postings_off", "ref_codes_packed",
    "row_starts", "row_lengths",
)


@dataclass(frozen=True)
class IndexTables:
    """Device-resident bucketed index (shapes as in BucketedDeviceIndex)."""

    k: int
    width: int
    max_probe: int
    bucket_mask: int
    ref_pad: int
    bkey_lo: torch.Tensor          # (n_buckets, width) int32 bits of uint32
    bkey_hi: torch.Tensor
    bkey_fp: torch.Tensor
    bstart: torch.Tensor           # (n_buckets, width) int32
    bcount: torch.Tensor
    postings_row: torch.Tensor     # (n_postings,) int32
    postings_off: torch.Tensor
    ref_codes_packed: torch.Tensor  # (n_words,) int32 bits of uint32
    row_starts: torch.Tensor       # (n_rows,) int32
    row_lengths: torch.Tensor

    @cached_property
    def layout(self) -> "TableLayout":
        """The tables checked, on first use only (they are frozen): one
        library's, or stacked on a leading library axis; int32, contiguous,
        consistent shapes, all on ``bkey_fp``'s device, a power-of-two
        bucket count.  Raises ValueError, and keeps nothing, otherwise."""
        return _check_layout(self)


@dataclass(frozen=True)
class TableLayout:
    """A tables object's checked geometry (:attr:`IndexTables.layout`), and
    the kernels' argument blocks built from it (``ops.probe_walk``), which
    live and die with the tables."""

    device: torch.device
    stacked: bool
    n_libraries: int  # 1 for one library's tables
    n_buckets: int
    lanes: int        # W, the lanes of a bucket row
    blocks: dict = field(default_factory=dict, repr=False, compare=False)


def check_tensor(name, x, shape, dtype, device) -> None:
    """Raises ValueError unless ``x`` is a contiguous ``shape`` tensor of
    ``dtype`` on ``device``."""
    if tuple(x.shape) != shape or x.dtype != dtype:
        raise ValueError(f"{name}: expected {shape} {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, bkey_fp on {device}")


def _check_layout(t: IndexTables) -> TableLayout:
    if t.bkey_fp.dim() not in (2, 3):
        raise ValueError(f"bkey_fp: {tuple(t.bkey_fp.shape)}, want (n_buckets,"
                         " W) or stacked (L, n_buckets, W)")
    stacked = t.bkey_fp.dim() == 3
    lead = (t.bkey_fp.shape[0],) if stacked else ()
    n_buckets, W = t.bkey_fp.shape[-2:]
    if n_buckets != t.bucket_mask + 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"{n_buckets} buckets: want a power of two, "
                         f"bucket_mask + 1 = {t.bucket_mask + 1}")
    extent = {name: lead + (getattr(t, name).shape[-1],) for name in (
        "postings_row", "ref_codes_packed", "row_starts")}
    for name in _TABLE_FIELDS:
        shape = (lead + (n_buckets, W) if name.startswith("b") else
                 extent[{"postings_off": "postings_row",
                         "row_lengths": "row_starts"}.get(name, name)])
        check_tensor(name, getattr(t, name), shape, torch.int32,
                     t.bkey_fp.device)
    return TableLayout(device=t.bkey_fp.device, stacked=stacked,
                       n_libraries=lead[0] if stacked else 1,
                       n_buckets=n_buckets, lanes=W)


def _to_i32(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a.astype(np.int32, copy=False)


def tables_from_bucketed_index(bidx: BucketedDeviceIndex,
                               device) -> IndexTables:
    """Move the arrays of ``build_bucketed_index(index)`` to ``device``."""
    device = torch.device(device)
    arrays = {
        f: torch.from_numpy(_to_i32(getattr(bidx, f))).to(device)
        for f in _TABLE_FIELDS
    }
    return IndexTables(
        k=int(bidx.k), width=int(bidx.width), max_probe=int(bidx.max_probe),
        bucket_mask=int(bidx.n_buckets) - 1, ref_pad=int(bidx.ref_pad),
        **arrays,
    )


def tables_from_sharded_index(sbidx, shard: int, device) -> IndexTables:
    """One model shard's tables of a ``parallel.sharded_index.
    ShardedBucketedIndex`` on ``device``: its sub-table and its shard-local
    postings, with the replicated reference words and row spans, so the
    probe and both walks run on a shard unchanged."""
    device = torch.device(device)
    arrays = {}
    for f in _TABLE_FIELDS:
        a = getattr(sbidx, f)
        if f not in ("ref_codes_packed", "row_starts", "row_lengths"):
            a = a[shard]
        arrays[f] = torch.from_numpy(_to_i32(a)).to(device)
    return IndexTables(
        k=int(sbidx.k), width=int(sbidx.width),
        max_probe=int(sbidx.max_probe),
        bucket_mask=int(sbidx.n_buckets) - 1, ref_pad=int(sbidx.ref_pad),
        **arrays,
    )


def take(table: torch.Tensor, lib: Optional[torch.Tensor], *idx):
    """``table[idx]`` from one library's table (``lib`` None), or
    ``table[lib, idx]`` from a stacked ``(L, ...)`` table, with each row's
    library index ``lib`` broadcast over the trailing dimensions of
    ``idx``."""
    if lib is None:
        return table[idx]
    lead = lib.reshape(lib.shape + (1,) * (idx[0].dim() - lib.dim()))
    return table[(lead,) + idx]


@dataclass(frozen=True)
class FilterScalars:
    """The four integer gates the device applies (the entropy and length
    gates stay on the host): Python values for one library, or ``(L,)``
    tensors for stacked libraries (:meth:`stack`)."""

    score_threshold: int
    num_mismatches: int
    discard_multiple: bool
    discard_nonzero: bool

    @classmethod
    def from_config(cls, config: AlignFilterConfig) -> "FilterScalars":
        return cls(
            score_threshold=int(config.score_threshold),
            num_mismatches=int(config.num_mismatches),
            discard_multiple=bool(config.discard_multiple_matches),
            discard_nonzero=bool(config.discard_nonzero_mismatch),
        )

    @classmethod
    def stack(cls, configs: Sequence[AlignFilterConfig],
              device) -> "FilterScalars":
        """One ``(L,)`` tensor per gate, library ``i`` from ``configs[i]``."""
        one = [cls.from_config(c) for c in configs]

        def col(name, dtype):
            return torch.tensor([getattr(s, name) for s in one], dtype=dtype,
                                device=device)

        return cls(
            score_threshold=col("score_threshold", torch.int32),
            num_mismatches=col("num_mismatches", torch.int32),
            discard_multiple=col("discard_multiple", torch.bool),
            discard_nonzero=col("discard_nonzero", torch.bool),
        )


@dataclass(frozen=True)
class StackedTables(IndexTables):
    """Several libraries' tables on a leading library axis, at one common
    bucket count; each array is padded to the largest library's extent
    (``bkey_lo`` / ``bkey_hi`` with 0xFFFFFFFF, everything else with 0), as
    ``MultiLibraryDispatcher`` pads them.  ``max_probe`` is the largest of
    the libraries'; ``scalars`` holds the per-library gates."""

    n_libraries: int
    scalars: FilterScalars
    score_percents: tuple
    _s_min: dict = field(default_factory=dict, repr=False, compare=False)

    def s_min(self, bucket: int) -> torch.Tensor:
        """The ``(L, bucket + 1)`` stack of :func:`s_min_table`, one row per
        library (built once per bucket)."""
        t = self._s_min.get(bucket)
        if t is None:
            t = torch.from_numpy(np.stack(
                [s_min_table(p, bucket) for p in self.score_percents])
            ).to(self.bkey_lo.device)
            self._s_min[bucket] = t
        return t


def stack_tables(indexes: Sequence[KmerIndex],
                 bidxs: Sequence[BucketedDeviceIndex],
                 configs: Sequence[AlignFilterConfig],
                 device) -> StackedTables:
    """Stack several libraries' bucketed tables on ``device``.

    ``bidxs[i]`` is ``build_bucketed_index(indexes[i])``.  A library with
    fewer buckets than the largest is rebuilt at that count
    (``min_buckets``); a build at a library's own count is the table it
    has.  Raises ``ValueError`` when the libraries disagree on ``k`` or
    ``ref_pad``, or when a rebuild changed the postings order, in which the
    combo ids (``astart``) of each library's results are read.
    """
    if not indexes or not len(indexes) == len(bidxs) == len(configs):
        raise ValueError("stack_tables needs one table and one config per "
                         "library, >= 1")
    built = list(bidxs)
    n_buckets = max(b.n_buckets for b in built)
    rebuilt = [b if b.n_buckets == n_buckets
               else build_bucketed_index(ix, min_buckets=n_buckets)
               for b, ix in zip(built, indexes)]
    b0 = rebuilt[0]
    if not all(b.k == b0.k and b.ref_pad == b0.ref_pad for b in rebuilt):
        raise ValueError("the libraries' tables disagree on k / ref_pad")
    for b, r in zip(built, rebuilt):
        if not np.array_equal(b.postings_row, r.postings_row):
            raise ValueError("the postings order changed under the bucket "
                             "count override; combo ids would not decode")
    device = torch.device(device)

    def stack(name):
        arrs = [_to_i32(getattr(b, name)) for b in rebuilt]
        shape = tuple(max(a.shape[d] for a in arrs)
                      for d in range(arrs[0].ndim))
        pad = -1 if name in ("bkey_lo", "bkey_hi") else 0  # 0xFFFFFFFF bits
        out = np.full((len(arrs),) + shape, pad, dtype=np.int32)
        for i, a in enumerate(arrs):
            out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
        return torch.from_numpy(out).to(device)

    return StackedTables(
        k=int(b0.k), width=max(int(b.width) for b in rebuilt),
        max_probe=max(int(b.max_probe) for b in rebuilt),
        bucket_mask=n_buckets - 1, ref_pad=int(b0.ref_pad),
        **{f: stack(f) for f in _TABLE_FIELDS},
        n_libraries=len(rebuilt),
        scalars=FilterScalars.stack(configs, device),
        score_percents=tuple(float(c.score_percent) for c in configs),
    )


def s_min_table(score_percent: float, lmax: int) -> np.ndarray:
    """Exact integer threshold table for the normalized-score gate.

    s_min[L] = the least integer s with (s / L) >= score_percent under f64,
    the expression the reference evaluates per read, so the device compare
    ``score >= s_min[len]`` is the same gate.  s_min[0] never passes.
    """
    p = float(score_percent)
    table = np.zeros(lmax + 1, dtype=np.int32)
    for L in range(1, lmax + 1):
        s = max(0, min(int(np.ceil(p * L)), L + 1))
        while s > 0 and (s - 1) / L >= p:
            s -= 1
        while s <= L and s / L < p:
            s += 1
        table[L] = s
    table[0] = np.int32(2**31 - 1)
    return table
