"""Single-pass multi-library execution on a torch device.

Counterpart of ``nimble_tpu.models.multi_aligner.MultiLibraryDispatcher``:
every library's bucketed table, rebuilt at one common bucket count, is
stacked on a leading library axis (``ops.device_tables.stack_tables``) with
its filter gates and s_min table, and one upload, one device pass per
``launch_batch`` slice (one walk-kernel launch for all libraries) and one
fetch serve every library per chunk.  Each library's results come back in
its own engine's combo-id space (``astart`` indexes that library's
postings), so ``FastCounter`` and the BAM path's host tail decode them with
that library's engine, unchanged.

Dispatch and collect run on different host threads in the
pipelines: dispatch records its CUDA stream and collect waits on it.

With ``mesh=`` (a ``parallel.mesh.Mesh``; built through
``models.mesh_aligner.stacked_dispatcher``) the pass is data-parallel, as
``MultiLibraryDispatcher(mesh=...)`` is: every rank of the mesh holds the
stacked tables, every launch is split over all of them, and the controller
gathers the rows.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from nimble_tpu_torch.config import AlignFilterConfig
from nimble_tpu_torch.models.aligner import (
    BucketedDispatch,
    TorchAlignEngine,
    entropy_pass_packed,
)
from nimble_tpu_torch.ops.compact import (
    probe_walk_filter_multi,
    unpack_compact,
)
from nimble_tpu_torch.ops.device_tables import stack_tables
from nimble_tpu_torch.ops.full import probe_walk_full_multi
from nimble_tpu_torch.parallel.mesh import pad_rows
from nimble_tpu_torch.utils.metrics import count, span


def uniform_trim(configs: Sequence[AlignFilterConfig]) -> bool:
    """True when every library shares its trim settings: the BAM path's
    packed rows depend on the trimmed lengths, so one upload serves all
    libraries only then."""
    c0 = configs[0]
    return all(c.trim_target_length == c0.trim_target_length
               and c.trim_strictness == c0.trim_strictness for c in configs)


class TorchMultiLibraryDispatcher(BucketedDispatch):
    """One stacked device pass per chunk serving every library's engine.

    The engines must be :class:`TorchAlignEngine` instances that agree on
    ``c_max``, ``buckets``, ``launch_batch``, ``walk`` and ``device``;
    otherwise construction raises ``ValueError`` (the pipelines then launch
    each engine alone, as the JAX package does on incompatible geometry).
    With ``mesh``, each launch of ``launch_batch`` reads per rank runs over
    the mesh (see the module docstring).
    """

    def __init__(self, engines: Sequence[TorchAlignEngine], *, mesh=None):
        if not engines:
            raise ValueError("TorchMultiLibraryDispatcher needs >= 1 engine")
        if not all(isinstance(e, TorchAlignEngine) for e in engines):
            raise ValueError("TorchMultiLibraryDispatcher requires "
                             "TorchAlignEngine instances")
        e0 = engines[0]
        for attr in ("c_max", "buckets", "launch_batch", "walk", "device"):
            if any(getattr(e, attr) != getattr(e0, attr) for e in engines):
                raise ValueError(f"the engines disagree on {attr}")
        self.engines = list(engines)
        self.c_max = e0.c_max
        self.buckets = e0.buckets
        self.launch_batch = e0.launch_batch
        self.walk = e0.walk
        self.device = e0.device
        with span("multilib.stack"):
            self.tables = stack_tables([e.index for e in engines],
                                       [e.bidx for e in engines],
                                       [e.config for e in engines],
                                       self.device)
        # one pre-upload dedupe set for every library: the key is the
        # read(+mate) bytes, which do not depend on the library
        from nimble_tpu_torch import native

        self._seen = native.make_dedupe_set()
        self.mesh = mesh
        if mesh is not None:
            self.target_id = mesh.runtime.register(self)

    @property
    def uniform_trim(self) -> bool:
        return uniform_trim([e.config for e in self.engines])

    def dedupe(self, mat, lens, mate_mat=None, mate_lens=None):
        """Drop already-seen read(+mate) pairs before upload (shared by all
        libraries).  Returns (mat, lens, mate_mat, mate_lens, prededuped)."""
        from nimble_tpu_torch.core.fast_count import dedupe_admit

        return dedupe_admit(self._seen, mat, lens, mate_mat, mate_lens)

    def _device_pass(self, bucket: int, full: bool):
        run = probe_walk_full_multi if full else probe_walk_filter_multi
        return functools.partial(run, st=self.tables, bucket=bucket,
                                 c_max=self.c_max, walk=self.walk)

    def _launch(self, buf: np.ndarray, bucket: int, *,
                full: bool = False):
        # every row of a stacked launch serves all libraries: counted once
        count("bam.rows_stacked" if full else "fastq.rows_stacked",
              buf.shape[0])
        if self.mesh is None:
            return super()._launch(buf, bucket, full=full)
        n = len(self.mesh.ranks)
        lb = self.launch_batch * n
        outs = []
        for i in range(0, buf.shape[0], lb):
            part = buf[i : i + lb]
            raw = self.mesh.runtime.run(self.mesh, self, int(full), bucket,
                                        pad_rows(part, n))
            outs.append(raw[:, : part.shape[0]])
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def mesh_op(self, op: int, bucket: int, n_rows: int, payload):
        """Every rank of the mesh: the stacked pass (``op`` 1: full, 0:
        compact) over its share of the rows; returns the gathered (L,
        n_rows, k) result on the controller, None elsewhere."""
        mesh = self.mesh
        rows = mesh.broadcast_rows(payload, n_rows, (bucket + 3) // 4 + 2)
        out = self._device_pass(bucket, bool(op))(
            mesh.share(rows, len(mesh.ranks), mesh.runtime.rank).to(
                self.device))
        return mesh.gather_rows(out, dim=1, every_rank=True)

    def dispatch(self, mat: np.ndarray, lens: np.ndarray):
        """Pack, upload and launch one chunk for every library (async);
        returns an opaque state for :meth:`collect`."""
        return self.compact_dispatch(mat, lens)

    def collect(self, state) -> List[dict]:
        """One fetch per bucket; per-library compact raw dicts (the
        ``FastCounter`` format), the entropy gate computed once per
        bucket.  Each library's unpack and merge of a launch is the span
        ``fastq.collect.library``."""
        self._wait(state)
        n = state["n"]
        outs = [{"astart": np.zeros(n, dtype=np.int64),
                 "mask": np.zeros(n, dtype=np.int32),
                 "passed": np.zeros(n, dtype=bool),
                 "needs_host": state["needs_host"].copy()}
                for _ in self.engines]
        for bucket, sel, m, out_dev, buf, blens in state["launches"]:
            raw = out_dev.cpu().numpy()                    # (L, m, 2)
            with span("fastq.collect.entropy", items=m):
                ent_ok = entropy_pass_packed(buf, m, blens, (bucket + 3) // 4)
            rows = slice(None) if sel is None else sel
            for dst, lib_raw in zip(outs, raw):
                with span("fastq.collect.library", items=m):
                    out = unpack_compact(lib_raw)
                    dst["astart"][rows] = out["astart"]
                    dst["mask"][rows] = out["mask"]
                    dst["passed"][rows] = out["passed"] & ent_ok
                    dst["needs_host"][rows] = out["needs_host"] & ent_ok
        return outs

    def full_dispatch(self, mat: np.ndarray, lens: np.ndarray,
                      active: np.ndarray):
        """One stacked full-output pass for every library (the BAM
        consumer's batch); the packed rows are deduped once for all.
        Requires :attr:`uniform_trim`."""
        if not self.uniform_trim:
            raise ValueError("full_dispatch requires uniform trim settings")
        return super().full_dispatch(mat, lens, active)

    def full_collect(self, state) -> List[dict]:
        """One fetch and one entropy gate per launch (``fetch_full``);
        each library's results through its own engine's exact host gates
        (``full_collect_library`` on that library's slice), each the span
        ``bam.collect.library``."""
        fetched = self.fetch_full(state)
        rows = sum(f[1] for f in fetched)
        results = []
        for li, engine in enumerate(self.engines):
            lib = [(sel, m, raw[li], inv, sub_lens, low_ent)
                   for sel, m, raw, inv, sub_lens, low_ent in fetched]
            with span("bam.collect.library", items=rows):
                results.append(engine.full_collect_library(state, lib))
        return results
