"""The engine campaign: every engine of the port against the host oracle on
random libraries biased toward the hard cases.

    python -m nimble_tpu_torch.fuzz.differential [--device cuda|cpu]
        [--walk fused|double|both] [--trials N | --minutes M] [--seed S]
        [--repeat-rate] [--mesh-only] [--child-seed C [--trial T]]

The port of ``scripts/fuzz_differential.py`` (``campaign`` has the options
the three campaigns share).  Each trial draws a library, its reads and a
config (``corpus.draw_differential_trial``) and holds, for each walk of
``--walk``:

- ``align_batch`` of a ``TorchAlignEngine`` (every 11th trial, trial
  number 7 mod 11, a ``TorchMeshAlignEngine`` on the mesh of the process
  group) equal to ``core.calls.HostAlignEngine``'s, read for read;
- the full pass (``full_dispatch`` / ``full_collect``): each read's filter
  reason, score, normalized score and equivalence class (decoded through
  ``rescued`` or ``decode_combo``) equal to the oracle's;
- on ``--device cuda``, the raw (n, 2) compact and (n, 3) full results of
  the card equal bit for bit to the same engine's on the CPU, where the
  walk kernels run their plain versions (single-device trials).

Every 5th trial (trial number 4 mod 5) also plants fingerprint collisions
(:func:`draw_planted`), from a generator of its own seeded with the
trial's child seed and ``PLANTED_STREAM``, so the shared corpus is the JAX
script's: the reads' first k-mer gets a forged fingerprint in an empty
lane of its bucket.  The probe must flag each such read ``needs_host``
(without searching further: a probe that searched on would still agree
with the oracle end to end), the card's raw compact output must equal the
CPU's, and ``align_batch`` the oracle's.

``--repeat-rate`` runs the script's other campaign instead, on the host:
how often the linear walk's equivalence classes differ from a colored de
Bruijn graph's (``cdbg_oracle``) on repeat-heavy libraries, with the
anchors held equal and the load-time repeat detector checked.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from nimble_tpu_torch.config import AlignFilterConfig
from nimble_tpu_torch.core.calls import HostAlignEngine
from nimble_tpu_torch.core.walk import map_read_with_mismatch
from nimble_tpu_torch.fuzz import corpus
from nimble_tpu_torch.fuzz.campaign import (
    Campaign,
    build_parser,
    require,
    run_entry,
)
from nimble_tpu_torch.fuzz.cdbg_oracle import ColoredDbg, cdbg_map_read
from nimble_tpu_torch.index.build import build_index
from nimble_tpu_torch.models.aligner import TorchAlignEngine
from nimble_tpu_torch.models.mesh_aligner import TorchMeshAlignEngine
from nimble_tpu_torch.ops.compact import unpack_compact
from nimble_tpu_torch.ops.device_index import (
    EMPTY_SLOT,
    build_bucketed_index,
    hash_kmer,
    kmer_fp,
)
from nimble_tpu_torch.ops.device_tables import tables_from_bucketed_index
from nimble_tpu_torch.utils.dna import encode_bases, revcomp

MESH_EVERY, MESH_AT = 11, 7        # the JAX script's occasional mesh trial
PLANTED_EVERY, PLANTED_AT = 5, 4   # trials that also plant collisions
PLANTED_STREAM = 1                 # seeds the planted draws with the child's
K = 30


def padded_matrix(reads) -> Tuple[np.ndarray, np.ndarray]:
    """(n, max length) int8 codes, zero past each read's length, and the
    (n,) int32 lengths."""
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    mat = np.zeros((len(reads), max(1, int(lens.max(initial=0)))),
                   dtype=np.int8)
    for i, r in enumerate(reads):
        mat[i, : len(r)] = r
    return mat, lens


def device_results(engine, mat: np.ndarray, lens: np.ndarray):
    """The compact pass's (n, 2) and the full pass's (n, 3) int32 results
    of ``engine`` on the reads of ``mat``, fetched as they came off the
    device (rows that reach no launch stay 0; the full pass's deduped rows
    are spread back over their duplicates)."""
    n = mat.shape[0]
    compact = np.zeros((n, 2), dtype=np.int32)
    full = np.zeros((n, 3), dtype=np.int32)
    state = engine.compact_dispatch(mat, lens)
    for _bucket, sel, _m, out_dev, _buf, _blens in state["launches"]:
        compact[slice(None) if sel is None else sel] = out_dev.cpu().numpy()
    state = engine.full_dispatch(mat, lens, np.ones(n, dtype=bool))
    for sel, _m, out_dev, _buf, _bucket, inv in state["launches"]:
        full[sel] = out_dev.cpu().numpy()[inv]
    return compact, full


def check_full(engine, reads, expected, what: str) -> None:
    """The full pass of ``engine`` on ``reads`` against the oracle's
    ``align_batch`` results (``fuzz_differential.py:149-172``)."""
    mat, lens = padded_matrix(reads)
    n = len(reads)
    res = engine.full_collect(engine.full_dispatch(mat, lens,
                                                   np.ones(n, bool)))
    for i, (alignment, _filt) in enumerate(expected):
        if alignment is None:
            require(res["reason"][i] >= 0, f"{what}: full path filter read "
                    f"{i}: reason {res['reason'][i]}")
            continue
        eq, norm, score = alignment
        require(res["reason"][i] == -1 and res["score"][i] == score
                and res["norm"][i] == norm,
                f"{what}: full path read {i}: reason {res['reason'][i]} "
                f"score {res['score'][i]} norm {res['norm'][i]}, oracle "
                f"score {score} norm {norm}")
        key = int(res["eq_key"][i])
        got_eq = (res["rescued"][key] if key < -1
                  else engine.decode_combo(key >> engine.c_max,
                                           key & ((1 << engine.c_max) - 1)))
        require(list(got_eq) == list(eq),
                f"{what}: full path eq read {i}: {list(got_eq)} != {eq}")


def check_align_batch(engine, reads, expected, what: str) -> None:
    got = engine.align_batch(reads)
    for i, (g, e) in enumerate(zip(got, expected)):
        require(g == e, f"DIVERGENCE {what} read {i}: device={g} host={e}")
    require(len(got) == len(expected), f"{what}: {len(got)} results for "
            f"{len(expected)} reads")


def check_card_vs_cpu(engine, twin, reads, what: str) -> None:
    """The raw compact and full results of ``engine`` (on the card) equal
    to ``twin``'s (the same engine on the CPU) bit for bit."""
    mat, lens = padded_matrix(reads)
    for name, card, cpu in zip(("compact", "full"),
                               device_results(engine, mat, lens),
                               device_results(twin, mat, lens)):
        rows = np.flatnonzero((card != cpu).any(axis=1))
        require(not len(rows), f"{what}: the card's raw {name} results != "
                f"the CPU's at rows {rows[:8].tolist()}: "
                f"{card[rows[:2]].tolist()} vs {cpu[rows[:2]].tolist()}")


@dataclass
class Trial:
    """One trial of the campaign (see :func:`main`'s loop)."""

    campaign: Campaign
    trial: corpus.DifferentialTrial
    mesh: bool
    planted: Optional[np.random.Generator]  # this trial's planted draws
    counts: dict                            # the planted trials' counts

    def build(self):
        c, t = self.campaign, self.trial
        index = build_index(t.doubled)
        if self.mesh:
            return index, [(w, TorchMeshAlignEngine(
                index, t.config, mesh=c.mesh, walk=w)) for w in c.walks]
        return index, [(w, TorchAlignEngine(
            index, t.config, device=c.device, walk=w)) for w in c.walks]

    def drive(self, built) -> int:
        c, t = self.campaign, self.trial
        index, engines = built
        expected = HostAlignEngine(index, t.config).align_batch(t.reads)
        for walk, engine in engines:
            c.where = {"walk": walk, "mesh": self.mesh}
            what = f"{type(engine).__name__} walk={walk}"
            check_align_batch(engine, t.reads, expected, what)
            check_full(engine, t.reads, expected, what)
            if c.device.type == "cuda" and not self.mesh:
                twin = TorchAlignEngine(index, t.config, device="cpu",
                                        walk=walk)
                check_card_vs_cpu(engine, twin, t.reads, what)
        if self.planted is not None:
            self.counts["planted_reads"] += check_planted(c, self.planted)
            self.counts["planted_trials"] += 1
        return len(t.reads)


# --- planted fingerprint collisions ----------------------------------------

def _key_halves(codes):
    hi = lo = 0
    for j in range(15):
        hi = (hi << 2) | int(codes[j])
        lo = (lo << 2) | int(codes[15 + j])
    return (np.array([lo], dtype=np.uint32), np.array([hi], dtype=np.uint32))


def draw_planted(rng, n_reads: int = 48):
    """A random library of 6 x 200 bp, ``n_reads`` reads of 10 random bases
    and 55 library bases, and the index's fingerprint table with a forged
    fingerprint of each read's first k-mer in the first empty lane of its
    bucket (where no lane of the bucket holds that fingerprint already).
    Returns (doubled rows, reads, index, forged fingerprints, planted read
    numbers)."""
    feats = [corpus.rand_seq(rng, 200) for _ in range(6)]
    doubled = [x for f in feats for x in (f, revcomp(f))]
    reads = []
    for i in range(n_reads):
        feat = encode_bases(doubled[int(rng.integers(0, len(doubled)))])
        s = int(rng.integers(0, len(feat) - 55 + 1))
        reads.append(np.concatenate([rng.integers(0, 4, 10).astype(np.int8),
                                     feat[s : s + 55]]))
    index = build_index(doubled)
    bidx = build_bucketed_index(index)
    fp = bidx.bkey_fp.copy()
    empty = (bidx.bkey_lo == EMPTY_SLOT) & (bidx.bkey_hi == EMPTY_SLOT)
    planted = []
    for i, r in enumerate(reads):
        lo, hi = _key_halves(r[:K])
        b = int(hash_kmer(lo, hi)[0]) & (bidx.n_buckets - 1)
        want = kmer_fp(lo, hi)[0]
        lanes = np.flatnonzero(empty[b])
        if (fp[b] == want).any() or not len(lanes):
            continue
        fp[b, lanes[0]] = want
        empty[b, lanes[0]] = False
        planted.append(i)
    return doubled, reads, index, fp, planted


def forge(engine: TorchAlignEngine, fp: np.ndarray) -> TorchAlignEngine:
    """``engine`` with its bucket table's fingerprints replaced by ``fp``."""
    engine.bidx = dataclasses.replace(engine.bidx, bkey_fp=fp)
    engine.tables = tables_from_bucketed_index(engine.bidx, engine.device)
    return engine


def check_planted(campaign: Campaign, rng) -> int:
    """One planted-collision trial; returns the number of forged reads."""
    doubled, reads, index, fp, planted = draw_planted(rng)
    cfg = AlignFilterConfig(reference_genome_size=len(doubled),
                            score_percent=0.3, score_threshold=40,
                            num_mismatches=1, max_hits_to_report=10)
    expected = HostAlignEngine(index, cfg).align_batch(reads)
    mat, lens = padded_matrix(reads)
    for walk in campaign.walks:
        campaign.where = {"walk": walk, "planted": True}
        what = f"planted collisions, walk={walk}"
        engine = forge(TorchAlignEngine(index, cfg, device=campaign.device,
                                        walk=walk), fp)
        compact, _full = device_results(engine, mat, lens)
        flagged = unpack_compact(compact)["needs_host"]
        missed = [i for i in planted if not flagged[i]]
        require(not missed, f"{what}: reads {missed[:8]} with a forged "
                "fingerprint hit are not flagged needs_host")
        if campaign.device.type == "cuda":
            twin = forge(TorchAlignEngine(index, cfg, device="cpu",
                                          walk=walk), fp)
            check_card_vs_cpu(engine, twin, reads, what)
        check_align_batch(engine, reads, expected, what)
    return len(planted)


# --- the repeat-rate campaign (host only) ----------------------------------

def repeat_rate_campaign(rng, minutes: float,
                         trials: Optional[int]) -> dict:
    """How often linear and colored-DBG eq classes differ on repeat-heavy
    libraries (``fuzz_differential.py:175-265``): the documented divergence
    class (``docs/SEMANTICS.md``), so a difference is counted, not a
    failure.  Anchor agreement and the load-time repeat detector's warning
    are required on every read and library.  Runs ``trials`` libraries, or
    for ``minutes``."""
    t_end = time.time() + minutes * 60
    n_libs = n_reads = n_anchored = n_diverged = n_disjoint = 0
    flagged_libs = 0
    while (n_libs < trials) if trials is not None else (time.time() < t_end):
        # repeat-heavy library: tandem units of period 1..12, copy counts
        # chosen so some rows span long reads and some exhaust early
        period = int(rng.integers(1, 13))
        unit = corpus.rand_seq(rng, period)
        feats = [
            unit * int(rng.integers(3, 12)),
            unit * int(rng.integers(2, 6)) + corpus.rand_seq(rng, 40),
            corpus.rand_seq(rng, int(rng.integers(10, 30))) + unit
            * int(rng.integers(2, 8)),
            corpus.rand_seq(rng, 150),
        ]
        doubled = [x for f in feats for x in (f, revcomp(f))]
        if not any(len(f) >= 30 for f in doubled):
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            index = build_index(doubled)
        # detector check: a library whose repeat runs reach k+p MUST warn
        if len(index.repeat_rows):
            flagged_libs += 1
            require(any("tandem" in str(c.message) for c in caught),
                    "repeat rows flagged but no user warning emitted")
        graph = ColoredDbg(doubled)
        for _ in range(30):
            kind = int(rng.integers(0, 3))
            if kind == 0:  # in-phase repeat read
                read = unit * int(rng.integers(4, 20))
            elif kind == 1:  # out-of-phase repeat read
                s = int(rng.integers(0, period))
                read = (unit * int(rng.integers(5, 20)))[s:]
            else:  # repeat + unique tail
                read = unit * int(rng.integers(3, 8)) + corpus.rand_seq(rng,
                                                                        20)
            if len(read) < 30:
                continue
            n_reads += 1
            lin = map_read_with_mismatch(encode_bases(read), index)
            g = cdbg_map_read(read, graph)
            require((lin is None) == (g is None),
                    f"anchor disagreement: {read[:40]}")
            if lin is None:
                continue
            n_anchored += 1
            eq_l, _score_l, _ = lin
            eq_g, _score_g, _ = g
            if list(eq_l) != sorted(eq_g):
                n_diverged += 1
                if not set(eq_l) <= set(eq_g):
                    n_disjoint += 1
        n_libs += 1
        if n_libs % 50 == 0:
            print(f"{n_libs} repeat libraries, {n_anchored} anchored reads, "
                  f"{n_diverged} diverged "
                  f"({100.0*n_diverged/max(1, n_anchored):.1f}%), "
                  f"{n_disjoint} non-subset", flush=True)
    print(
        f"REPEAT-RATE DONE: {n_libs} libraries ({flagged_libs} flagged by "
        f"the detector), {n_reads} reads, {n_anchored} anchored, "
        f"{n_diverged} diverged = "
        f"{100.0*n_diverged/max(1, n_anchored):.2f}% of anchored reads "
        f"({n_disjoint} of those non-subset-shaped; anchor agreement held "
        f"on every read)", flush=True)
    return {"libraries": n_libs, "reads": n_reads, "anchored": n_anchored,
            "diverged": n_diverged, "non_subset": n_disjoint}


# --- the entry -------------------------------------------------------------

def parser():
    p = build_parser("python -m nimble_tpu_torch.fuzz.differential",
                     __doc__.splitlines()[0], default_minutes=30.0)
    p.add_argument("--repeat-rate", action="store_true",
                   help="the repeat-heavy linear-vs-colored-DBG divergence "
                        "prevalence campaign (host only)")
    return p


def _campaign(args, runtime, mesh) -> dict:
    if args.repeat_rate:
        if not runtime.is_controller:
            return {}
        minutes = (args.default_minutes if args.minutes is None
                   else args.minutes)
        return repeat_rate_campaign(np.random.default_rng(args.seed),
                                    minutes, args.trials)
    campaign = Campaign(args, "differential", runtime, mesh)
    planted = {"planted_trials": 0, "planted_reads": 0}

    def draw(trial, child):
        t = corpus.draw_differential_trial(np.random.default_rng(child))
        if t is None:
            return None
        on_mesh = trial % MESH_EVERY == MESH_AT
        plant = not on_mesh and trial % PLANTED_EVERY == PLANTED_AT
        return Trial(campaign, t, on_mesh,
                     np.random.default_rng([child, PLANTED_STREAM])
                     if plant else None, planted)

    summary = campaign.run(draw, block=25, agree="all engines agree")
    if not runtime.is_controller:
        return {}
    summary.extra.update(planted)
    print(f"PLANTED: {planted['planted_trials']} trials, "
          f"{planted['planted_reads']} reads with a forged fingerprint hit, "
          "every one flagged needs_host", flush=True)
    print(f"DONE: {summary.trials} trials, {summary.items} reads, zero "
          "divergences", flush=True)
    return summary.as_dict()


def run(argv=None, runtime=None, mesh=None) -> dict:
    """Run the campaign of ``argv``; returns what it checked (empty on a
    rank other than the controller)."""
    return run_entry(argv, parser(), _campaign, runtime, mesh)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
