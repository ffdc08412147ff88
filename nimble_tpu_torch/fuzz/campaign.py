"""What the three campaigns share: the command line, the device check, the
schedule of trials, the budget, the reproducer, and the ranks of a mesh.

Every entry takes::

    --device cuda|cpu   the engines' device (default cuda; no card: exit
                        non-zero, never a CPU fallback)
    --walk fused|double|both
                        the walk kernels whose engines run (default both)
    --trials N | --minutes M
                        the budget: N trials, or M minutes (the default)
    --seed S            the top-level seed of the trials' child seeds
    --child-seed C [--trial T]
                        one trial, of child seed C at trial number T
    --mesh-only         only the trials that run on the mesh (the engine
                        and FASTQ campaigns)
    --init-method URL   the process group's rendezvous (default env://)

**Trials.**  A generator seeded with ``--seed`` draws one child seed per
trial, as the JAX package's campaign scripts do, and the trial draws its
corpus from its child seed (``corpus.draw_*_trial``).  The first trial
that diverges, or raises, prints its trial number, child seed, top-level
seed, walk and device, and the exception propagates: the process exits
non-zero.  Nothing here catches a failure for good.

**The mesh.**  Some trials run a ``TorchMeshAlignEngine`` on the mesh of
every rank of the process group (``parallel.mesh.mesh_shape(world)``; one
process: a (1, 1) mesh, which delegates to ``TorchAlignEngine``).  Under
``torchrun`` every rank runs the same seeded schedule and draws every
trial, so every rank knows which trials are mesh trials.  Rank 0, the
controller, runs the whole campaign; before each mesh trial it broadcasts
"a mesh trial follows", and at its end "the campaign is over".  For a mesh
trial every rank builds the trial's engines in the same order, the
controller drives the trial while the other ranks serve
(``Runtime.serve``, every launch through ``Runtime.run``), and then every
rank releases the targets the trial registered, which would otherwise keep
each trial's tables on the device.
"""

from __future__ import annotations

import argparse
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nimble_tpu_torch.ops.compact import WALKS
from nimble_tpu_torch.parallel.mesh import Mesh, init_runtime, mesh_shape


class Divergence(AssertionError):
    """An engine's output differs from what it is held to."""


def require(ok, message: str) -> None:
    """Raise :class:`Divergence` with ``message`` unless ``ok``."""
    if not ok:
        raise Divergence(message)


def build_parser(prog: str, description: str, default_minutes: float,
                 mesh_trials: bool = True) -> argparse.ArgumentParser:
    """The shared options; ``--mesh-only`` only for a campaign that has
    mesh trials."""
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the engines (default cuda)")
    p.add_argument("--walk", choices=WALKS + ("both",), default="both",
                   help="walk kernel of the engines: fused, double or both "
                        "(default)")
    budget = p.add_mutually_exclusive_group()
    budget.add_argument("--trials", type=int, default=None,
                        help="run this many trials")
    budget.add_argument("--minutes", type=float, default=None,
                        help=f"run trials for this long (default "
                             f"{default_minutes:g})")
    p.add_argument("--seed", type=int, default=0,
                   help="top-level seed of the trials' child seeds")
    p.add_argument("--child-seed", type=int, default=None,
                   help="run the one trial of this child seed")
    p.add_argument("--trial", type=int, default=0,
                   help="the trial number of --child-seed")
    if mesh_trials:
        p.add_argument("--mesh-only", action="store_true",
                       help="run only the trials that run on the mesh")
    else:
        p.set_defaults(mesh_only=False)
    p.add_argument("--init-method", default=None,
                   help="torch.distributed init method of a multi-rank run "
                        "(default env://, as torchrun sets it)")
    p.set_defaults(default_minutes=default_minutes)
    return p


def check_device(args) -> None:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda was requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU")


@dataclass
class Summary:
    """What a campaign checked, for its DONE line and its callers."""

    campaign: str
    trials: int = 0
    items: int = 0            # reads, or BAM records
    seconds: float = 0.0
    extra: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"campaign": self.campaign, "trials": self.trials,
                "items": self.items, "divergences": 0,
                "seconds": self.seconds, **self.extra}


class Campaign:
    """One run of a campaign in this process: its schedule of trials, its
    budget and its part in the mesh trials (see the module docstring).

    ``where`` names what a failing trial was running (its walk, and what a
    campaign adds) for the reproducer line."""

    def __init__(self, args, name: str, runtime, mesh: Mesh):
        self.args, self.name = args, name
        self.runtime, self.mesh = runtime, mesh
        self.device = runtime.device
        self.walks = WALKS if args.walk == "both" else (args.walk,)
        self.where: dict = {}

    @property
    def controller(self) -> bool:
        return self.runtime.is_controller

    def schedule(self) -> Iterator[Tuple[int, int]]:
        """(trial number, child seed) of every trial, in order."""
        if self.args.child_seed is not None:
            yield self.args.trial, self.args.child_seed
            return
        rng = np.random.default_rng(self.args.seed)
        for trial in itertools.count():
            yield trial, int(rng.integers(0, 2**63 - 1))

    def _flag(self, go: bool) -> bool:
        """The controller tells the other ranks whether a mesh trial
        follows; they wait for it.  Returns the flag."""
        if self.runtime.world_size == 1:
            return go
        t = torch.tensor([int(go)], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.runtime.control)
        return bool(t.item())

    def mesh_trial(self, build: Callable, drive: Optional[Callable]):
        """``build()`` on every rank, then ``drive(built)`` on the
        controller while the other ranks serve; every rank then releases
        the targets that ``build`` registered."""
        targets = self.runtime.targets
        first = len(targets)
        built = build()
        try:
            if self.controller:
                return drive(built)
            self.runtime.serve()
            return None
        finally:
            if self.controller:
                self.runtime.stop()
            for i in range(first, len(targets)):
                targets[i] = None

    def run(self, draw: Callable, *, block: int, agree: str,
            unit: str = "reads") -> Summary:
        """The campaign's loop.  ``draw(trial, child)`` returns the trial,
        or None for one the JAX script skips (a library with no k-mer); it
        runs on every rank.  A trial has ``mesh``, ``build()`` (its
        engines) and ``drive(built)`` (the check, on the controller; returns
        the reads or records checked).  Prints a progress line every
        ``block`` trials."""
        if not self.controller:
            self._serve_trials(draw)
            return Summary(self.name)
        args = self.args
        minutes = (args.default_minutes if args.minutes is None
                   else args.minutes)
        t0 = time.monotonic()
        summary = Summary(self.name)
        try:
            for trial, child in self.schedule():
                if args.trials is not None and summary.trials >= args.trials:
                    break
                if args.trials is None and args.child_seed is None and (
                        time.monotonic() - t0 >= minutes * 60):
                    break
                self.where = {"walk": args.walk}
                try:
                    spec = draw(trial, child)
                    on_mesh = spec is not None and spec.mesh
                    if args.mesh_only and not on_mesh:
                        continue
                    if spec is None:
                        n = 0
                    elif on_mesh:
                        self._flag(True)
                        n = self.mesh_trial(spec.build, spec.drive)
                    else:
                        n = spec.drive(spec.build())
                except Exception:
                    print(self.reproducer(trial, child), flush=True)
                    raise
                summary.trials += 1
                summary.items += n
                if summary.trials % block == 0:
                    print(f"{summary.trials} trials, {summary.items} {unit}, "
                          f"{agree}", flush=True)
        finally:
            self._flag(False)
        summary.seconds = time.monotonic() - t0
        return summary

    def _serve_trials(self, draw: Callable) -> None:
        """A rank other than the controller: the mesh trials of the same
        schedule, until the controller's end flag."""
        for trial, child in self.schedule():
            spec = draw(trial, child)
            if spec is None or not spec.mesh:
                continue
            if not self._flag(False):
                return
            self.mesh_trial(spec.build, None)
        self._flag(False)

    def reproducer(self, trial: int, child: int) -> str:
        a = self.args
        where = " ".join(f"{k}={v}" for k, v in self.where.items())
        module = f"nimble_tpu_torch.fuzz.{self.name}"
        return (f"FAILED at trial {trial} child_seed={child} seed={a.seed} "
                f"{where} device={a.device}; reproduce: python -m {module} "
                f"--device {a.device} --walk {a.walk} --child-seed {child} "
                f"--trial {trial} (or --seed {a.seed} --trials {trial + 1})")


def run_entry(argv, parser: argparse.ArgumentParser, body: Callable,
              runtime=None, mesh: Optional[Mesh] = None) -> Summary:
    """Parse ``argv``, check the device, join the process group (or use
    ``runtime`` and ``mesh``, as a caller that runs several jobs on one
    group does) and run ``body(args, runtime, mesh)``.  The serving ranks
    leave the campaign on its end flag, not inside ``serve``, so the group
    is closed without a STOP."""
    args = parser.parse_args(argv)
    check_device(args)
    own = runtime is None
    if own:
        runtime = init_runtime(args.device,
                               init_method=args.init_method or "env://")
    try:
        if mesh is None:
            mesh = Mesh(runtime, *mesh_shape(runtime.world_size))
        return body(args, runtime, mesh)
    finally:
        if own:
            runtime.close(ok=False)
