#!/usr/bin/env python3
"""Stress run of the lost-peer test's two-process script under load.

``tests/test_torch_multihost.py::test_lost_peer_raises_within_the_timeout``
starts two processes of ``_LOST_PEER`` (a gloo group whose rank 1 never
joins the barrier); rank 0 must see the barrier raise within the group's
timeout and exit 0.  Under a parallel pytest load rank 0 used to abort at
interpreter exit ("terminate called without an active exception"), about
once in 18-24 runs.  This script runs that pair ``--runs`` times (default
24), one pair at a time, while ``pytest -n 6`` loops over a few of the
port's CPU test files in the background, and counts the runs whose rank 0
did not exit 0 after printing RAISED.  Not a tier-1 test (it takes a few
minutes); run it from the root of a checkout:

    JAX_PLATFORMS=cpu python tests/stress_lost_peer.py [--runs 24] [--tree DIR]

``--tree`` runs another checkout's package and tests (an unpacked parent
commit, to compare).  Prints one line a run and ``ABORTS a of N``; exits 1
when a > 0.
"""

import argparse
import ast
import os
import signal
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LOAD = ["tests/test_torch_compact.py", "tests/test_torch_span_walk.py",
        "tests/test_torch_full.py", "tests/test_torch_probe_walk.py",
        "tests/test_torch_hashing.py"]


def lost_peer_script() -> str:
    """``_LOST_PEER`` of tests/test_torch_multihost.py, read from its source
    (the module imports jax; this script must not need it)."""
    src = open(os.path.join(HERE, "test_torch_multihost.py")).read()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_LOST_PEER" for t in node.targets):
            import textwrap

            return textwrap.dedent(ast.literal_eval(node.value.args[0]))
    raise SystemExit("_LOST_PEER not found in test_torch_multihost.py")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=24)
    ap.add_argument("--tree", default=os.path.dirname(HERE),
                    help="checkout whose package and tests run")
    args = ap.parse_args(argv)
    script = lost_peer_script()
    env = dict(os.environ, PYTHONPATH=args.tree,
               JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    load = subprocess.Popen(
        ["bash", "-c", "while true; do python -m pytest -q -p "
         "no:cacheprovider -n 6 --dist loadfile " + " ".join(LOAD)
         + " >/dev/null 2>&1; done"],
        cwd=args.tree, env=env, start_new_session=True)
    aborts = 0
    try:
        time.sleep(20)  # the load's workers start
        for i in range(args.runs):
            with tempfile.TemporaryDirectory() as d:
                procs = [subprocess.Popen(
                    [sys.executable, "-c", script, str(r),
                     os.path.join(d, "init")],
                    cwd=d, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True) for r in range(2)]
                try:
                    out, err = procs[0].communicate(timeout=150)
                finally:
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                        p.wait()
            ok = procs[0].returncode == 0 and "RAISED" in out
            aborts += not ok
            print(f"run {i}: rc={procs[0].returncode} {out.strip()!r} "
                  f"{err.strip()[-200:]!r}", flush=True)
    finally:
        os.killpg(load.pid, signal.SIGKILL)
        load.wait()
    print(f"ABORTS {aborts} of {args.runs}")
    return 1 if aborts else 0


if __name__ == "__main__":
    sys.exit(main())
