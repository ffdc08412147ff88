"""The check's control: the reference put in the program's place with one
guarantee of the configuration broken, which the check has to fail.

    python3 -m portbench.control --workload CELL --seeds 1,2,3 [--device cpu]

A configuration states ``num_mismatches``: a read whose walk meets more
mismatches is not called.  The control is the reference run allowing one
mismatch more than the configuration states, its output written where the
program's would be and compared with the reference's by the cell's own
numbers.  It prints the
readings of each seed, one JSON line each; no program runs.  The
benchmark's runs never run it: it sets the upper readings of the limits
(PERF.md), and the tests hold it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time



def control(cell: dict) -> dict:
    """The overrides of the control: one mismatch more than stated."""
    return {"num_mismatches":
            cell["config_file"]["library"][0]["num_mismatches"] + 1}


def readings(cell: dict, seed: int, device: str, work: str) -> dict:
    """The control's ``passes_wrong`` (its one output, right or wrong) and
    the path's comparison of it, for one seed of the cell."""
    from portbench import spec

    path = spec.path_module(cell["path"])
    inputs = path.make_inputs(cell, seed, work)
    want = path.check(inputs, device)
    broken = path.check(inputs, device, control(cell))
    path.write_output(broken, inputs["output"])
    got = dict(path.compare(inputs, inputs["output"], want))
    return {"passes_wrong": int(any(got.values())), **got}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import run, spec

    run._cache_env()
    cell = spec.load_cell(args.workload, spec.benchmark())
    work = run.WORK / f"{cell['name']}.control"
    work.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(cell, seed, args.device, str(work))
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
