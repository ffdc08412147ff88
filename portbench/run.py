"""One run of a benchmark cell of nimble_tpu_torch on the card.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout.  A run makes the cell's inputs from the seed
(library JSON and FASTQ or BAM under ``.portbench/<cell>/``), does the
CLI's set-up (library, index, engine with its tables on the card, kernels
built or loaded, one warm pass), then runs the cell's path from the input
file on disk to the output file, pass after pass, until ``S`` seconds of
passes have run; the last pass ends the window.  Then it checks the output
against the plain reference and prints one JSON line: the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read from
the program's ``NIMBLE_TIMING`` sums and a profiler trace of the window.

The one number compared is ``passes_wrong`` (limit 0): the passes whose
output content differs from the last pass's, and, if the last pass's
output is not the reference's, every pass that wrote the same.  The
path's own comparison of the last output (TSV lines, forensic rows) is
printed beside it on standard error.

``setup_s`` runs from the start of this module to the end of the warm
pass, less the time the harness spends making the inputs.  The window's
time is the sum of the passes' times; the digest of each pass's output
(its content: a gzip header holds a time) is taken between passes,
outside it.  Exits non-zero, printing no result,
without a card (or fewer than the cell asks for), without the program, or
if jax, jaxlib, flax or nimble_tpu were loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / ".portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "nimble_tpu")


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def _cache_env() -> None:
    """Every build and kernel cache in fixed directories of the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(WORK / "cache" / sub)
    os.environ.pop("NIMBLE_TIMING", None)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, device: str | None = None) -> int:
    """``device`` None: the card, required.  Tests pass "cpu", which skips
    the look for a card and runs the rest of a run on the CPU."""
    args = build_parser().parse_args(argv)
    _cache_env()
    from portbench import spec

    bench = spec.benchmark()
    cell = spec.load_cell(args.workload, bench)
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            say(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
                f"device(s); torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}")
            return 3
        device = "cuda"
    try:
        import nimble_tpu_torch  # noqa: F401
    except ImportError as e:
        say(f"portbench: the program is missing: {e}")
        return 4
    cuda = device == "cuda"
    path = spec.path_module(cell["path"])
    work = WORK / cell["name"]
    work.mkdir(parents=True, exist_ok=True)

    t = time.perf_counter()
    inputs = path.make_inputs(cell, args.seed, str(work))
    gen_s = time.perf_counter() - t
    say(f"inputs: {inputs['items']} {path.ITEMS} a pass, made in "
        f"{gen_s:.3f} s")
    with open(os.devnull, "w") as sink:
        state = path.setup(inputs, device)
        with contextlib.redirect_stdout(sink):
            path.run_pass(state, inputs, inputs["output"])  # warm pass
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - _T_START - gen_s
        say(f"setup_s {setup_s:.4f}")
        window = _window(path, state, inputs, args, sink, cuda)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if args.trace:
        window["replay"] = _replay(path, state, inputs, cuda)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    want = path.check(inputs, device)
    say(f"reference: {time.perf_counter() - t:.3f} s")
    diagnostics = path.compare(inputs, inputs["output"], want)
    last_wrong = any(value for _, value in diagnostics)
    # every pass wrote content equal to the last pass's, or differs; the
    # last pass's content is right or wrong as the reference says
    wrong = window["differing"] + (window["passes"] - window["differing"]
                                   if last_wrong else 0)
    for name, value in diagnostics:
        say(f"last pass: {name} {value}")

    found = forbidden_modules()
    if found:
        say(f"portbench: loaded in this process: {', '.join(found)}")
        return 5

    items = window["passes"] * inputs["items"]
    failed = wrong * inputs["items"]
    if args.trace:
        metrics = _per_layer(spec, bench, cell, window, items)
    else:
        metrics = _end_to_end(spec, bench, cell, path, setup_s, window,
                              items)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": wrong == 0, "attempted": items, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = window["busy_s"]
        dev["window_s"] = window["seconds"]
        result["breakdown"] = window["breakdown"]
    result["checks"] = {"passes_wrong": {"value": wrong, "limit": 0}}
    say(f"check passes_wrong {wrong} limit 0")
    print(json.dumps(result), flush=True)
    return 0


def _window(path, state, inputs, args, sink, cuda) -> dict:
    """The passes: until ``args.seconds`` of passes have run."""
    from portbench import hostload, trace

    out = inputs["output"]
    digests, times, host = [], [], []
    stack = contextlib.ExitStack()
    stack.enter_context(contextlib.redirect_stdout(sink))
    label = contextlib.nullcontext
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        os.environ["NIMBLE_TIMING"] = "1"
        captured = stack.enter_context(trace.capture_stderr())
        stack.enter_context(trace.spans(path.SPANS))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = stack.enter_context(profile(activities=acts))
        label = record_function
    with stack:
        while sum(times) < args.seconds:
            before = hostload.sample()
            t = time.perf_counter()
            with label("portbench.pass"):
                path.run_pass(state, inputs, out)
            times.append(time.perf_counter() - t)
            host.append(hostload.between(before, hostload.sample()))
            host[-1]["probe_s"] = hostload.probe_s()
            digests.append(path.digest(out))
    os.environ.pop("NIMBLE_TIMING", None)
    result = {"passes": len(times), "seconds": sum(times),
              "differing": sum(d != digests[-1] for d in digests)}
    say(f"window: {len(times)} passes in {sum(times):.4f} s; pass seconds "
        + " ".join(f"{x:.4f}" for x in times))
    hostload.write(str(WORK / args.workload / "host.tsv"), host)
    say(f"host: {json.dumps(hostload.summary(host))}")
    if args.trace:
        result["timers"] = trace.parse_timing(captured.text())
        say(f"timers: {json.dumps(result['timers'])}")
        trace_path = str(WORK / "trace_window.json")
        prof.export_chrome_trace(trace_path)
        tr = trace.Trace(trace_path)
        result["busy_s"] = tr.busy_s()
        result["trace"] = tr
        passes = tr.spans_named("portbench.pass")
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps(passes)}
    return result


REPLAYS = 5  # replays of a path's launches for its kernel's roofline


def _replay(path, state, inputs, cuda) -> dict:
    """The path's kernel replay, where it has one: one warm replay, then
    ``REPLAYS`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace

    if not hasattr(path, "replay"):
        return {}
    work = path.replay(state, inputs)
    work["run"]()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(REPLAYS):
            work["run"]()
    trace_path = str(WORK / "trace_replay.json")
    prof.export_chrome_trace(trace_path)
    work["trace"] = trace.Trace(trace_path)
    say(f"replay: {work['launches']} launches x {REPLAYS}, "
        f"{work['bytes']} bytes, {work['ops']} ops a replay; device "
        f"{json.dumps(work['trace'].device_ops(3))}")
    return work


def _end_to_end(spec, bench, cell, path, setup_s, window, items) -> dict:
    values = {"setup_s": setup_s, path.RATE: items / window["seconds"]}
    out = {}
    for m in spec.metrics_of(bench, "end_to_end", cell["name"]):
        if m["name"] in values:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def _per_layer(spec, bench, cell, window, items) -> dict:
    ctx = {"items": items, "window_s": window["seconds"],
           "busy_s": window["busy_s"], "timers": window["timers"],
           "trace": window["trace"], "replay": window.get("replay", {})}
    out = {}
    for m in spec.metrics_of(bench, "per_layer", cell["name"]):
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


if __name__ == "__main__":
    sys.exit(main())
