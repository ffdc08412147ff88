"""Everything of a cell, found by name: the cell, configuration and traffic
files, its path module, and the per-layer metric readers.

A cell ``<name>`` is ``cells/<name>.json`` (its configuration, traffic mix,
path and sizes), checked against its entry in ``BENCHMARK.json``; a
configuration ``configs/<name>.json``; a traffic mix ``traffic/<name>.json``;
a path ``paths/<name>.py``; a per-layer metric ``metrics/<name>.py``, whose
``read(ctx)`` returns the metric's value or None.  Later cells, mixes and
metrics are new files: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CELLS = HERE / "cells"


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load_cell(name: str, bench: dict) -> dict:
    """The cell file with its configuration and traffic files inside."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = _json(CELLS / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise SystemExit(f"cells/{name}.json names {key} {cell[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    cell["chips"] = entry["chips"]
    cell["config_file"] = _json(HERE / "configs" / f"{cell['config']}.json")
    cell["traffic_file"] = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_module(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.paths.{name}")


def metric_reader(name: str) -> ModuleType:
    return _module(HERE / "metrics" / f"{name}.py",
                   "portbench_metric_" + name.replace(".", "_"))


def metrics_of(bench: dict, kind: str, cell: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    whose ``workloads`` list it, or all without the key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
