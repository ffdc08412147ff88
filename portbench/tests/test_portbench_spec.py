"""Every cell, configuration, traffic mix and metric loads by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    loaded = spec.load_cell(cell, BENCH)
    assert loaded["config_file"]["name"] == loaded["config"]
    assert loaded["traffic_file"]["name"] == loaded["traffic"]
    path = spec.path_module(loaded["path"])
    for attr in ("ITEMS", "RATE", "SPANS", "make_inputs", "setup",
                 "run_pass", "check", "compare", "write_output", "digest"):
        assert hasattr(path, attr), attr
    rates = {m["name"] for m in spec.metrics_of(BENCH, "end_to_end", cell)}
    assert rates == {"setup_s", path.RATE}
    assert spec.metrics_of(BENCH, "per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_file_is_its_own(config):
    with open(spec.ROOT / config["file"]) as f:
        body = json.load(f)
    assert body["name"] == config["name"]
    assert config["file"].startswith("portbench/configs/")
    assert body["assumed"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", [cell])
    assert len(json.dumps(BENCH)) < 64 * 1024
