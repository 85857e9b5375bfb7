"""Every configuration, cell, traffic mix, entry point and metric of
BENCHMARK.json is found by its name, and the file keeps to the contract's
shape."""

import json
import re

import pytest

from benchmark.harness import spec
from benchmark.harness.compare import NUMBERS

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found(config):
    assert NAME.match(config["name"])
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    body = spec.load_json(spec.ROOT / config["file"])
    assert body["source"] == config["source"] and len(config["source"]) <= 200
    assert body["taps"] > 0 and body["sample_rate"] == 44100
    assert sum(body["grid"]["az_counts"]) == 710
    assert config["reduced"] == [] and body["assumed"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found(name):
    c = spec.cell(name, BENCH)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert name.startswith(c.config_name + ".") and c.chips == 1
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert c.traffic["loop"] == "closed"
    assert hasattr(spec.entry(c.entry), "Entry")
    assert c.route and set(c.limits) == set(NUMBERS)
    reported = [m for m in spec.metrics(name, False, BENCH)]
    assert {"setup_s"} < {m["name"] for m in reported}
    assert spec.metrics(name, True, BENCH)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.reader(metric["name"]).read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        moved = e2e[metric["moves"]].get("workloads", CELLS)
        assert set(metric["workloads"]) <= set(moved)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"entry points", "direction lookup", "route rules",
                      "kernels", "build", "device"}


def test_every_config_used_and_pairs_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
