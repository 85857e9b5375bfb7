"""Everything a run needs, found by name.

`BENCHMARK.json` at the checkout's root lists the cells (``workloads``), the
configurations and the metrics. A cell's configuration is
``benchmark/configs/<config>.json``, its traffic mix
``benchmark/traffic/<traffic>.json`` (which names the entry point it
drives, ``benchmark/entries/<entry>.py``), its own parameters, expected
route and correctness limits ``benchmark/workloads/<cell>.json``, and each
metric's reader ``benchmark/metrics/<metric>.py``. Adding any of them is
adding files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One cell: its entry in BENCHMARK.json, its own file, its
    configuration and its traffic mix, with the cell's ``params`` laid over
    the mix's."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    route: dict
    limits: dict

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def cell(name: str, spec: dict | None = None) -> Cell:
    spec = spec or benchmark()
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    own = load_json(BENCH / "workloads" / f"{name}.json")
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    traffic = {**traffic, **own.get("params", {})}
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=load_json(BENCH / "configs" / f"{w['config']}.json"),
                traffic=traffic, route=own.get("route", {}),
                limits=own["limits"])


def metrics(cell_name: str, trace: bool, spec: dict | None = None) -> list[dict]:
    """The metrics a run of this cell reports: with ``trace`` the per-layer
    ones, else the end-to-end ones; a metric with a ``workloads`` list only
    in those cells."""
    spec = spec or benchmark()
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    mod_name = f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module whose ``read(record)`` gives the metric, or None when the
    run holds nothing it can read."""
    return _module("metrics", metric)


def entry(name: str):
    """The module whose ``Entry(cell, seed, device)`` drives an entry point."""
    return _module("entries", name)
