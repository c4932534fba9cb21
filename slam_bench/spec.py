"""What a run is made of, found by name: the cell, its configuration, its
traffic mix and its per-layer metrics.

``BENCHMARK.json`` at the root of the checkout names every cell (``workloads``)
with its configuration and traffic; a configuration is the JSON file its entry
names, a traffic mix is ``traffic/<name>.json``, and a per-layer metric is the
reader ``metrics/<name>.py`` (its ``read(t)`` returns the value from the
traced run's record ``t``, which ``run.py`` builds: counts, per-frame
times, the tracer and its spans; or None where the run has nothing to
read). Adding a cell, a configuration, a traffic
mix or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
READER_KEYS = ("NAME", "UNIT", "BETTER", "LAYER", "SOURCE", "MOVES", "WORKLOADS")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # (entry, reader module) of the cell's per-layer metrics
    chips: int


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "traffic", f"{name}.json")


def metric_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "metrics", f"{name}.py")


def load_reader(name: str, here: str = HERE):
    """The reader module of per-layer metric ``name``."""
    path = metric_path(name, here)
    mod_name = "slam_bench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: dict | None = None, root: str = ROOT, here: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration and traffic
    loaded, its end-to-end metrics, its per-layer metrics with their readers
    (those whose ``workloads`` list it, or all that move one of its
    end-to-end metrics where a metric lists none)."""
    bench = bench if bench is not None else load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(traffic_path(w["traffic"], here))
    e2e = [m for m in bench["end_to_end"] if _in(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        listed = "workloads" in m
        if (listed and name in m["workloads"]) or (not listed and m["moves"] in e2e_names):
            per_layer.append((m, load_reader(m["name"], here)))
    return Cell(name, config, traffic, e2e, per_layer, int(w["chips"]))
