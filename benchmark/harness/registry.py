"""Finds what a cell is made of by the names in BENCHMARK.json: the
configuration's file, the traffic mix's file (`traffic/<name>.json`), the
correctness limits (`limits/<workload>.json`), the scene generator
(`scenes/<scene>.py`), and each per-layer metric's reader
(`metrics/<name>.py`) with the probes it reads (`probes/<name>.py`). A
metric split by the end-to-end metric it moves (`device_idle_pct.viewer`)
is read by the reader of the name before its first dot. A
later cell, configuration or metric is a new file and a new entry; no file
here names one. A cell also brings the sizes its CPU tests run at
(`tests/scales/<workload>.json`), and the comparison takes a cell of
either integrator the program has at any size (harness/check.py stages
the step of either above FULL_LIMIT bodies): no test or harness file
names a cell."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent.parent      # benchmark/
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    spec: dict          # the BENCHMARK.json entry
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # limits/<workload>.json: {number: limit}
    end_to_end: list    # BENCHMARK.json end_to_end entries this cell reports
    per_layer: list     # per_layer entries this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str) -> Cell:
    bench = benchmark()
    specs = {w["name"]: w for w in bench["workloads"]}
    if workload not in specs:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(specs)}")
    spec = specs[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[spec["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{spec['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return Cell(workload, spec, config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


def _load(kind: str, name: str):
    """`<kind>/<name>.py` as a module."""
    key = f"{kind}.{name}"
    if key not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            key, HERE / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


_LOADED: dict = {}


def scene(name: str):
    return _load("scenes", name)


def metric(name: str):
    return _load("metrics", name.split(".")[0])


def probe(name: str):
    return _load("probes", name)
