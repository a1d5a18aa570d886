"""CPU tests that BENCHMARK.json and the files it names keep to the
benchmark's contract: names and units, a file for every configuration,
traffic mix, limit set, per-layer metric and CPU test scale, every
metric's `moves` reported in each of its cells, and no JAX in what a run
imports."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SCALES = BENCH / "tests" / "scales"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "nbodysim_tpu"}


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and kind != "end_to_end" and kind != "per_layer" \
                    or key in ("why", "layer") and key in e:
                assert 1 <= len(e[key]) <= 200 and "\t" not in e[key] \
                    and "\n" not in e[key], (e["name"], key)


def test_files_exist():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/")
        assert (BENCH / "scenes" / f"{cfg['scene']}.py").is_file()
        assert c["reduced"] == cfg["reduced"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1
    for m in SPEC["per_layer"]:
        reader = m["name"].split(".")[0]
        assert (BENCH / "metrics" / f"{reader}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_has_a_test_scale(cell):
    """Each cell names the sizes its CPU tests run at in a file of its own:
    "check" (configuration fields for test_bench_correct.py), optionally
    "check_traffic" (traffic fields there) and "rehearsal" (configuration
    fields of the traced rehearsals here and in test_bench_program.py)."""
    scale = json.loads((SCALES / f"{cell}.json").read_text())
    assert set(scale) <= {"why", "check", "check_traffic", "rehearsal"}
    assert scale["check"]["n"] <= 4096
    assert scale.get("rehearsal", {"n": 0})["n"] <= 4096
    assert 1 <= len(scale["why"]) <= 400


def test_every_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        reported = [m["name"] for m in SPEC["end_to_end"]
                    if _reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(_reports(m, cell) for m in SPEC["per_layer"])


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


REHEARSAL = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from harness import cli
for wl, scale in json.loads(sys.argv[3]).items():
    cli.run_cell(wl, 5, 0.05, True, device="cpu", scale=scale,
                 out=lambda s: None)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def rehearsals() -> dict:
    """{cell: its rehearsal scale} of the cells whose scale file has one."""
    out = {}
    for cell in CELLS:
        scale = json.loads((SCALES / f"{cell}.json").read_text())
        if "rehearsal" in scale:
            out[cell] = scale["rehearsal"]
    return out


def test_rehearsal_imports_no_jax():
    """A traced rehearsal on the CPU, in a fresh process, of each cell
    with a rehearsal scale: no module it loaded has a forbidden top-level
    name."""
    cells = rehearsals()
    assert cells
    out = subprocess.run(
        [sys.executable, "-c", REHEARSAL, str(BENCH), str(ROOT),
         json.dumps(cells)],
        capture_output=True, text=True, timeout=600, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "nbodysim_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
