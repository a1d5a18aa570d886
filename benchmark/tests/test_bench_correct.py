"""The comparison that decides `correct`, driven through the rest of a
run on the CPU at a size a test run holds: a sound run passes the
committed limits, and it fails them with the timed path broken underneath
(each planted fault of harness/faults.py that the cell runs, of those
that show at this size) and with the control (the plain reference computed
in bfloat16) in the program's place.

Each cell runs at the size its scale file gives (`scales/<workload>.json`,
its "check" fields over the configuration's, and "check_traffic" over the
traffic's), so that a cell added later brings a data file and edits no
test. Above 65,536 bodies the comparison stages the step; here that limit
is lowered to 1,024 so that the cells whose full size takes that path
(under leapfrog or Euler) take it too, on the tree and the collision pass
that they take at full size.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import check, cli, faults  # noqa: E402

# One thread a test process: the runs are small, and parallel test
# workers that each spin a pool of all the cores slow one another down.
torch.set_num_threads(1)

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SCALES = BENCH / "tests" / "scales"


# Faults that read only at full size, where the discs' own field is a
# visible share of the central masses' pull (`outliers`; `tiles`, in the
# collide cell), or not at all (`deep_rows`; `no_residual`, which the
# window's states do not reach): PERF.md gives their chip readings.
AT_FULL_SIZE = ("outliers", "deep_rows", "tiles", "no_residual")


@pytest.fixture(autouse=True)
def _staged_above_1024(monkeypatch):
    monkeypatch.setattr(check, "FULL_LIMIT", 1024)


def _run(workload, seed, **kw):
    scale = json.loads((SCALES / f"{workload}.json").read_text())
    res, info = cli.run_cell(workload, seed, 0.05, False, device="cpu",
                             scale=scale["check"], out=lambda s: None,
                             traffic=scale.get("check_traffic"), **kw)
    return res, info


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_control_is_not(workload):
    res, info = _run(workload, 21, control=True)
    assert res["correct"], res["checks"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    ctl = info["control"]
    assert any(not ctl[k] <= limits[k] for k in limits), ctl


@pytest.mark.parametrize("fault", [f for f in faults.NAMES
                                   if f not in AT_FULL_SIZE])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_run_incorrect(workload, fault):
    res, info = _run(workload, 22, fault=faults.plant(fault, 22))
    if not faults.applies(fault, info["resolved"]):
        assert res["correct"], res["checks"]
        return
    assert not res["correct"], res["checks"]
