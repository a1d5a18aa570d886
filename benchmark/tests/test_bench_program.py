"""The metrics that read the program's own spans and counters (the
`program` probe), in a traced rehearsal on the CPU of each cell that
reports them, at its scale file's "rehearsal" size (as
test_bench_contract.py's rehearsal): the host-clock and counter metrics
read numbers, the device-clock ones None (no card), and the tree's row
share None where no compaction ran."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import cli, registry  # noqa: E402
from test_bench_contract import rehearsals  # noqa: E402

torch.set_num_threads(1)

SCALE = {cell: scale for cell, scale in rehearsals().items()
         if any(m["name"] == "enqueue_ms"
                for m in registry.cell(cell).per_layer)}
NUMBERS = ("enqueue_ms", "host_syncs_per_step", "sync_wait_ms")
DEVICE = ("tree_busy_ms", "tree_idle_pct", "collision_busy_ms")


@pytest.mark.parametrize("workload", sorted(SCALE))
def test_traced_rehearsal_reads_the_program(workload):
    res, _ = cli.run_cell(workload, 3_100_000_123, 0.05, True, device="cpu",
                          scale=SCALE[workload], out=lambda s: None)
    metrics = res["metrics"]
    names = {m["name"] for m in registry.cell(workload).per_layer}
    for name in NUMBERS:
        if name in names:
            value = metrics[name]["value"]
            assert isinstance(value, float) and value >= 0.0, name
    assert metrics["enqueue_ms"]["value"] > 0.0
    # At N <= 65,536 the collisions take the dense pass, and no compaction
    # of the tree's deep chain runs below 4,096 rows: no host read.
    assert metrics["host_syncs_per_step"]["value"] == 0.0
    for name in DEVICE + ("tree_rows_useful_pct",):
        assert name not in metrics, name
