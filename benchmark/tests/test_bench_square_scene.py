"""CPU tests of the frozen uniform square (`scenes/uniform_square.py`): it
makes the program's `init_scene("uniform_square")` bit for bit, its seed
moves only the velocities, and at the headline N its half-width is the
throughput input's 3e4."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import registry  # noqa: E402


@pytest.mark.parametrize("n", [1000, 4097])
@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_frozen_square_matches_program(n, seed):
    from nbodysim_tpu_torch import SimConfig, init_scene

    want = init_scene("uniform_square", SimConfig(n=n, seed=seed),
                      device="cpu")
    got = registry.scene("uniform_square").make({"n": n}, seed, "cpu")
    for field in ("pos", "vel", "mass", "radius"):
        assert torch.equal(getattr(want, field), got[field]), field


def test_square_seed_moves_only_velocities():
    mod = registry.scene("uniform_square")
    a = mod.make({"n": 512}, 1, "cpu")
    b = mod.make({"n": 512}, 2, "cpu")
    for field in ("pos", "mass", "radius"):
        assert torch.equal(a[field], b[field]), field
    assert not torch.equal(a["vel"], b["vel"])
    assert float(a["vel"].abs().max()) <= 5.0


def test_square_half_width_at_headline_n():
    mod = registry.scene("uniform_square")
    assert mod.half_width(1 << 20) == 30000.0
    assert mod.half_width(1 << 18) == 15000.0
    pos = mod.make({"n": 4096}, 3, "cpu")["pos"]
    assert float(pos.abs().max()) <= mod.half_width(4096)

