"""CPU tests of the benchmark's yardstick: the frozen scenes make the
program's initial states bit for bit, and the roofline bounds are the ones
the benchmark documents."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import registry, roofline  # noqa: E402


@pytest.mark.parametrize("scene,params", [
    ("uniform_disc", {}), ("galaxy_merger", {"dim": 2, "g_const": 1.0})])
@pytest.mark.parametrize("n", [1000, 4097])
@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_frozen_scene_matches_program(scene, params, n, seed):
    from nbodysim_tpu_torch import SimConfig, init_scene

    want = init_scene(scene, SimConfig(n=n, seed=seed), device="cpu")
    got = registry.scene(scene).make({"n": n, **params}, seed, "cpu")
    for field in ("pos", "vel", "mass", "radius"):
        assert torch.equal(getattr(want, field), got[field]), field


def test_seed_changes_inputs():
    mod = registry.scene("galaxy_merger")
    a = mod.make({"n": 512}, 1, "cpu")
    b = mod.make({"n": 512}, 2, "cpu")
    assert not torch.equal(a["pos"], b["pos"])


def test_roofline_bounds_at_25k():
    assert roofline.forces_bound_s(25_000, 2) * 1e3 == pytest.approx(
        0.1495, abs=5e-5)
    assert roofline.collisions_bound_s(25_000, 2) * 1e3 == pytest.approx(
        0.0653, abs=5e-5)
    # The MUFU pipe bounds the forces, the float32 rate the overlap tests.
    n = 25_000.0
    assert roofline.forces_bound_s(25_000, 2) == n * n / roofline.MUFU_PER_S
    assert roofline.collisions_bound_s(25_000, 2) == \
        7 * n * n / roofline.F32_FLOPS_PER_S
