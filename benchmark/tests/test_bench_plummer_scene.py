"""CPU tests of the frozen Plummer sphere (`scenes/plummer_sphere.py`): it
makes the program's `plummer_sphere(..., virialize=False)` bit for bit,
and its seed moves its inputs."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import registry  # noqa: E402

PARAMS = {"dim": 3, "total_mass": 1.0e4, "scale_radius": 1000.0,
          "g_const": 1.0, "virialize": False}


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_frozen_plummer_matches_program(n, seed):
    from nbodysim_tpu_torch import SimConfig
    from nbodysim_tpu_torch.scenes.plummer import plummer_sphere

    want = plummer_sphere(SimConfig(n=n, dim=3, seed=seed), virialize=False,
                          device="cpu")
    got = registry.scene("plummer_sphere").make({"n": n, **PARAMS}, seed,
                                                "cpu")
    for field in ("pos", "vel", "mass", "radius"):
        assert torch.equal(getattr(want, field), got[field]), field


def test_plummer_seed_changes_inputs():
    mod = registry.scene("plummer_sphere")
    a = mod.make({"n": 512, **PARAMS}, 1, "cpu")
    b = mod.make({"n": 512, **PARAMS}, 2, "cpu")
    assert not torch.equal(a["pos"], b["pos"])
    assert not torch.equal(a["vel"], b["vel"])
