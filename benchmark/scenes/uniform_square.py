"""Frozen copy of the uniform square, the project's N=1M throughput input
as a scene, in plain PyTorch.

It makes the same state as `nbodysim_tpu_torch.scenes.square.uniform_square`
did when this copy was taken, bit for bit (benchmark/tests checks that at
small N), so that an edit to the program's scenes cannot move the
benchmark's inputs. It imports nothing of the program.

  - n bodies uniform in [-h, h]^2, h = 3e4 * sqrt(n / 2^20) (the headline
    input's density at any n; 3e4 at n = 2^20), then masses uniform in
    [0.1, 10], both from one torch.Generator on `device` seeded 0: at
    n = 2^20 the throughput input of BASELINE.json's headline metric
  - velocities uniform in +-5 per axis from a torch.Generator on `device`
    seeded 2 * seed + 1 (as the program's scene takes `SimConfig.seed`):
    odd, so never the layout's 0, whose draws would make the velocities
    the positions scaled (a uniform expansion with no collisions);
    radius = cbrt(mass)
"""

from __future__ import annotations

import math

import torch

HALF_WIDTH = 3.0e4           # at n = 2^20
MASS_LO, MASS_HI = 0.1, 10.0
SPEED = 5.0


def half_width(n: int) -> float:
    return HALF_WIDTH * math.sqrt(n / (1 << 20))


def make(params: dict, seed: int, device) -> dict:
    """The scene as {pos, vel, mass, radius} float32 tensors on `device`.
    `params`: {"n": bodies}; the scene is 2D."""
    n = int(params["n"])
    dtype = torch.float32
    device = torch.device(device)
    h = half_width(n)
    layout = torch.Generator(device=device)
    layout.manual_seed(0)
    pos = -h + 2.0 * h * torch.rand((n, 2), generator=layout, dtype=dtype,
                                    device=device)
    mass = MASS_LO + (MASS_HI - MASS_LO) * torch.rand(
        n, generator=layout, dtype=dtype, device=device)
    motion = torch.Generator(device=device)
    motion.manual_seed(2 * int(seed) + 1)
    vel = -SPEED + 2.0 * SPEED * torch.rand((n, 2), generator=motion,
                                            dtype=dtype, device=device)
    radius = torch.sign(mass) * torch.abs(mass).pow(1.0 / 3.0)
    return {"pos": pos, "vel": vel, "mass": mass, "radius": radius}
