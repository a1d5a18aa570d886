"""The uniform square: the project's N=1M throughput input as a scene.

  - n bodies uniform in the square [-h, h]^2, h = 3e4 * sqrt(n / 2^20), so
    that every n has the density of BASELINE.json's headline input (2^20
    bodies in +-3e4, `diagnostics.profiling.measure_force_throughput`):
    about 4 bodies a finest cell of the quadtree that `auto` picks
  - masses uniform in [0.1, 10]; radius = cbrt(mass)
  - velocities uniform in +-5 per axis

Positions and then masses come from one `torch.Generator` on the target
device seeded 0, whatever the config's seed, so at n = 2^20 they are the
throughput input bit for bit on that device. The velocities come from a
second generator seeded 2 * config.seed + 1: odd, so never the layout's
0, whose draws would make every velocity proportional to its position (a
uniform expansion in which no pair ever approaches). Uniform bodies are
also the standard test input of the fast multipole method (Greengard &
Rokhlin 1987, J. Comput. Phys. 73, 325). A scene of the port alone: the JAX
package has none such.
"""

from __future__ import annotations

import math

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState, cbrt

HEADLINE_N = 1 << 20
HEADLINE_HALF_WIDTH = 3.0e4
MASS_RANGE = (0.1, 10.0)
SPEED = 5.0                    # velocities uniform in +-SPEED per axis
LAYOUT_SEED = 0                # positions and masses do not follow the seed


def square_half_width(n: int) -> float:
    """h = 3e4 * sqrt(n / 2^20): the headline input's density at any n."""
    return HEADLINE_HALF_WIDTH * math.sqrt(n / HEADLINE_N)


def uniform_square(config: SimConfig, *, device="cuda") -> ParticleState:
    """`config.n` bodies uniform in the square of `square_half_width`, on
    `device` (2D)."""
    if config.dim != 2:
        raise ValueError("uniform_square is a 2D scene")
    n, dtype = config.n, config.dtype
    device = torch.device(device)
    h = square_half_width(n)
    lo, hi = MASS_RANGE
    layout = torch.Generator(device=device)
    layout.manual_seed(LAYOUT_SEED)
    pos = -h + 2.0 * h * torch.rand((n, 2), generator=layout, dtype=dtype,
                                    device=device)
    mass = lo + (hi - lo) * torch.rand(n, generator=layout, dtype=dtype,
                                       device=device)
    motion = torch.Generator(device=device)
    motion.manual_seed(2 * config.seed + 1)      # odd: never LAYOUT_SEED
    vel = -SPEED + 2.0 * SPEED * torch.rand((n, 2), generator=motion,
                                            dtype=dtype, device=device)
    return ParticleState.create(pos, vel, mass, cbrt(mass), dtype=dtype)
