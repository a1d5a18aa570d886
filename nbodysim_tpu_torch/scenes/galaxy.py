"""Galaxy-merger scene, BASELINE config 5 (port of
`nbodysim_tpu.scenes.galaxy`): two rotating discs on a collision course,
each a central massive body and satellites on circular orbits about it.

The uniform draws come from a `torch.Generator` seeded with `config.seed`
on the target device; they cannot match `jax.random` (ROADMAP fault F3).
Everything after the draws is `merger_from_draws`, a deterministic function
of them, so a test can feed it the JAX package's own draws. The scalar
sizes are computed in f32, as the JAX scene computes them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState

CENTRAL_MASS = 5.0e8
# Ranges of the uniform draws: radius quantile, angle, satellite mass.
U_RANGE = (1e-4, 1.0 - 1e-4)
PHI_RANGE = (0.0, 2.0 * math.pi)
MASS_RANGE = (0.1, 2.0)

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _f32(x: float) -> np.float32:
    return np.float32(x)


def merger_sizes(n: int, central_mass: float, g_const: float,
                 disc_radius=None, separation=None, impact_parameter=None,
                 approach_speed=None) -> Tuple[float, float, float, float]:
    """(disc_radius, separation, impact_parameter, approach_speed), each
    defaulted as the JAX scene does: R = sqrt(n/2) * 150, separation 3R,
    impact parameter R/2, approach speed half the mutual orbital speed."""
    if disc_radius is None:
        disc_radius = float(np.sqrt(_f32(n / 2)) * _f32(150.0))
    if separation is None:
        separation = 3.0 * disc_radius
    if impact_parameter is None:
        impact_parameter = 0.5 * disc_radius
    if approach_speed is None:
        approach_speed = float(_f32(0.5) * np.sqrt(
            _f32(g_const * 2 * central_mass / separation)))
    return disc_radius, separation, impact_parameter, approach_speed


def _single_disc(draws: Draws, central_mass: float, disc_radius: float,
                 dim: int, g_const: float):
    """Exponential disc (scale length R/4, truncated at R) of satellites
    about one central mass at the origin, in the xy plane."""
    u, phi, sat_mass = draws
    dtype, device = u.dtype, u.device
    scale_len = disc_radius / 4.0
    e = torch.exp(torch.tensor(-disc_radius / scale_len, dtype=dtype))
    r = -scale_len * torch.log1p(-u * (1.0 - e.to(device)))
    r = torch.clamp(r, disc_radius * 0.02, disc_radius)
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    # Circular speed about the central mass alone (satellites are light).
    v = torch.sqrt(g_const * central_mass / r)
    vx, vy = -v * torch.sin(phi), v * torch.cos(phi)
    cols_p, cols_v = [x, y], [vx, vy]
    if dim == 3:
        cols_p.append(torch.zeros_like(x))
        cols_v.append(torch.zeros_like(x))
    zero = torch.zeros((1, dim), dtype=dtype, device=device)
    pos = torch.cat([zero, torch.stack(cols_p, -1)])
    vel = torch.cat([zero, torch.stack(cols_v, -1)])
    mass = torch.cat([torch.full((1,), central_mass, dtype=dtype,
                                 device=device), sat_mass])
    return pos, vel, mass


def merger_from_draws(draws1: Draws, draws2: Draws, *, dim: int,
                      g_const: float, central_mass: float,
                      disc_radius: float, separation: float,
                      impact_parameter: float, approach_speed: float):
    """The merger from each disc's uniform draws (radius quantile in
    U_RANGE, angle in PHI_RANGE, satellite mass in MASS_RANGE; n/2 - 1 and
    n - n/2 - 1 of each): (pos, vel, mass), disc 1 first, shifted to
    (-sep/2, -b/2) and boosted +v/2 along x, disc 2 mirrored."""
    p1, v1, m1 = _single_disc(draws1, central_mass, disc_radius, dim,
                              g_const)
    p2, v2, m2 = _single_disc(draws2, central_mass, disc_radius, dim,
                              g_const)
    dtype, device = p1.dtype, p1.device

    def vec(x, y):
        out = torch.zeros(dim, dtype=dtype, device=device)
        out[0], out[1] = x, y
        return out

    pos = torch.cat([p1 + vec(-separation / 2, -impact_parameter / 2),
                     p2 + vec(separation / 2, impact_parameter / 2)])
    vel = torch.cat([v1 + vec(approach_speed / 2, 0.0),
                     v2 + vec(-approach_speed / 2, 0.0)])
    return pos, vel, torch.cat([m1, m2])


def galaxy_merger(
    config: SimConfig,
    n: int | None = None,
    central_mass: float = CENTRAL_MASS,
    disc_radius: float | None = None,
    separation: float | None = None,
    impact_parameter: float | None = None,
    approach_speed: float | None = None,
    *,
    device="cuda",
) -> ParticleState:
    """Two discs of n/2 bodies each, approaching with an impact parameter,
    on `device`; radius = cbrt(mass)."""
    if n is None:
        n = config.n
    device = torch.device(device)
    dtype = config.dtype
    sizes = merger_sizes(n, central_mass, config.g_const, disc_radius,
                         separation, impact_parameter, approach_speed)
    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)

    def uniform(m, lo, hi):
        return lo + (hi - lo) * torch.rand(m, generator=generator,
                                           dtype=dtype, device=device)

    draws = [tuple(uniform(m - 1, *rng)
                   for rng in (U_RANGE, PHI_RANGE, MASS_RANGE))
             for m in (n // 2, n - n // 2)]
    pos, vel, mass = merger_from_draws(
        *draws, dim=config.dim, g_const=config.g_const,
        central_mass=central_mass, disc_radius=sizes[0],
        separation=sizes[1], impact_parameter=sizes[2],
        approach_speed=sizes[3])
    return ParticleState.create(pos, vel, mass, dtype=dtype)
