"""Kepler orbit scenes — the analytic parity gates (port of
`nbodysim_tpu.scenes.kepler`; BASELINE.json config 1).

A 2-body orbit has a closed-form solution, so period, energy and angular
momentum are checkable against theory. Tests use orbital radii much larger
than the softening, where softened dynamics match Kepler closely.
"""

from __future__ import annotations

import math

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState


def kepler_orbit(
    config: SimConfig,
    central_mass: float = 1.0e6,
    satellite_mass: float = 1.0,
    semi_major: float = 1000.0,
    eccentricity: float = 0.0,
    *,
    device="cuda",
) -> ParticleState:
    """Two-body orbit (central + satellite), started at apoapsis, with both
    velocities about the barycenter (total momentum zero). With G=1:
    vis-viva v^2 = mu (2/r - 1/a), mu = G (M + m)."""
    dtype = config.dtype
    mu = config.g_const * (central_mass + satellite_mass)
    r_apo = semi_major * (1.0 + eccentricity)
    v_apo = float(torch.sqrt(torch.tensor(
        mu * (2.0 / r_apo - 1.0 / semi_major), dtype=dtype)))

    f_sat = central_mass / (central_mass + satellite_mass)
    f_cen = satellite_mass / (central_mass + satellite_mass)
    pad = [0.0] * (config.dim - 2)
    pos = torch.tensor(
        [[-r_apo * f_cen, 0.0] + pad, [r_apo * f_sat, 0.0] + pad],
        dtype=dtype, device=device)
    vel = torch.tensor(
        [[0.0, -v_apo * f_cen] + pad, [0.0, v_apo * f_sat] + pad],
        dtype=dtype, device=device)
    mass = torch.tensor([central_mass, satellite_mass], dtype=dtype,
                        device=device)
    return ParticleState.create(pos, vel, mass, dtype=dtype)


def kepler_period(config: SimConfig, central_mass: float,
                  satellite_mass: float, semi_major: float) -> float:
    """T = 2 pi sqrt(a^3 / mu)."""
    mu = config.g_const * (central_mass + satellite_mass)
    return 2.0 * math.pi * math.sqrt(semi_major ** 3 / mu)


def kepler_system(
    config: SimConfig,
    n: int | None = None,
    central_mass: float = 1.0e6,
    r_min: float = 500.0,
    r_max: float = 5000.0,
    *,
    device="cuda",
) -> ParticleState:
    """Central body + (n-1) light test bodies on circular orbits at radii
    evenly spaced in [r_min, r_max], random phases from a `torch.Generator`
    seeded with `config.seed`."""
    if n is None:
        n = config.n
    dtype = config.dtype
    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)

    m = n - 1
    r = torch.linspace(r_min, r_max, m, dtype=dtype, device=device)
    phi = 2.0 * math.pi * torch.rand(m, generator=generator, dtype=dtype,
                                     device=device)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    v = torch.sqrt(config.g_const * central_mass / r)
    cols_p = [x, y]
    cols_v = [-v * torch.sin(phi), v * torch.cos(phi)]
    if config.dim == 3:
        cols_p.append(torch.zeros_like(x))
        cols_v.append(torch.zeros_like(x))
    zero = torch.zeros((1, config.dim), dtype=dtype, device=device)
    pos = torch.cat([zero, torch.stack(cols_p, dim=-1)])
    vel = torch.cat([zero, torch.stack(cols_v, dim=-1)])
    mass = torch.cat([
        torch.full((1,), central_mass, dtype=dtype, device=device),
        torch.full((m,), 1e-3, dtype=dtype, device=device)])
    return ParticleState.create(pos, vel, mass, dtype=dtype)
