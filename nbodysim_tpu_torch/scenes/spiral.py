"""Spiral-arm galaxy scene (port of `nbodysim_tpu.scenes.spiral`).

An extension scene: satellites scattered along m logarithmic spiral arms
r = r_min * exp(b * theta) around a dominant central body, on circular
orbits from the enclosed mass, as the flagship disc (Simulation.hpp:591-600).

The draws come from a `torch.Generator` seeded with `config.seed` on the
target device; they cannot match `jax.random` (ROADMAP fault F3). Everything
after the draws is `spiral_from_draws`, a deterministic function of them, so
a test can feed it the JAX package's own draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState, cbrt
from nbodysim_tpu_torch.scenes.disc import sample_bucket_masses

CENTRAL_MASS = 1.0e9     # match the flagship disc (Simulation.hpp:358)
CENTRAL_RADIUS = 200.0   # Simulation.hpp:359
U_RANGE = (1e-6, 1.0)    # enclosed-area quantile


def spiral_outer_radius(n: int) -> float:
    """sqrt(n) * 300.7 in f32, the flagship disc's footprint (hpp:353)."""
    return float(np.sqrt(np.float32(n)) * np.float32(300.7))


def spiral_from_draws(u, arm, scatter_phi, scatter_r, sat_mass, z, *,
                      dim: int, g_const: float, n_arms: int, pitch: float,
                      central_mass: float, outer_radius: float,
                      arm_scatter: float, thickness: float):
    """(pos, vel, mass, radius) from the draws of the n - 1 satellites: u in
    U_RANGE, arm in [0, n_arms), scatter_phi, scatter_r and z standard
    normal, sat_mass from the 3-bucket distribution; the central body
    first."""
    dtype, device = u.dtype, u.device
    r_min = 0.02 * outer_radius
    # r^2 uniform in enclosed area (surface density ~1/r), then the arm
    # angle theta = log(r / r_min) / b.
    r = r_min + (outer_radius - r_min) * torch.sqrt(u)
    theta = torch.log(r / r_min) / pitch
    phi = (theta + arm.to(dtype) * (2.0 * math.pi / n_arms)
           + arm_scatter * scatter_phi)
    r = r * (1.0 + arm_scatter * scatter_r)
    r = torch.clamp_min(r, r_min)
    x, y = r * torch.cos(phi), r * torch.sin(phi)

    # Circular speed from the enclosed mass (hpp:584-600, the corrected
    # normalize): sort by radius, exclusive cumulative sum.
    order = torch.argsort(r, stable=True)
    m_s = sat_mass[order]
    m_enc = central_mass + torch.cumsum(m_s, 0) - m_s
    v = torch.empty_like(r)
    v[order] = torch.sqrt(g_const * m_enc / r[order])
    vx, vy = -v * torch.sin(phi), v * torch.cos(phi)

    cols_p, cols_v = [x, y], [vx, vy]
    if dim == 3:
        cols_p.append(thickness * outer_radius * z)
        cols_v.append(torch.zeros_like(vx))
    zero = torch.zeros((1, dim), dtype=dtype, device=device)
    pos = torch.cat([zero, torch.stack(cols_p, -1)])
    vel = torch.cat([zero, torch.stack(cols_v, -1)])
    mass = torch.cat([torch.full((1,), central_mass, dtype=dtype,
                                 device=device), sat_mass])
    radius = torch.cat([torch.full((1,), CENTRAL_RADIUS, dtype=dtype,
                                   device=device), cbrt(sat_mass)])
    return pos, vel, mass, radius


def spiral_galaxy(
    config: SimConfig,
    n: int | None = None,
    n_arms: int = 2,
    pitch: float = 0.28,
    central_mass: float = CENTRAL_MASS,
    outer_radius: float | None = None,
    arm_scatter: float = 0.12,
    thickness: float = 0.02,
    *,
    device="cuda",
) -> ParticleState:
    """Logarithmic-spiral galaxy on `device`: a central body and satellites
    on n_arms arms. pitch is the growth rate b; arm_scatter the Gaussian
    azimuthal and radial scatter as a fraction of the local radius;
    thickness the vertical sigma as a fraction of outer_radius (dim=3)."""
    if n is None:
        n = config.n
    device = torch.device(device)
    dtype, m = config.dtype, n - 1
    if outer_radius is None:
        outer_radius = spiral_outer_radius(n)
    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)

    def normal():
        return torch.randn(m, generator=generator, dtype=dtype, device=device)

    lo, hi = U_RANGE
    u = lo + (hi - lo) * torch.rand(m, generator=generator, dtype=dtype,
                                    device=device)
    arm = torch.randint(0, n_arms, (m,), generator=generator, device=device)
    scatter_phi, scatter_r = normal(), normal()
    sat_mass = sample_bucket_masses(generator, m, dtype, device)
    pos, vel, mass, radius = spiral_from_draws(
        u, arm, scatter_phi, scatter_r, sat_mass, normal(), dim=config.dim,
        g_const=config.g_const, n_arms=n_arms, pitch=pitch,
        central_mass=central_mass, outer_radius=outer_radius,
        arm_scatter=arm_scatter, thickness=thickness)
    return ParticleState.create(pos, vel, mass, radius=radius, dtype=dtype)
