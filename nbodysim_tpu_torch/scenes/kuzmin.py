"""Kuzmin disc scene (port of `nbodysim_tpu.scenes.kuzmin`): a razor-thin
disc with a closed-form potential.

Surface density Sigma(r) = a M / (2 pi (r^2 + a^2)^{3/2}) and midplane
potential Phi(r) = -G M / sqrt(r^2 + a^2): the radius sampling (inverse CDF
of M(<r) = M (1 - a / sqrt(r^2 + a^2))) and the circular speed
v_c^2 = G M r^2 / (r^2 + a^2)^{3/2} are analytic, so the measured orbital
speeds must track the closed form.

The draws come from a `torch.Generator` seeded with `config.seed` on the
target device; they cannot match `jax.random` (ROADMAP fault F3). Everything
after the draws is `kuzmin_from_draws`, a deterministic function of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState


def kuzmin_scale_radius(n: int) -> float:
    """sqrt(n) * 30 in f32, the default scale radius a."""
    return float(np.sqrt(np.float32(n)) * np.float32(30.0))


def kuzmin_u_max(r_max_scales: float) -> float:
    """The enclosed-mass quantile at the truncation radius r_max_scales * a,
    in f32: the upper end of the radius draw."""
    f = np.float32
    return float(f(1.0) - f(1.0) / np.sqrt(f(1.0 + r_max_scales ** 2)))


def kuzmin_from_draws(u, phi, noise, *, dim: int, g_const: float,
                      total_mass: float, scale_radius: float,
                      velocity_dispersion: float):
    """(pos, vel, mass, radius) from the draws: u in [1e-6, u_max), phi in
    [0, 2 pi), and `noise` [n, 2] standard normal (read only when
    velocity_dispersion > 0)."""
    n = u.shape[0]
    dtype, device = u.dtype, u.device
    a = scale_radius
    r = a * torch.sqrt(1.0 / (1.0 - u) ** 2 - 1.0)
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    sqrt_gm = float(np.sqrt(np.float32(g_const * total_mass)))
    v_c = sqrt_gm * r / (r * r + a * a) ** 0.75
    vx, vy = -v_c * torch.sin(phi), v_c * torch.cos(phi)
    if velocity_dispersion > 0.0:
        vx = vx + velocity_dispersion * v_c * noise[:, 0]
        vy = vy + velocity_dispersion * v_c * noise[:, 1]
    cols_p, cols_v = [x, y], [vx, vy]
    if dim == 3:
        cols_p.append(torch.zeros_like(x))
        cols_v.append(torch.zeros_like(x))
    pos, vel = torch.stack(cols_p, -1), torch.stack(cols_v, -1)
    mass = torch.full((n,), total_mass / n, dtype=dtype, device=device)
    # Tracers sized at a small fraction of the mean spacing, not cbrt(mass)
    # (see the JAX scene): collisions stay rare.
    spacing = torch.sqrt(torch.tensor(float(n), dtype=dtype))
    radius = torch.full((n,), float(0.1 * a / spacing), dtype=dtype,
                        device=device)
    return pos, vel, mass, radius


def kuzmin_disc(
    config: SimConfig,
    n: int | None = None,
    total_mass: float = 1.0e4,
    scale_radius: float | None = None,
    r_max_scales: float = 20.0,
    velocity_dispersion: float = 0.0,
    *,
    device="cuda",
) -> ParticleState:
    """Equal-mass Kuzmin disc on circular orbits in its own potential, on
    `device`, truncated at r_max_scales * a. `velocity_dispersion` adds
    isotropic in-plane Gaussian noise as a fraction of the local circular
    speed (0 = a cold disc)."""
    if n is None:
        n = config.n
    device = torch.device(device)
    dtype = config.dtype
    if scale_radius is None:
        scale_radius = kuzmin_scale_radius(n)
    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           dtype=dtype, device=device)

    u = uniform((n,), 1e-6, kuzmin_u_max(r_max_scales))
    phi = uniform((n,), 0.0, 2.0 * math.pi)
    noise = torch.randn((n, 2), generator=generator, dtype=dtype,
                        device=device)
    pos, vel, mass, radius = kuzmin_from_draws(
        u, phi, noise, dim=config.dim, g_const=config.g_const,
        total_mass=total_mass, scale_radius=scale_radius,
        velocity_dispersion=velocity_dispersion)
    return ParticleState.create(pos, vel, mass, radius, dtype=dtype)
