"""Plummer sphere, BASELINE config 2 (port of `nbodysim_tpu.scenes.plummer`):
an equilibrium self-gravitating cluster, the standard energy-drift gate for
collisionless codes.

Aarseth-Henon-Wielen sampling: density rho(r) ~ (1 + r^2/a^2)^(-5/2),
radius from the inverse CDF of the enclosed mass, isotropic directions,
speeds q v_esc with f(q) ~ q^2 (1 - q^2)^(7/2) by fixed-shape rejection.

The draws come from a `torch.Generator` seeded with `config.seed` on the
target device; they cannot match `jax.random` (ROADMAP fault F3). Everything
after the draws is `plummer_from_draws`, a deterministic function of them, so
a test can feed it the JAX package's own draws.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.physics.forces import potential_energy

N_CAND = 16                   # speed candidates per body; first accept wins
U_RANGE = (1e-6, 1.0 - 1e-6)  # enclosed-mass quantile
Y_RANGE = (0.0, 0.1)          # rejection ordinate (max of f(q) is ~0.092)


def plummer_from_draws(u, dir_pos, qs, ys, dir_vel, *, total_mass: float,
                       scale_radius: float, g_const: float, eps_sq: float,
                       virialize: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos, vel, mass) from the draws: u [n] in U_RANGE, dir_pos and
    dir_vel [n, dim] standard normal, qs [n, N_CAND] in [0, 1), ys
    [n, N_CAND] in Y_RANGE. With `virialize`, speeds are rescaled so that
    2K = -U against the softened potential of the realized bodies."""
    n = u.shape[0]
    a = scale_radius
    r = a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * (dir_pos / dir_pos.norm(dim=-1, keepdim=True))

    # First accepted candidate (argmax returns the first maximum, as
    # jnp.argmax does); 0.5 where none is accepted (p < 1e-4 a body).
    accept = ys < qs ** 2 * (1.0 - qs ** 2) ** 3.5
    first = torch.argmax(accept.to(torch.int32), dim=1)
    q = torch.where(accept.any(dim=1), qs.gather(1, first[:, None])[:, 0],
                    0.5)
    v_esc = math.sqrt(2.0 * g_const * total_mass) * (r * r + a * a) ** (-0.25)
    vel = (q * v_esc)[:, None] * (dir_vel / dir_vel.norm(dim=-1,
                                                          keepdim=True))
    mass = torch.full((n,), total_mass / n, dtype=u.dtype, device=u.device)

    # Zero the net momentum and recentre.
    vel = vel - (vel * mass[:, None]).mean(0) / mass.mean()
    pos = pos - (pos * mass[:, None]).mean(0) / mass.mean()
    if virialize:
        pot = potential_energy(pos, mass, eps_sq, g_const)
        kin = 0.5 * (mass * (vel * vel).sum(-1)).sum()
        vel = vel * torch.sqrt(torch.clamp_min(-0.5 * pot, 0.0)
                               / torch.clamp_min(kin, 1e-30))
    return pos, vel, mass


def plummer_sphere(
    config: SimConfig,
    n: int | None = None,
    total_mass: float = 1.0e4,
    scale_radius: float = 1000.0,
    virialize: bool = True,
    *,
    device="cuda",
) -> ParticleState:
    """A Plummer model of n bodies (default config.n) in config.dim
    dimensions on `device`; radius = cbrt(mass). Virialization computes the
    exact O(N^2) potential once (plain torch)."""
    if n is None:
        n = config.n
    device = torch.device(device)
    dtype, dim = config.dtype, config.dim
    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           dtype=dtype, device=device)

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    pos, vel, mass = plummer_from_draws(
        uniform((n,), *U_RANGE), normal((n, dim)),
        uniform((n, N_CAND), 0.0, 1.0), uniform((n, N_CAND), *Y_RANGE),
        normal((n, dim)), total_mass=total_mass, scale_radius=scale_radius,
        g_const=config.g_const, eps_sq=config.eps_sq, virialize=virialize)
    return ParticleState.create(pos, vel, mass, dtype=dtype)
