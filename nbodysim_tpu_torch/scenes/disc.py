"""The reference's flagship scene: Lorenz-attractor disc (port of
`nbodysim_tpu.scenes.disc`; reference Simulation.hpp:347-603).

  - central body: mass 1e9, radius 200, at the origin (hpp:358-359)
  - outer_radius = sqrt(n) * 300.7 (hpp:353)
  - n-1 bodies on a Lorenz attractor track (sigma=10, rho=28, beta=8/3,
    x0=0.1, dt=0.01), position = (x, y) * outer_radius/10
  - tangential unit velocity, rescaled to the circular speed
    sqrt(M_enclosed / r) after sorting by distance (hpp:584-600)
  - masses from 3 buckets {82.5%: [5e-5, 0.8], 12.5%: [1.2, 2.5],
    2.5%: [5, 50]}; radius = cbrt(mass)

The Lorenz track is deterministic f32 arithmetic, the operations of the JAX
scan as written, each rounded. XLA on the CPU fuses them into FMAs, so the
two tracks differ in the last bit from point ~50 and, the attractor being
chaotic, visibly after a few hundred points. The masses come from a
`torch.Generator` seeded with `config.seed` on the target device; they cannot
match `jax.random` bit for bit (ROADMAP fault F3).
"""

from __future__ import annotations

import numpy as np
import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState, cbrt

CENTRAL_MASS = 1.0e9
CENTRAL_RADIUS = 200.0
OUTER_RADIUS_COEF = 300.7

LORENZ_SIGMA = 10.0
LORENZ_RHO = 28.0
LORENZ_BETA = 8.0 / 3.0
LORENZ_DT = 0.01

MASS_BUCKETS = (
    # (min_mass, max_mass, probability) — Simulation.hpp:373-377
    (0.00005, 0.8, 0.825),
    (1.2, 2.5, 0.125),
    (5.0, 50.0, 0.025),
)


def _lorenz_positions(n: int) -> np.ndarray:
    """Integrate the Lorenz attractor n steps in f32; (x, y) track [n, 2].

    A sequential recurrence, so it runs on the host in numpy f32 scalars."""
    f = np.float32
    sigma, rho, beta, dt = (f(LORENZ_SIGMA), f(LORENZ_RHO), f(LORENZ_BETA),
                            f(LORENZ_DT))
    x, y, z = f(0.1), f(0.0), f(0.0)
    track = np.empty((n, 2), np.float32)
    for k in range(n):
        dx = sigma * (y - x)
        dy = x * (rho - z) - y
        dz = x * y - beta * z
        x, y, z = x + dx * dt, y + dy * dt, z + dz * dt
        track[k, 0] = x
        track[k, 1] = y
    return track


def sample_bucket_masses(generator: torch.Generator, n: int, dtype,
                         device) -> torch.Tensor:
    """3-bucket mass distribution (Simulation.hpp:373-377, 565-577)."""
    probs = torch.tensor([b[2] for b in MASS_BUCKETS], dtype=torch.float64)
    edges = (torch.cumsum(probs, 0) / probs.sum())[:-1].to(dtype).to(device)
    u_bucket = torch.rand(n, generator=generator, dtype=dtype, device=device)
    idx = torch.bucketize(u_bucket, edges, right=True)
    lo = torch.tensor([b[0] for b in MASS_BUCKETS], dtype=dtype,
                      device=device)[idx]
    hi = torch.tensor([b[1] for b in MASS_BUCKETS], dtype=dtype,
                      device=device)[idx]
    u = torch.rand(n, generator=generator, dtype=dtype, device=device)
    return lo + u * (hi - lo)


def uniform_disc(
    config: SimConfig,
    n: int | None = None,
    ref_normalize_bug: bool = False,
    *,
    device="cuda",
) -> ParticleState:
    """Lorenz-attractor disc with a central massive body, on `device`.

    `ref_normalize_bug=True` reproduces the reference's broken
    `Vec2::normalize()` (x divided by |v| twice, Vec2.hpp:229-234).
    """
    if n is None:
        n = config.n
    dtype = config.dtype
    if config.dim != 2:
        raise ValueError("uniform_disc is a 2D scene (reference is 2D)")
    device = torch.device(device)

    outer_radius = torch.sqrt(torch.tensor(float(n), dtype=dtype))
    outer_radius = outer_radius * OUTER_RADIUS_COEF
    track = torch.from_numpy(_lorenz_positions(n - 1)).to(device)
    pos_sat = track * (outer_radius / 10.0).to(device)

    # Tangential unit velocities (hpp:537-538).
    tangent = torch.stack([-pos_sat[:, 1], pos_sat[:, 0]], dim=-1)
    norm = torch.linalg.vector_norm(tangent, dim=-1, keepdim=True)
    safe = torch.where(norm > 0, norm, 1.0)
    if ref_normalize_bug:
        vel_sat = torch.stack(
            [tangent[:, 0] / safe[:, 0] ** 2, tangent[:, 1] / safe[:, 0]],
            dim=-1)
    else:
        vel_sat = tangent / safe

    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)
    mass_sat = sample_bucket_masses(generator, n - 1, dtype, device)

    # Prepend the central body (hpp:358-359).
    zeros = torch.zeros((1, 2), dtype=dtype, device=device)
    pos = torch.cat([zeros, pos_sat])
    vel = torch.cat([zeros, vel_sat])
    mass = torch.cat([torch.full((1,), CENTRAL_MASS, dtype=dtype,
                                 device=device), mass_sat])
    radius = torch.cat([torch.full((1,), CENTRAL_RADIUS, dtype=dtype,
                                   device=device), cbrt(mass_sat)])

    # Sort by distance from center (hpp:584-589); the central body has r=0
    # and stays first.
    order = torch.argsort((pos * pos).sum(-1), stable=True)
    pos, vel, mass, radius = pos[order], vel[order], mass[order], radius[order]

    # Circular-orbit speed from enclosed mass, v = sqrt(M_enc / r)
    # (hpp:591-600; M_enc includes the body's own mass).
    m_enc = torch.cumsum(mass, 0)
    r = torch.sqrt((pos * pos).sum(-1))
    v_circ = torch.sqrt(m_enc / torch.where(r > 0, r, 1.0))
    vel = vel * torch.where(r > 0, v_circ, 0.0)[:, None]

    return ParticleState.create(pos, vel, mass, radius, dtype=dtype)
