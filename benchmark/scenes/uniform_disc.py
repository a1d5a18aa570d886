"""Frozen copy of the reference simulator's flagship scene, the
Lorenz-attractor disc (Simulation.hpp:347-603), in plain PyTorch.

It makes the same state as `nbodysim_tpu_torch.scenes.disc.uniform_disc`
did when this copy was taken, bit for bit (benchmark/tests checks that at
small N), so that an edit to the program's scenes cannot move the
benchmark's inputs. It imports nothing of the program.

  - central body: mass 1e9, radius 200, at the origin
  - outer radius sqrt(n) * 300.7; n - 1 bodies on a Lorenz track
    (sigma 10, rho 28, beta 8/3, x0 0.1, step 0.01), position (x, y) *
    outer_radius / 10
  - tangential unit velocity rescaled to sqrt(M_enclosed / r) after a
    stable sort by distance
  - masses from 3 buckets {82.5%: [5e-5, 0.8], 12.5%: [1.2, 2.5],
    2.5%: [5, 50]} drawn from a torch.Generator seeded with `seed` on
    `device`; radius = cbrt(mass)
"""

from __future__ import annotations

import numpy as np
import torch

CENTRAL_MASS = 1.0e9
CENTRAL_RADIUS = 200.0
OUTER_RADIUS_COEF = 300.7
MASS_BUCKETS = ((0.00005, 0.8, 0.825), (1.2, 2.5, 0.125), (5.0, 50.0, 0.025))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _lorenz_track(n: int) -> np.ndarray:
    """n steps of the Lorenz attractor in f32 scalars: the (x, y) track."""
    f = np.float32
    sigma, rho, beta, dt = f(10.0), f(28.0), f(8.0 / 3.0), f(0.01)
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


def _bucket_masses(gen: torch.Generator, n: int, dtype, device):
    probs = torch.tensor([b[2] for b in MASS_BUCKETS], dtype=torch.float64)
    edges = (torch.cumsum(probs, 0) / probs.sum())[:-1].to(dtype).to(device)
    u_bucket = torch.rand(n, generator=gen, dtype=dtype, device=device)
    idx = torch.bucketize(u_bucket, edges, right=True)
    lo = torch.tensor([b[0] for b in MASS_BUCKETS], dtype=dtype,
                      device=device)[idx]
    hi = torch.tensor([b[1] for b in MASS_BUCKETS], dtype=dtype,
                      device=device)[idx]
    u = torch.rand(n, generator=gen, dtype=dtype, device=device)
    return lo + u * (hi - lo)


def make(params: dict, seed: int, device) -> dict:
    """The scene as {pos, vel, mass, radius} float32 tensors on `device`.
    `params`: {"n": bodies}; the scene is 2D."""
    n = int(params["n"])
    dtype = torch.float32
    device = torch.device(device)
    outer = torch.sqrt(torch.tensor(float(n), dtype=dtype)) * OUTER_RADIUS_COEF
    track = torch.from_numpy(_lorenz_track(n - 1)).to(device)
    pos_sat = track * (outer / 10.0).to(device)
    tangent = torch.stack([-pos_sat[:, 1], pos_sat[:, 0]], dim=-1)
    norm = torch.linalg.vector_norm(tangent, dim=-1, keepdim=True)
    vel_sat = tangent / torch.where(norm > 0, norm, 1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mass_sat = _bucket_masses(gen, n - 1, dtype, device)
    zeros = torch.zeros((1, 2), dtype=dtype, device=device)
    pos = torch.cat([zeros, pos_sat])
    vel = torch.cat([zeros, vel_sat])
    mass = torch.cat([torch.full((1,), CENTRAL_MASS, dtype=dtype,
                                 device=device), mass_sat])
    radius = torch.cat([torch.full((1,), CENTRAL_RADIUS, dtype=dtype,
                                   device=device), _cbrt(mass_sat)])
    order = torch.argsort((pos * pos).sum(-1), stable=True)
    pos, vel, mass, radius = pos[order], vel[order], mass[order], radius[order]
    m_enc = torch.cumsum(mass, 0)
    r = torch.sqrt((pos * pos).sum(-1))
    v_circ = torch.sqrt(m_enc / torch.where(r > 0, r, 1.0))
    vel = vel * torch.where(r > 0, v_circ, 0.0)[:, None]
    return {"pos": pos, "vel": vel, "mass": mass, "radius": radius}
