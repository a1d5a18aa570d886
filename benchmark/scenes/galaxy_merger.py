"""Frozen copy of BASELINE config 5's scene, the galaxy merger, in plain
PyTorch: two exponential discs (scale length R/4, truncated at R, R =
sqrt(n/2) * 150), each a central mass 5e8 and satellites on circular
orbits about it, set 3R apart with impact parameter R/2 and approaching at
half their mutual orbital speed.

It makes the same state as `nbodysim_tpu_torch.scenes.galaxy.galaxy_merger`
did when this copy was taken, bit for bit (benchmark/tests checks that at
small N), so that an edit to the program's scenes cannot move the
benchmark's inputs. It imports nothing of the program. The uniform draws
come from a torch.Generator seeded with `seed` on `device`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CENTRAL_MASS = 5.0e8
U_RANGE = (1e-4, 1.0 - 1e-4)
PHI_RANGE = (0.0, 2.0 * math.pi)
MASS_RANGE = (0.1, 2.0)


def _disc(draws, central_mass: float, disc_radius: float, dim: int,
          g_const: float):
    u, phi, sat_mass = draws
    dtype, device = u.dtype, u.device
    scale_len = disc_radius / 4.0
    e = torch.exp(torch.tensor(-disc_radius / scale_len, dtype=dtype))
    r = -scale_len * torch.log1p(-u * (1.0 - e.to(device)))
    r = torch.clamp(r, disc_radius * 0.02, disc_radius)
    x, y = r * torch.cos(phi), r * torch.sin(phi)
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


def make(params: dict, seed: int, device) -> dict:
    """The scene as {pos, vel, mass, radius} float32 tensors on `device`.
    `params`: {"n": bodies, "dim": 2 or 3, "g_const": G}."""
    n = int(params["n"])
    dim = int(params.get("dim", 2))
    g_const = float(params.get("g_const", 1.0))
    dtype = torch.float32
    device = torch.device(device)
    f32 = np.float32
    disc_radius = float(np.sqrt(f32(n / 2)) * f32(150.0))
    separation = 3.0 * disc_radius
    impact = 0.5 * disc_radius
    approach = float(f32(0.5) * np.sqrt(
        f32(g_const * 2 * CENTRAL_MASS / separation)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(m, lo, hi):
        return lo + (hi - lo) * torch.rand(m, generator=gen, dtype=dtype,
                                           device=device)

    draws = [tuple(uniform(m - 1, *rng)
                   for rng in (U_RANGE, PHI_RANGE, MASS_RANGE))
             for m in (n // 2, n - n // 2)]
    p1, v1, m1 = _disc(draws[0], CENTRAL_MASS, disc_radius, dim, g_const)
    p2, v2, m2 = _disc(draws[1], CENTRAL_MASS, disc_radius, dim, g_const)

    def vec(x, y):
        out = torch.zeros(dim, dtype=dtype, device=device)
        out[0], out[1] = x, y
        return out

    pos = torch.cat([p1 + vec(-separation / 2, -impact / 2),
                     p2 + vec(separation / 2, impact / 2)])
    vel = torch.cat([v1 + vec(approach / 2, 0.0),
                     v2 + vec(-approach / 2, 0.0)])
    mass = torch.cat([m1, m2])
    radius = torch.sign(mass) * torch.abs(mass).pow(1.0 / 3.0)
    return {"pos": pos, "vel": vel, "mass": mass, "radius": radius}
