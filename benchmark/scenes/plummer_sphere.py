"""Frozen copy of BASELINE config 2's scene, the Plummer sphere, in plain
PyTorch: the Plummer model (Plummer 1911, MNRAS 71, 460) sampled as
Aarseth, Henon & Wielen 1974 (A&A 37, 183) describe. Density
rho(r) ~ (1 + r^2/a^2)^(-5/2): radius from the inverse of the enclosed-mass
fraction, isotropic directions, speeds q v_esc with f(q) ~ q^2 (1 - q^2)^(7/2)
by rejection over N_CAND candidates a body; equal masses; net momentum
zeroed and the centre of mass moved to the origin.

It makes the same state as `nbodysim_tpu_torch.scenes.plummer.plummer_sphere`
with `virialize=False` did when this copy was taken, bit for bit
(benchmark/tests checks that at small N), so that an edit to the program's
scenes cannot move the benchmark's inputs. It imports nothing of the
program. The draws come from a torch.Generator seeded with `seed` on
`device`. The virial rescale of the program's scene is left out: it takes
the exact O(N^2) potential of the realized bodies once, and the sampled
speeds already follow the model's own equilibrium distribution.
"""

from __future__ import annotations

import math

import torch

N_CAND = 16                   # speed candidates a body; first accept wins
U_RANGE = (1e-6, 1.0 - 1e-6)  # enclosed-mass quantile
Y_RANGE = (0.0, 0.1)          # rejection ordinate (max of f(q) is ~0.092)


def make(params: dict, seed: int, device) -> dict:
    """The scene as {pos, vel, mass, radius} float32 tensors on `device`,
    radius = cbrt(mass). `params`: {"n": bodies, "dim": 2 or 3,
    "total_mass", "scale_radius", "g_const", "virialize": false}."""
    if params.get("virialize", False):
        raise ValueError("the frozen Plummer scene has no virial rescale")
    n = int(params["n"])
    dim = int(params.get("dim", 3))
    total_mass = float(params.get("total_mass", 1.0e4))
    a = float(params.get("scale_radius", 1000.0))
    g_const = float(params.get("g_const", 1.0))
    dtype = torch.float32
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype,
                                           device=device)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    u = uniform((n,), *U_RANGE)
    dir_pos = normal((n, dim))
    qs = uniform((n, N_CAND), 0.0, 1.0)
    ys = uniform((n, N_CAND), *Y_RANGE)
    dir_vel = normal((n, dim))

    r = a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * (dir_pos / dir_pos.norm(dim=-1, keepdim=True))
    # The first accepted candidate; 0.5 where none is (p < 1e-4 a body).
    accept = ys < qs ** 2 * (1.0 - qs ** 2) ** 3.5
    first = torch.argmax(accept.to(torch.int32), dim=1)
    q = torch.where(accept.any(dim=1), qs.gather(1, first[:, None])[:, 0],
                    0.5)
    v_esc = math.sqrt(2.0 * g_const * total_mass) * (r * r + a * a) ** (-0.25)
    vel = (q * v_esc)[:, None] * (dir_vel / dir_vel.norm(dim=-1,
                                                          keepdim=True))
    mass = torch.full((n,), total_mass / n, dtype=dtype, device=device)
    vel = vel - (vel * mass[:, None]).mean(0) / mass.mean()
    pos = pos - (pos * mass[:, None]).mean(0) / mass.mean()
    radius = torch.sign(mass) * torch.abs(mass).pow(1.0 / 3.0)
    return {"pos": pos, "vel": vel, "mass": mass, "radius": radius}
