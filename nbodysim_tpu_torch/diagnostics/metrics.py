"""Diagnostics (port of `nbodysim_tpu.diagnostics.metrics`).

* `diagnostics(state, config)` — conserved quantities: kinetic, potential
  and total energy, momentum, angular momentum, center of mass.
* `system_metrics(state, config)` — the reference HUD panel
  (`calculateMetrics`, main.cpp:91-194) with SURVEY bugs #1 and #2 fixed,
  as in the JAX package.

Everything stays on the state's device as 0-dim or small tensors.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.physics.forces import potential_energy


class Diagnostics(NamedTuple):
    kinetic: torch.Tensor          # sum 1/2 m v^2
    potential: torch.Tensor        # softened pairwise potential
    total_energy: torch.Tensor
    momentum: torch.Tensor         # [D]
    angular_momentum: torch.Tensor # scalar L_z (2D) or [3] (3D)
    center_of_mass: torch.Tensor   # [D]
    total_mass: torch.Tensor
    max_speed: torch.Tensor


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    v_sq = (state.vel * state.vel).sum(-1)
    return 0.5 * (state.mass * v_sq).sum()


def angular_momentum(state: ParticleState) -> torch.Tensor:
    """L about the origin: scalar in 2D, vector in 3D."""
    pos, vel = state.pos, state.vel
    if state.dim == 2:
        return (state.mass * (pos[:, 0] * vel[:, 1]
                              - pos[:, 1] * vel[:, 0])).sum()
    return (state.mass[:, None] * torch.cross(pos, vel, dim=-1)).sum(0)


def diagnostics(state: ParticleState, config: SimConfig) -> Diagnostics:
    """Conserved-quantity panel."""
    ke = kinetic_energy(state)
    pe = potential_energy(state.pos, state.mass, config.eps_sq,
                          config.g_const)
    total_mass = state.mass.sum()
    mom = (state.mass[:, None] * state.vel).sum(0)
    com = (state.mass[:, None] * state.pos).sum(0) / total_mass
    max_speed = torch.sqrt((state.vel * state.vel).sum(-1).max())
    return Diagnostics(
        kinetic=ke,
        potential=pe,
        total_energy=ke + pe,
        momentum=mom,
        angular_momentum=angular_momentum(state),
        center_of_mass=com,
        total_mass=total_mass,
        max_speed=max_speed,
    )


def system_metrics(
    state: ParticleState,
    config: SimConfig,
    dt_scaled: bool = False,
    smoothed_dt: float | None = None,
) -> Dict[str, torch.Tensor]:
    """Reference HUD metrics (main.cpp:91-194), corrected; see the JAX
    function for the selection rules. With `dt_scaled=True`, reproduces the
    reference's dt-smoothed display rescaling (main.cpp:187-191)."""
    pos, vel, mass = state.pos, state.vel, state.mass
    n = pos.shape[0]
    dt = config.dt if smoothed_dt is None else smoothed_dt
    f32 = pos.dtype

    # System bounding radius (main.cpp:97-110).
    min_b = pos.min(0).values
    max_b = pos.max(0).values
    system_radius = 0.5 * torch.linalg.vector_norm(max_b - min_b)
    base_orbital_radius = torch.clamp_min(system_radius, 1000.0)

    total_mass = mass.sum()
    com = (mass[:, None] * pos).sum(0) / total_mass

    # Central body: mass > 10% total, nearest COM (main.cpp:121-136).
    heavy = mass > 0.1 * total_mass
    dist_sq_com = ((pos - com) ** 2).sum(-1)
    score = torch.where(heavy, dist_sq_com, math.inf)
    c = torch.argmin(score)
    has_central = heavy.any()

    c_pos, c_vel, c_mass = pos[c], vel[c], mass[c]

    r = pos - c_pos
    dist = torch.linalg.vector_norm(r, dim=-1)
    rel_vel = vel - c_vel
    speed_sq = (rel_vel * rel_vel).sum(-1)

    # Escape-velocity stability filter (main.cpp:144-164), in the state's
    # dtype as the JAX package computes it.
    escape_threshold = 2.0 * (1.0 + torch.log10(
        torch.tensor(dt + 1.0, dtype=f32, device=pos.device)))
    safe_dist = torch.where(dist > 0, dist, 1.0)
    escape_speed_sq = 2.0 * c_mass / safe_dist
    is_self = torch.arange(n, device=pos.device) == c
    stable = (
        ~is_self
        & (dist <= base_orbital_radius * 2.0)
        & (speed_sq < escape_speed_sq * escape_threshold)
    )
    n_stable = stable.sum()
    safe_n = torch.clamp_min(n_stable, 1)

    zero = torch.zeros((), dtype=f32, device=pos.device)
    ke = torch.where(stable, 0.5 * mass * speed_sq, zero).sum()
    pe = torch.where(stable, -mass * c_mass / safe_dist, zero).sum()
    period = torch.where(
        stable, 2.0 * math.pi * torch.sqrt(safe_dist ** 3 / c_mass), zero,
    ).sum() / safe_n
    net_force = torch.where(
        stable, mass * c_mass / (safe_dist * safe_dist), zero).sum()
    avg_speed = torch.where(stable, torch.sqrt(speed_sq), zero).sum() / safe_n

    if dt_scaled:
        # main.cpp:187-191 display scaling.
        ke = ke * dt
        pe = pe * dt
        net_force = net_force * dt
        avg_speed = avg_speed * math.sqrt(dt)
        period = period * dt

    return {
        "central_mass": torch.where(has_central, c_mass, zero),
        "total_mass": total_mass,
        "kinetic_energy": torch.where(has_central, ke, zero),
        "potential_energy": torch.where(has_central, pe, zero),
        "total_energy": torch.where(has_central, ke + pe, zero),
        "avg_orbital_period": torch.where(has_central, period, zero),
        "net_force": torch.where(has_central, net_force, zero),
        "avg_speed": torch.where(has_central, avg_speed, zero),
        "stable_bodies": torch.where(has_central, n_stable, 0),
    }


class EnergyTracker:
    """Host-side drift tracker: records E(t) and reports |dE/E| vs E(t0)."""

    def __init__(self, config: SimConfig):
        self.config = config
        self._e0 = None
        self.history: list[float] = []

    def update(self, state: ParticleState) -> float:
        e = float(diagnostics(state, self.config).total_energy)
        if self._e0 is None:
            self._e0 = e
        self.history.append(e)
        denom = abs(self._e0) if self._e0 != 0 else 1.0
        return abs(e - self._e0) / denom

    @property
    def max_drift(self) -> float:
        if self._e0 is None or not self.history:
            return 0.0
        denom = abs(self._e0) if self._e0 != 0 else 1.0
        return max(abs(e - self._e0) / denom for e in self.history)
