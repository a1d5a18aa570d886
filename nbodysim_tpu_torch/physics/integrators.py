"""Time integration (port of `nbodysim_tpu.physics.integrators`).

The reference step (Simulation.hpp:67-75): forces -> kick + velocity clamp
-> soft boundary -> drift -> collisions, i.e. semi-implicit Euler
(`euler_symplectic`), plus kick-drift-kick leapfrog (`leapfrog_kdk`).

`make_step` returns `state -> state`; `make_rollout` loops it in Python
(the JAX package's `lax.scan`). Every op runs on the state's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.diagnostics import profiling
from nbodysim_tpu_torch.physics.forces import compute_accelerations

AccFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (pos, mass)


def clamp_velocity(vel: torch.Tensor, max_velocity: float) -> torch.Tensor:
    """|v| <= max_velocity, preserving direction (Simulation.hpp:133-138)."""
    v_sq = (vel * vel).sum(-1, keepdim=True)
    scale = torch.where(
        v_sq > max_velocity * max_velocity,
        max_velocity * torch.rsqrt(torch.clamp_min(v_sq, 1e-30)),
        1.0,
    )
    return vel * scale


def apply_soft_boundary(
    pos: torch.Tensor, vel: torch.Tensor, dt, config: SimConfig
) -> torch.Tensor:
    """Soft exponential boundary (Simulation.hpp:140-155): outside
    r > 0.8 * boundary_radius, an inward force BOUNDARY_FORCE * exp(r/soft - 1)
    applied for dt, then velocity damping."""
    soft = config.soft_boundary
    dist_sq = (pos * pos).sum(-1, keepdim=True)
    outside = dist_sq > soft * soft
    inv_dist = torch.rsqrt(torch.clamp_min(dist_sq, 1e-30))
    dist = dist_sq * inv_dist
    force = config.boundary_force * torch.exp(dist / soft - 1.0)
    inward = -pos * inv_dist
    vel_out = (vel + inward * (force * dt)) * config.boundary_damping
    return torch.where(outside, vel_out, vel)


def _euler_symplectic(
    state: ParticleState, dt, acc_fn: AccFn, config: SimConfig
) -> ParticleState:
    """Reference step: kick with a(t), clamp, boundary, drift."""
    acc = acc_fn(state.pos, state.mass)
    vel = state.vel + acc * dt
    if config.enable_velocity_clamp:
        vel = clamp_velocity(vel, config.max_velocity)
    if config.enable_boundary:
        vel = apply_soft_boundary(state.pos, vel, dt, config)
    pos = state.pos + vel * dt
    return state.replace(pos=pos, vel=vel, acc=acc, frame=state.frame + 1)


def _leapfrog_kdk(
    state: ParticleState, dt, acc_fn: AccFn, config: SimConfig
) -> ParticleState:
    """Kick-drift-kick leapfrog; `state.acc` carries a(t) between steps, so
    the first step needs `prime_accelerations`."""
    half = 0.5 * dt
    vel_h = state.vel + state.acc * half
    pos = state.pos + vel_h * dt
    acc = acc_fn(pos, state.mass)
    vel = vel_h + acc * half
    if config.enable_velocity_clamp:
        vel = clamp_velocity(vel, config.max_velocity)
    if config.enable_boundary:
        vel = apply_soft_boundary(pos, vel, dt, config)
    return state.replace(pos=pos, vel=vel, acc=acc, frame=state.frame + 1)


def prime_accelerations(
    state: ParticleState, config: SimConfig, acc_fn: Optional[AccFn] = None
) -> ParticleState:
    """Fill state.acc with a(t0); required before the first leapfrog step."""
    if acc_fn is None:
        acc_fn = lambda p, m: compute_accelerations(p, m, config)
    return state.replace(acc=acc_fn(state.pos, state.mass))


def make_step(
    config: SimConfig,
    acc_fn: Optional[AccFn] = None,
    collide_fn: Optional[Callable[[ParticleState, SimConfig],
                                  ParticleState]] = None,
) -> Callable[[ParticleState], ParticleState]:
    """Build the full step: gravity + integration + collisions."""
    if acc_fn is None:
        acc_fn = lambda p, m: compute_accelerations(p, m, config)
    if collide_fn is None and config.enable_collisions:
        from nbodysim_tpu_torch.physics.collisions import resolve_collisions

        collide_fn = resolve_collisions

    integ = (_euler_symplectic if config.integrator == "euler_symplectic"
             else _leapfrog_kdk)
    # dt rounded to the config dtype, as the JAX step casts it; a Python
    # float holding an f32 value enters every product unchanged.
    dt = float(torch.tensor(config.dt, dtype=config.dtype))

    def step(state: ParticleState, dt=dt) -> ParticleState:
        with profiling.span("step"):
            state = integ(state, dt, acc_fn, config)
            if collide_fn is not None:
                state = collide_fn(state, config)
        return state

    return step


def make_rollout(
    config: SimConfig,
    num_steps: int,
    acc_fn: Optional[AccFn] = None,
) -> Callable[[ParticleState], ParticleState]:
    """`num_steps` steps in a Python loop."""
    step = make_step(config, acc_fn=acc_fn)

    def rollout(state: ParticleState) -> ParticleState:
        for _ in range(num_steps):
            state = step(state)
        return state

    return rollout
