"""Collision detection and response, dense branch (port of
`nbodysim_tpu.physics.collisions`).

Reference semantics (Simulation.hpp:216-346) resolved as one Jacobi pass:
every particle sums its own side of each overlapping pair's correction and
all corrections apply at once (see the JAX module's docstring for the
derivation). The per-pair math is antisymmetric, so momentum is conserved.

Ported: the dense O(N^2) broad phase, which 'auto' picks while
N <= DENSE_THRESHOLD; its narrow phase is the CUDA kernel K2
(kernels/collide.py) on a CUDA tensor. The bucket grid, sorted hash and
lex-sorted block broad phases (and so 'auto' above the threshold) are
ROADMAP slice 3 and raise NotImplementedError before any pair work.
"""

from __future__ import annotations

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.kernels.collide import (  # noqa: F401 (_pair_deltas)
    _pair_deltas,
    allpairs_collision_deltas,
    collision_deltas_plain,
)

DENSE_THRESHOLD = 65536


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is ROADMAP slice 3 and not ported yet; set "
        f"collision_broad_phase='dense' to run the O(N^2) pass at this N, "
        f"or enable_collisions=False")


def resolve_collision_backend(config: SimConfig, device) -> str:
    """"cuda" or "torch" for the dense narrow phase on `device`; an
    explicit "cuda" on a CPU device raises."""
    device = torch.device(device)
    backend = config.collision_backend
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"collision_backend='cuda' needs a CUDA tensor, got one on "
            f"{device}")
    return backend


def _dense_pass(state: ParticleState, config: SimConfig) -> ParticleState:
    """Exact O(N^2) masked Jacobi collision pass: K2 on the card, the
    blocked plain version otherwise."""
    pos, vel = state.pos, state.vel
    if resolve_collision_backend(config, pos.device) == "cuda":
        dp, dv = allpairs_collision_deltas(
            pos, vel, state.mass, state.radius,
            impulse=config.collision_impulse)
    else:
        dp, dv = collision_deltas_plain(
            pos, vel, state.mass, state.radius,
            impulse=config.collision_impulse)
    return state.replace(pos=pos + dp, vel=vel + dv)


def _broad_phase(state: ParticleState, config: SimConfig) -> str:
    bp = config.collision_broad_phase
    if bp == "auto":
        if state.n <= DENSE_THRESHOLD:
            return "dense"
        raise _not_ported(
            f"the automatic large-N broad phase (N={state.n} > "
            f"{DENSE_THRESHOLD})")
    if bp != "dense":
        raise _not_ported(f"collision_broad_phase={bp!r}")
    return bp


def resolve_collision_phase_for_state(state: ParticleState,
                                      config: SimConfig) -> SimConfig:
    """Occupancy probe of the JAX package, reduced to its N <= 65,536
    branch, where nothing needs probing. Above it, and for any broad phase
    other than 'dense', raises NotImplementedError."""
    if config.enable_collisions:
        _broad_phase(state, config)
    return config


def resolve_collisions(state: ParticleState,
                       config: SimConfig) -> ParticleState:
    """Full collision step: broad phase + Jacobi narrow phase, iterated."""
    if not config.enable_collisions:
        return state
    _broad_phase(state, config)
    for _ in range(max(1, config.collision_iterations)):
        state = _dense_pass(state, config)
    return state
