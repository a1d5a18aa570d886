"""Gravitational accelerations (port of `nbodysim_tpu.physics.forces`).

Plummer-softened Newtonian monopole,

    a_i = G * sum_j m_j * (x_j - x_i) * (|x_j - x_i|^2 + eps^2)^(-3/2),

with the self/coincident term skipped (reference Quadtree.hpp:124).

  * `direct_accelerations`  — exact O(N^2) plain torch, blocked; the CPU
    path and the reference on the card.
  * `compute_accelerations` — dispatch: the CUDA kernel K1
    (kernels/allpairs.py) or the plain version, or the tree code (`"bh"`,
    automatic from N = 100k: physics/barneshut.py, the quadtree in 2D and
    the octree in 3D), per `force_backend`.

`resolve_config_for_state` pins 'auto' from the state, as the JAX
package's does; once it has picked the tree, the tree pins its own
choices (`barneshut.resolve_tree_for_state`).
"""

from __future__ import annotations

from typing import Optional

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.diagnostics import profiling
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations,
    allpairs_accelerations_plain,
    allpairs_potential,
    allpairs_potential_plain,
)
from nbodysim_tpu_torch.physics.barneshut import (
    bh_accelerations, resolve_tree_for_state)

# Exact/tree crossovers of the JAX package (forces.py:205,210).
BH_AUTO_THRESHOLD = 100_000
BH3_AUTO_THRESHOLD = 100_000


def direct_accelerations(
    pos: torch.Tensor,
    mass: Optional[torch.Tensor],
    eps_sq: float,
    g_const: float = 1.0,
    block_size: int = 2048,
    src_pos: Optional[torch.Tensor] = None,
    src_mass: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact O(N^2) softened gravity in plain torch, blocked over both axes.

    With `src_pos`/`src_mass`, accelerations on `pos` due to those sources
    only; the positional `mass` is then unused and may be None.
    """
    return allpairs_accelerations_plain(
        pos, mass, eps_sq=eps_sq, g_const=g_const, src_pos=src_pos,
        src_mass=src_mass, block_size=block_size)


def _partial_potential(tgt, tgt_m, src, src_m, eps_sq: float,
                       block_size: int = 2048) -> torch.Tensor:
    """sum_{i in tgt, j in src, d != 0} m_i m_j / sqrt(d^2 + eps^2), plain
    torch on any device."""
    return allpairs_potential_plain(tgt, tgt_m, eps_sq=eps_sq, src_pos=src,
                                    src_mass=src_m, block_size=block_size)


def potential_energy(
    pos: torch.Tensor,
    mass: torch.Tensor,
    eps_sq: float,
    g_const: float = 1.0,
    block_size: int = 2048,
) -> torch.Tensor:
    """U = -G/2 * sum_{i != j} m_i m_j / sqrt(d^2 + eps^2); the exact
    potential of the force law above. A 0-dim tensor: on a CUDA tensor from
    the potential kernel (kernels/allpairs.py), on a CPU tensor from the
    plain version blocked by `block_size`."""
    return -0.5 * g_const * allpairs_potential(
        pos, mass, eps_sq=eps_sq, block_size=block_size)


def resolve_backend(config: SimConfig, n: int, dim: int,
                    device: torch.device) -> str:
    """Resolve `config.force_backend` to "cuda", "torch" or "bh" for `n`
    bodies on `device`.

    'auto' picks the tree code from N = 100k (quadtree in 2D, octree in
    3D), and below it the CUDA kernel on a CUDA device and the plain
    version on the CPU. An explicit "cuda" runs K1 at any N, but raises on
    a CPU device."""
    device = torch.device(device)
    backend = config.force_backend
    threshold = BH_AUTO_THRESHOLD if dim == 2 else BH3_AUTO_THRESHOLD
    if backend == "auto" and n >= threshold:
        backend = "bh"
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"force_backend='cuda' needs a CUDA tensor, got one on {device}")
    return backend


def resolve_config_for_state(pos, mass, config: SimConfig) -> SimConfig:
    """State-aware 'auto' resolution: pin the backend, and when 'auto'
    picks the tree code, let the tree pin its own choices from the actual
    particles (`barneshut.resolve_tree_for_state`: the deep-overflow chain
    and its tiles where the buckets overflow past the exact residual's
    capacity, with a RuntimeWarning, in 2D and 3D, and `bh_nf_sparse`), as
    the JAX package does. An explicit force_backend='bh' keeps the user's
    choice (with the capacity warning of `api.Simulation.check_capacity`)."""
    n, dim = pos.shape[0], pos.shape[1]
    backend = resolve_backend(config, n, dim, pos.device)
    if backend != "bh" or config.force_backend != "auto":
        return config.replace(force_backend=backend)
    return resolve_tree_for_state(pos, mass,
                                  config.replace(force_backend="bh"))


def compute_accelerations(
    pos: torch.Tensor,
    mass: torch.Tensor,
    config: SimConfig,
) -> torch.Tensor:
    """Dispatch to the configured force backend (the span `forces`)."""
    backend = resolve_backend(config, pos.shape[0], pos.shape[1], pos.device)
    with profiling.span("forces"):
        if backend == "bh":
            return bh_accelerations(pos, mass, config)
        if backend == "cuda":
            return allpairs_accelerations(
                pos, mass, eps_sq=config.eps_sq, g_const=config.g_const)
        return direct_accelerations(
            pos, mass, eps_sq=config.eps_sq, g_const=config.g_const)
