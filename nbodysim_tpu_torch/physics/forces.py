"""Gravitational accelerations (port of `nbodysim_tpu.physics.forces`).

Plummer-softened Newtonian monopole,

    a_i = G * sum_j m_j * (x_j - x_i) * (|x_j - x_i|^2 + eps^2)^(-3/2),

with the self/coincident term skipped (reference Quadtree.hpp:124).

  * `direct_accelerations`  — exact O(N^2) plain torch, blocked; the CPU
    path and the reference on the card.
  * `compute_accelerations` — dispatch: the CUDA kernel K1
    (kernels/allpairs.py) or the plain version, per `force_backend`.

The tree code (`"bh"`, automatic from N = 100k) is ROADMAP slice 2 and not
ported yet: asking for it raises NotImplementedError and never falls back to
the exact path silently.
"""

from __future__ import annotations

from typing import Optional

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.blocking import pairwise_blocked
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations,
    allpairs_accelerations_plain,
)

# Exact/tree crossovers of the JAX package (forces.py:205,210). The tree
# side is not ported, so 'auto' at or above them raises.
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
    """sum_{i in tgt, j in src, d != 0} m_i m_j / sqrt(d^2 + eps^2)."""

    def kernel(t, s):
        tp, tm = t
        sp, sm = s
        d = sp[None, :, :] - tp[:, None, :]
        d_sq = (d * d).sum(-1)
        pair = tm[:, None] * sm[None, :] * torch.rsqrt(d_sq + eps_sq)
        return (torch.where(d_sq > 0.0, pair, 0.0).sum(1),)

    (per_target,) = pairwise_blocked(
        kernel, (tgt, tgt_m), (src, src_m), out_dims=((),),
        dtype=tgt.dtype, bs_t=block_size, bs_s=2 * block_size)
    return per_target.sum()


def potential_energy(
    pos: torch.Tensor,
    mass: torch.Tensor,
    eps_sq: float,
    g_const: float = 1.0,
    block_size: int = 2048,
) -> torch.Tensor:
    """U = -G/2 * sum_{i != j} m_i m_j / sqrt(d^2 + eps^2); the exact
    potential of the force law above. A 0-dim tensor."""
    return -0.5 * g_const * _partial_potential(
        pos, mass, pos, mass, eps_sq, block_size)


def resolve_backend(config: SimConfig, n: int, dim: int,
                    device: torch.device) -> str:
    """Resolve `config.force_backend` to "cuda" or "torch" for `n` bodies
    on `device`.

    'auto' picks the CUDA kernel on a CUDA device and the plain version on
    the CPU. An explicit "cuda" runs K1 at any N, but raises on a CPU
    device. The tree code — explicit "bh", or 'auto' at N >= 100k — raises
    NotImplementedError."""
    device = torch.device(device)
    backend = config.force_backend
    threshold = BH_AUTO_THRESHOLD if dim == 2 else BH3_AUTO_THRESHOLD
    if backend == "bh" or (backend == "auto" and n >= threshold):
        raise NotImplementedError(
            f"the tree code (force_backend='bh', automatic from N="
            f"{threshold}) is ROADMAP slice 2 and not ported yet; for "
            f"N={n} set force_backend='cuda' or 'torch' to run the exact "
            f"O(N^2) forces")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"force_backend='cuda' needs a CUDA tensor, got one on {device}")
    return backend


def resolve_config_for_state(pos, mass, config: SimConfig) -> SimConfig:
    """Pin 'auto' to the concrete backend for this state (the JAX package
    also probes tree occupancy here; that belongs to slice 2)."""
    return config.replace(force_backend=resolve_backend(
        config, pos.shape[0], pos.shape[1], pos.device))


def compute_accelerations(
    pos: torch.Tensor,
    mass: torch.Tensor,
    config: SimConfig,
) -> torch.Tensor:
    """Dispatch to the configured force backend."""
    backend = resolve_backend(config, pos.shape[0], pos.shape[1], pos.device)
    if backend == "cuda":
        return allpairs_accelerations(
            pos, mass, eps_sq=config.eps_sq, g_const=config.g_const)
    return direct_accelerations(
        pos, mass, eps_sq=config.eps_sq, g_const=config.g_const)
