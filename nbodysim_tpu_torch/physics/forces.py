"""Gravitational accelerations (port of `nbodysim_tpu.physics.forces`).

Plummer-softened Newtonian monopole,

    a_i = G * sum_j m_j * (x_j - x_i) * (|x_j - x_i|^2 + eps^2)^(-3/2),

with the self/coincident term skipped (reference Quadtree.hpp:124).

  * `direct_accelerations`  — exact O(N^2) plain torch, blocked; the CPU
    path and the reference on the card.
  * `compute_accelerations` — dispatch: the CUDA kernel K1
    (kernels/allpairs.py) or the plain version, or the tree code (`"bh"`,
    automatic from N = 100k: the quadtree of physics/barneshut.py in 2D,
    the octree of physics/barneshut3d.py in 3D), per `force_backend`.

`resolve_config_for_state` pins 'auto' from the state, as the JAX
package's does: past the near-field buckets' residual capacity it turns on
the tree's deep-overflow chain (2D and 3D), and in 3D it pins the sparse
near field (`bh_nf_sparse`) from the bucket-tier target count.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.blocking import pairwise_blocked
from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations,
    allpairs_accelerations_plain,
)
from nbodysim_tpu_torch.physics.barneshut import (
    _OVERFLOW_CAP, bh_accelerations, bh_near_overflow)
from nbodysim_tpu_torch.physics.barneshut3d import (
    _NF_SPARSE_CAP, _resolve_deep_levels3, _resolve_levels3,
    bh3_bucket_tier_count, bh3_near_overflow)

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
    picks the tree code, probe the near-field bucket occupancy of the
    actual particles once (`bh_near_overflow`, `bh3_near_overflow` in 3D)
    and pin `bh_nf_sparse` (`_resolve_nf_sparse`). Where the overflow
    exceeds the exact residual's capacity, the scene is too clustered for
    the buckets alone: this warns (RuntimeWarning) and turns on the
    deep-overflow chain and its tiles (bh_deep_levels=-1), in 2D and 3D, as
    the JAX package does. An explicit force_backend='bh' keeps the user's
    choice (with the capacity warning of `api.Simulation.check_capacity`)."""
    n, dim = pos.shape[0], pos.shape[1]
    backend = resolve_backend(config, n, dim, pos.device)
    if backend != "bh" or config.force_backend != "auto":
        return config.replace(force_backend=backend)
    probe = bh3_near_overflow if dim == 3 else bh_near_overflow
    over = probe(pos, mass, config)
    if over > _OVERFLOW_CAP and config.bh_deep_levels == 0:
        warnings.warn(
            f"auto force backend: near-field overflow {over} exceeds the "
            f"exact-residual capacity {_OVERFLOW_CAP}; enabling the "
            f"deep-overflow multipole chain + tile refinement (tree-PM "
            f"regime: forces inside ultra-dense cells are smoothed at the "
            f"deep/tile-grid scale). Set force_backend explicitly to "
            f"override.", RuntimeWarning)
        # bh_tile_levels defaults to -1 (on with the deep chain); an
        # explicit 0 keeps tiles off.
        config = config.replace(bh_deep_levels=-1)
    return _resolve_nf_sparse(pos, mass, config.replace(force_backend="bh"))


def _resolve_nf_sparse(pos, mass, config: SimConfig) -> SimConfig:
    """Pin bh_nf_sparse = -1 (auto) to 0 or 1, as the JAX package's
    `_resolve_nf_sparse` does: 0 in 2D, and 0 in 3D whenever the deep chain
    is off; with the 3D deep chain on, 1 when the bucket-tier targets
    (`bh3_bucket_tier_count`) fit half the sparse pass's capacity."""
    if config.bh_nf_sparse != -1:
        return config
    if pos.shape[1] != 3 or not _resolve_deep_levels3(
            config, _resolve_levels3(config, pos.shape[0])):
        return config.replace(bh_nf_sparse=0)
    count = bh3_bucket_tier_count(pos, mass, config)
    return config.replace(
        bh_nf_sparse=1 if count <= _NF_SPARSE_CAP // 2 else 0)


def compute_accelerations(
    pos: torch.Tensor,
    mass: torch.Tensor,
    config: SimConfig,
) -> torch.Tensor:
    """Dispatch to the configured force backend."""
    backend = resolve_backend(config, pos.shape[0], pos.shape[1], pos.device)
    if backend == "bh":
        return bh_accelerations(pos, mass, config)
    if backend == "cuda":
        return allpairs_accelerations(
            pos, mass, eps_sq=config.eps_sq, g_const=config.g_const)
    return direct_accelerations(
        pos, mass, eps_sq=config.eps_sq, g_const=config.g_const)
