"""The collision pass of the multi-device step (port of the parts of
`nbodysim_tpu.parallel.collisions` that run below the dense threshold or
replicated).

  * `gathered_dense_deltas` — the small-N path: every rank all-gathers the
    particle arrays and resolves its own rows [r * N/P, (r + 1) * N/P)
    against all of them, with K2's row-range form on the card (the JAX
    package computes this pass in XLA; its mask, sources' mass > 0, is
    K2's own). At P = 1 it is the launch `_dense_pass` makes.
  * `sharded_collision_deltas` — the broad-phase dispatch, as the JAX
    package's: the dense pass, or a large-N pass run replicated on the
    gathered arrays (`_replicated_fallback`) where the JAX package runs it
    so (P = 1, or a bucket grid whose rows do not split over P).

The JAX package's banded large-N passes (the bucket grid banded by rows,
the block and the hash passes banded by sorted chunks, their residual) are
the port's next slice: where the JAX package enters one, this raises
NotImplementedError rather than run a replicated pass of another cost.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.kernels.collide import (
    allpairs_collision_deltas,
    collision_deltas_plain,
)
from nbodysim_tpu_torch.parallel import comm
from nbodysim_tpu_torch.physics.collisions import (
    DENSE_THRESHOLD,
    resolve_collision_backend,
)

_NEXT_SLICE = ("the banded {} broad phase (nbodysim_tpu/parallel/"
               "collisions.py:{}) is not ported yet: it is the next slice "
               "of the port (ROADMAP Queue A item 4)")


def gathered_dense_deltas(pos_l, vel_l, mass_l, radius_l, config: SimConfig,
                          axis: comm.Axis
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobi collision deltas of the local rows against all N particles:
    the particle arrays all-gathered as one [N, 2D + 2] block, then K2 (or
    its plain version) on the target rows [r * N/P, (r + 1) * N/P)."""
    dim = pos_l.shape[1]
    g = comm.all_gather(
        torch.cat([pos_l, vel_l, mass_l[:, None], radius_l[:, None]], 1),
        axis)
    pos, vel = g[:, :dim], g[:, dim:2 * dim]
    mass, radius = g[:, 2 * dim], g[:, 2 * dim + 1]
    n_l = pos_l.shape[0]
    rows = (axis.index * n_l, n_l)
    if resolve_collision_backend(config, pos_l.device) == "cuda":
        return allpairs_collision_deltas(
            pos, vel, mass, radius, impulse=config.collision_impulse,
            rows=rows)
    return collision_deltas_plain(pos, vel, mass, radius,
                                  impulse=config.collision_impulse, rows=rows)


def sharded_collision_deltas(pos_l, vel_l, mass_l, radius_l,
                             config: SimConfig, axis: comm.Axis
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi collision pass for the local shard: (dpos_l, dvel_l).

    The broad phase is picked as `physics.collisions.resolve_collisions`
    picks it (an upstream `resolve_collision_phase_for_state` may have
    pinned it), so the sharded step resolves the physics the single device
    would."""
    p_dev = axis.size
    n_l, dim = pos_l.shape
    n = n_l * p_dev

    bp = config.collision_broad_phase
    if bp == "auto":
        if n <= DENSE_THRESHOLD:
            bp = "dense"
        else:
            bp = "bucket" if dim == 2 else "block"
    if bp == "bucket" and dim != 2:
        bp = "block"
    if bp == "dense":
        return gathered_dense_deltas(pos_l, vel_l, mass_l, radius_l, config,
                                     axis)

    res = config.collision_grid_res
    if bp == "bucket" and p_dev > 1 and res % p_dev == 0:
        raise NotImplementedError(_NEXT_SLICE.format("bucket", 265))
    if bp in ("hash", "block") and p_dev > 1:
        raise NotImplementedError(_NEXT_SLICE.format(
            bp, 545 if bp == "hash" else 185))

    pos = comm.all_gather(pos_l, axis)
    vel = comm.all_gather(vel_l, axis)
    mass = comm.all_gather(mass_l, axis)
    radius = comm.all_gather(radius_l, axis)
    return _replicated_fallback(pos, vel, mass, radius, config, bp,
                                axis.index, n_l)


def _replicated_fallback(pos, vel, mass, radius, config: SimConfig, bp: str,
                         my: int, n_l: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-device pass on the gathered arrays (the same on every
    rank); returns the local rows' deltas."""
    from nbodysim_tpu_torch.physics.collisions import (
        _block_pass, _bucket_pass, _grid_pass)

    st = ParticleState(pos=pos, vel=vel, acc=torch.zeros_like(pos),
                       mass=mass, radius=radius,
                       frame=torch.zeros((), dtype=torch.int32,
                                         device=pos.device))
    fn = {"bucket": _bucket_pass, "hash": _grid_pass,
          "block": _block_pass}[bp]
    out = fn(st, config)
    rows = slice(my * n_l, (my + 1) * n_l)
    return (out.pos - pos)[rows], (out.vel - vel)[rows]
