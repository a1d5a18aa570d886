"""The multi-device octree's dispatch (port of the replicated branch of
`nbodysim_tpu.parallel.tree3d.banded_tree3_accelerations`).

Where the x-slabs cannot band (P = 1, a mesh that is not a power of two,
or a grid whose slabs per rank cannot hold the M2L halo), the JAX package
runs the octree replicated, and so does this. Its x-slab-banded octree
(`_banded_eval3`) is the port's next slice: where the JAX package enters
it, this raises NotImplementedError rather than run the replicated tree,
whose cost per device is another.
"""

from __future__ import annotations

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.parallel import comm
from nbodysim_tpu_torch.physics.barneshut3d import (
    _resolve_levels3,
    _resolve_radius3,
)


def banded_tree3_accelerations(pos_l, mass_l, config: SimConfig,
                               axis: comm.Axis) -> torch.Tensor:
    """Octree accelerations [N/P, 3] of the local shard."""
    p_dev = axis.size
    n = pos_l.shape[0] * p_dev
    res = 1 << _resolve_levels3(config, n)
    p_halo = 2 * _resolve_radius3(config) - 1
    if p_dev == 1 or (p_dev & (p_dev - 1)) or res // p_dev < p_halo:
        from nbodysim_tpu_torch.parallel.sharded import (
            replicated_tree_accelerations)

        return replicated_tree_accelerations(pos_l, mass_l, config, axis)
    raise NotImplementedError(
        "the x-slab-banded octree (nbodysim_tpu/parallel/tree3d.py:110, "
        "_banded_eval3) is not ported yet: it is the next slice of the port "
        "(ROADMAP Queue A item 5)")
