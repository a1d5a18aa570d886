"""Multi-device execution on `torch.distributed` (port of
`nbodysim_tpu.parallel`): the particle axis sharded over a 1-D mesh, one
process per device. See `parallel/sharded.py`."""

from nbodysim_tpu_torch.parallel.sharded import (
    make_mesh,
    shard_state,
    make_sharded_step,
    prime_accelerations_sharded,
    ring_accelerations,
)
from nbodysim_tpu_torch.parallel.tree import banded_tree_accelerations

__all__ = [
    "make_mesh",
    "shard_state",
    "make_sharded_step",
    "prime_accelerations_sharded",
    "ring_accelerations",
    "banded_tree_accelerations",
]
