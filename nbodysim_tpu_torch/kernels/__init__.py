from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_wide)
from nbodysim_tpu_torch.kernels.collide import (
    allpairs_collision_deltas, rect_pair_deltas)
from nbodysim_tpu_torch.kernels.collide_block import block_collision_deltas
from nbodysim_tpu_torch.kernels.nearfield import bucket_stencil

__all__ = ["allpairs_accelerations", "allpairs_accelerations_wide",
           "allpairs_collision_deltas", "block_collision_deltas",
           "bucket_stencil", "rect_pair_deltas"]
