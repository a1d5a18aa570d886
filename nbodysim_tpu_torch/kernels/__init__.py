from nbodysim_tpu_torch.kernels.allpairs import (
    allpairs_accelerations, allpairs_accelerations_wide)
from nbodysim_tpu_torch.kernels.collide import allpairs_collision_deltas
from nbodysim_tpu_torch.kernels.nearfield import bucket_stencil

__all__ = ["allpairs_accelerations", "allpairs_accelerations_wide",
           "allpairs_collision_deltas", "bucket_stencil"]
