from nbodysim_tpu_torch.kernels.allpairs import allpairs_accelerations
from nbodysim_tpu_torch.kernels.collide import allpairs_collision_deltas

__all__ = ["allpairs_accelerations", "allpairs_collision_deltas"]
