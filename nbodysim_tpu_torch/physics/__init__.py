from nbodysim_tpu_torch.physics.forces import (
    compute_accelerations, direct_accelerations)
from nbodysim_tpu_torch.physics.integrators import make_step

__all__ = ["compute_accelerations", "direct_accelerations", "make_step"]
