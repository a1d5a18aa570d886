"""nbodysim_tpu_torch — the PyTorch/CUDA port of nbodysim_tpu.

The same simulator as the JAX package (softened Newtonian gravity, fixed-dt
symplectic integration, Jacobi collisions, procedural scenes, diagnostics),
on PyTorch tensors, with the hot all-pairs kernels written by hand in CUDA
C++ for the NVIDIA H100 (`csrc/`, built with nvcc at first use). The module
layout and public names follow `nbodysim_tpu`; this package imports no JAX.

Public API:
    SimConfig, ParticleState, init_scene, make_step, simulate, diagnostics

The product surface lives in its subpackages, as in the JAX package:
`io` (checkpoints), `render` (frames, overlays, video), `diagnostics`
(metrics, profiling), `app.viewer`, and the entry points
`python -m nbodysim_tpu_torch.cli` and `python -m nbodysim_tpu_torch.bench`.
"""

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.physics.forces import compute_accelerations
from nbodysim_tpu_torch.physics.integrators import make_step
from nbodysim_tpu_torch.diagnostics.metrics import diagnostics, system_metrics
from nbodysim_tpu_torch.scenes import init_scene
from nbodysim_tpu_torch.api import Simulation, simulate

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "ParticleState",
    "compute_accelerations",
    "make_step",
    "diagnostics",
    "system_metrics",
    "init_scene",
    "Simulation",
    "simulate",
]
