"""Typed configuration for the PyTorch/CUDA port.

Mirrors `nbodysim_tpu.config.SimConfig` field for field, with the same
defaults (the reference simulator's constants), so a configuration reads the
same in both packages. It imports no JAX. The differences:

  * `dtype` is `torch.float32` (JAX: `jnp.float32`);
  * `pallas_interpret` is gone (there is no interpreter for a CUDA kernel);
  * `force_backend` is "auto" | "cuda" | "torch" | "bh" and
    `collision_backend` is "auto" | "cuda" | "torch" ("pallas" -> "cuda",
    "xla" -> "torch").

`tests/test_torch_config_state.py` lists these differences explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

FORCE_BACKENDS = ("auto", "cuda", "torch", "bh")
COLLISION_BACKENDS = ("auto", "cuda", "torch")
BROAD_PHASES = ("auto", "dense", "bucket", "hash", "block")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration.

    Defaults reproduce the reference: Simulation.hpp:59 (theta=1, eps=1),
    main.cpp:39 (dt=0.01), Simulation.hpp:61 (n=25000),
    Simulation.hpp:120-124 (boundary constants, vmax). Field meanings are
    documented in `nbodysim_tpu/config.py`.
    """

    # Problem size
    n: int = 25_000
    dim: int = 2

    # Integration
    dt: float = 0.01
    integrator: str = "euler_symplectic"  # or "leapfrog_kdk"
    g_const: float = 1.0

    # Gravity softening (Plummer) and tree opening angle
    softening: float = 1.0
    theta: float = 1.0

    # Velocity clamp + soft boundary (Simulation.hpp:120-124)
    max_velocity: float = 1000.0
    boundary_radius: float = 100_000.0
    boundary_soft_frac: float = 0.8
    boundary_force: float = 0.9
    boundary_damping: float = 0.9995
    enable_boundary: bool = True
    enable_velocity_clamp: bool = True

    # Collisions (Simulation.hpp:18-47, 216-346)
    enable_collisions: bool = True
    collision_broad_phase: str = "auto"  # one of BROAD_PHASES
    collision_cell_size: float = 600.0
    collision_impulse: float = 1.5
    collision_iterations: int = 1
    collision_max_neighbors: int = 16
    collision_grid_res: int = 512
    collision_block_size: int = 256
    # Narrow phase of the dense pass: "auto" launches the CUDA kernel on a
    # CUDA tensor and runs the plain torch version on a CPU tensor.
    collision_backend: str = "auto"      # "auto" | "cuda" | "torch"

    # Force backend: "auto" | "cuda" | "torch" | "bh" (tree code)
    force_backend: str = "auto"
    force_block_targets: int = 256
    force_block_sources: int = 2048

    # Tree code (force_backend="bh"): 2D quadtree and 3D octree, with the
    # deep-overflow chain (bh_deep_levels != 0), its hot-zone tiles
    # (bh_tile_*) and, in 3D, the sparse near field (bh_nf_sparse).
    bh_levels: int = 0
    bh_accept_radius: int = 0
    bh_deep_levels: int = 0
    bh_tile_levels: int = -1
    bh_tile_size: int = 0
    bh_tile_count: int = 8
    bh_nf_sparse: int = -1

    # Numerics
    dtype: Any = torch.float32

    # RNG
    seed: int = 0

    # Multi-device
    mesh_axis: str = "shards"

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        if self.integrator not in ("euler_symplectic", "leapfrog_kdk"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.force_backend not in FORCE_BACKENDS:
            raise ValueError(f"unknown force backend {self.force_backend!r}")
        if self.collision_backend not in COLLISION_BACKENDS:
            raise ValueError(
                f"unknown collision backend {self.collision_backend!r}")
        if self.collision_broad_phase not in BROAD_PHASES:
            raise ValueError(
                f"unknown collision broad phase "
                f"{self.collision_broad_phase!r}")
        if self.collision_block_size < 256 or self.collision_block_size % 256:
            raise ValueError(
                f"collision_block_size must be a positive multiple of 256, "
                f"got {self.collision_block_size}")

    @property
    def eps_sq(self) -> float:
        return self.softening * self.softening

    @property
    def soft_boundary(self) -> float:
        return self.boundary_radius * self.boundary_soft_frac

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
