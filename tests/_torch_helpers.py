"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Importing this module pins torch to one thread: the suite runs under several
pytest-xdist workers, and torch's default of one thread per core would
oversubscribe the host.
"""

from __future__ import annotations

import numpy as np
import torch

import nbodysim_tpu_torch as nt

torch.set_num_threads(1)

CPU = torch.device("cpu")


def rand_system(n: int, dim: int = 2, span: float = 1000.0, seed: int = 0):
    """Positions uniform in [-span, span]^dim and masses in [0.1, 10], f32."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-span, span, (n, dim)).astype(np.float32)
    mass = rng.uniform(0.1, 10.0, n).astype(np.float32)
    return pos, mass


def rand_cloud(n: int, dim: int, seed: int):
    """The dense colliding cloud of tests/test_collisions.py (N=300 in
    [-10, 10]^D, radius 1.5 cbrt(m)), drawn with numpy."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-10.0, 10.0, (n, dim)).astype(np.float32)
    vel = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radius = (np.cbrt(mass) * 1.5).astype(np.float32)
    return pos, vel, mass, radius


def jax_arrays(state) -> dict:
    """A JAX ParticleState as the numpy arrays a checkpoint holds."""
    return {k: np.asarray(getattr(state, k))
            for k in ("pos", "vel", "acc", "mass", "radius", "frame")}


def to_port(jax_state) -> nt.ParticleState:
    """The same state, as the port's ParticleState on the CPU."""
    return nt.ParticleState.from_numpy(jax_arrays(jax_state), CPU)


def as_t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=CPU)


def as_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1


def extreme_cells_case(n: int, dim: int, seed: int):
    """A colliding cluster (pos, vel, mass, radius) with int32 cells [n, D]
    drawn apart from the positions, from values at and near INT_MIN /
    INT_MAX, around 0 and at +-2^30: lead cells that are neighbours only
    through the int32 wrap (INT_MAX + 1 = INT_MIN), trailing cells whose
    difference wraps to +-1 or is exactly 2^31 (abs(INT_MIN) = INT_MIN
    passes the block pass's <= 1 test), and cells across the safe range's
    edge. For K6's key masks, not for physics: the cells say nothing of
    where the bodies are."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-12.0, 12.0, (n, dim)).astype(np.float32)
    vel = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radius = rng.uniform(0.5, 1.0, n).astype(np.float32)
    lead = np.array([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1, INT_MAX],
                    np.int64)
    trail = np.array([INT_MIN, INT_MIN + 1, -2, -1, 0, 1, 2 ** 30 - 1,
                      2 ** 30, INT_MAX - 1, INT_MAX], np.int64)
    cols = [rng.choice(lead, n) for _ in range(dim - 1)] + [
        rng.choice(trail, n)]
    return pos, vel, mass, radius, np.stack(cols, 1).astype(np.int32)
