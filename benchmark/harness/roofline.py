"""Roofline bounds of the force and collision layers on one NVIDIA H100
SXM, from its published peaks (NVIDIA's data sheet, dense rates, at the
700 W power limit; the run prints the card's own limit beside them).

A layer's bound is the least time the card could take for the work the
cell fixes: the larger of the bytes it must move over the memory rate and
its operations over the peak rate of their unit. The arithmetic is the one
`chip_smoke.py` uses:

  * a softened pair: 13 float32 flops in 2D (2 sub, 2 FMA for |d|^2 + eps^2,
    3 mul, 2 FMA into the sums; 19 in 3D) and one MUFU rsqrt, whose pipe
    issues 16 a clock on each of the 132 SMs at 1980 MHz (4.18e12/s);
  * a collision overlap test: 7 flops a pair (2 sub, 2 mul, 1 add for
    |d|^2, 1 mul for (r_i + r_j)^2, 1 compare);
  * bytes: every input read once and every output written once.

The pairs are all N^2 pairs of the cell's N, whatever implements the
layer, so the bound reads the same work before and after a change.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SMS = 132
MUFU_PER_CLOCK_PER_SM = 16
MAX_SM_HZ = 1980e6
MUFU_PER_S = SMS * MUFU_PER_CLOCK_PER_SM * MAX_SM_HZ
PAIR_FLOPS = {2: 13, 3: 19}
COLLIDE_FLOPS = 7


def _bound_s(nbytes: float, flops: float, mufu: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S,
               mufu / MUFU_PER_S)


def forces_bound_s(n: int, dim: int) -> float:
    """All-pairs gravity of n bodies: pos and mass in, acc out."""
    pairs = float(n) * n
    nbytes = 4.0 * n * (dim + 1) + 4.0 * n * dim
    return _bound_s(nbytes, PAIR_FLOPS[dim] * pairs, pairs)


def collisions_bound_s(n: int, dim: int) -> float:
    """The all-pairs overlap test of n bodies: pos, vel, mass, radius in,
    the new pos and vel out."""
    pairs = float(n) * n
    nbytes = 4.0 * n * (2 * dim + 2) + 4.0 * n * 2 * dim
    return _bound_s(nbytes, COLLIDE_FLOPS * pairs)
