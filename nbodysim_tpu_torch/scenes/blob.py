"""The clustered 3D blob: half the bodies in a Gaussian blob, the other half
uniform in a background cube, masses uniform in [0.1, 10].

It is the input of the JAX package's 3D clustered benchmark
(`scripts/bench3d_clustered.py`: sigma 40 at (500, -200, 100) in +-30000,
N = 1,048,576) and, with other arguments, of its deep-overflow tests
(`tests/test_deep_overflow.py`: sigma 40 at (500, -300, 200) in +-2000).
It is a benchmark and test input, not a scene of `init_scene`. The draws
come from numpy's generator, so the CPU tests and the card see the same
bodies for a seed (they cannot match `jax.random`, ROADMAP fault F3).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def clustered_blob(n: int, *, sigma: float = 40.0,
                   center: Sequence[float] = (500.0, -200.0, 100.0),
                   span: float = 30000.0, seed: int = 11,
                   device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos [n, 3], mass [n]) f32 on `device`: the first n // 2 bodies in
    the blob, the rest uniform in [-span, span]^3."""
    rng = np.random.default_rng(seed)
    blob = sigma * rng.standard_normal((n // 2, 3)) + np.asarray(center)
    bg = rng.uniform(-span, span, (n - n // 2, 3))
    pos = np.concatenate([blob, bg]).astype(np.float32)
    mass = rng.uniform(0.1, 10.0, n).astype(np.float32)
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(mass).to(device))
