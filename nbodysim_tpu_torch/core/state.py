"""Struct-of-arrays particle state as torch tensors.

The port of `nbodysim_tpu.core.state`. Every field lives on one device; the
numpy round trip (`from_numpy` / `to_numpy`) uses the keys that
`nbodysim_tpu.io.checkpoint.save_checkpoint` writes, so the arrays of a JAX
state or checkpoint load into the port unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

FIELDS = ("pos", "vel", "acc", "mass", "radius", "frame")


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no `cbrt`)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle state (N = particle count, D = 2 or 3).

      pos    [N, D] positions
      vel    [N, D] velocities
      acc    [N, D] accelerations from the last force evaluation
      mass   [N]    masses
      radius [N]    collision radii (reference: radius = cbrt(mass))
      frame  []     int32 step counter (Simulation.hpp:53 `frame`)
    """

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    mass: torch.Tensor
    radius: torch.Tensor
    frame: torch.Tensor

    # -- constructors -------------------------------------------------------

    @staticmethod
    def create(
        pos: torch.Tensor,
        vel: torch.Tensor,
        mass: torch.Tensor,
        radius: Optional[torch.Tensor] = None,
        dtype=torch.float32,
    ) -> "ParticleState":
        pos = torch.as_tensor(pos, dtype=dtype)
        device = pos.device
        vel = torch.as_tensor(vel, dtype=dtype, device=device)
        mass = torch.as_tensor(mass, dtype=dtype, device=device)
        if radius is None:
            radius = cbrt(mass)  # reference: radius = cbrt(mass), hpp:579
        radius = torch.as_tensor(radius, dtype=dtype, device=device)
        return ParticleState(
            pos=pos,
            vel=vel,
            acc=torch.zeros_like(pos),
            mass=mass,
            radius=radius,
            frame=torch.zeros((), dtype=torch.int32, device=device),
        )

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], device) -> "ParticleState":
        """Build a state from numpy arrays keyed like a checkpoint
        (pos, vel, acc, mass, radius, frame); `acc` and `frame` may be
        absent and then start at zero."""
        def put(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        pos = put(arrays["pos"], torch.float32)
        acc = arrays.get("acc")
        frame = arrays.get("frame")
        state = ParticleState(
            pos=pos,
            vel=put(arrays["vel"], torch.float32),
            acc=(torch.zeros_like(pos) if acc is None
                 else put(acc, torch.float32)),
            mass=put(arrays["mass"], torch.float32),
            radius=put(arrays["radius"], torch.float32),
            frame=put(0 if frame is None else frame, torch.int32).reshape(()),
        )
        validate_state(state)
        return state

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k).detach().cpu().numpy() for k in FIELDS}

    # -- convenience --------------------------------------------------------

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device) -> "ParticleState":
        return ParticleState(
            **{k: getattr(self, k).to(device) for k in FIELDS})

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device on a host without one
    raises RuntimeError (the entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' (--device cpu) to run on the CPU")
    return device


def validate_state(state: ParticleState) -> None:
    """Shape checks; raises ValueError on a malformed state."""
    n, d = state.pos.shape
    if d not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {d}")
    for name, shape in (("vel", (n, d)), ("acc", (n, d)),
                        ("mass", (n,)), ("radius", (n,))):
        got = tuple(getattr(state, name).shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, expected {shape}")
