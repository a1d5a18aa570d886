"""Procedural initial-condition scenes (port of `nbodysim_tpu.scenes`).

`uniform_disc` (the reference's flagship scene), `kepler`, `kepler_system`,
`plummer` (BASELINE config 2), `galaxy_merger` (BASELINE config 5) and the
two extension scenes `spiral` (logarithmic spiral arms) and `kuzmin` (a
disc with a closed-form rotation curve), as in the JAX package, and the
port's `uniform_square` (the headline N=1M throughput input as a scene).
Every constructor builds on the card (`device="cuda"`) unless the caller
passes another device, such as `device="cpu"`.
"""

from __future__ import annotations

from typing import Callable, Dict

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.scenes.disc import uniform_disc
from nbodysim_tpu_torch.scenes.galaxy import galaxy_merger
from nbodysim_tpu_torch.scenes.kepler import kepler_orbit, kepler_system
from nbodysim_tpu_torch.scenes.kuzmin import kuzmin_disc
from nbodysim_tpu_torch.scenes.plummer import plummer_sphere
from nbodysim_tpu_torch.scenes.spiral import spiral_galaxy
from nbodysim_tpu_torch.scenes.square import uniform_square


SCENES: Dict[str, Callable[..., ParticleState]] = {
    "uniform_disc": uniform_disc,
    "kepler": kepler_orbit,
    "kepler_system": kepler_system,
    "plummer": plummer_sphere,
    "galaxy_merger": galaxy_merger,
    "spiral": spiral_galaxy,
    "kuzmin": kuzmin_disc,
    "uniform_square": uniform_square,
}


def init_scene(name: str, config: SimConfig, *, device="cuda",
               **kwargs) -> ParticleState:
    """Instantiate a named scene for the given config on `device` (the
    card unless the caller asks for another, e.g. device="cpu")."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    return SCENES[name](config, device=device, **kwargs)


__all__ = [
    "SCENES",
    "init_scene",
    "uniform_disc",
    "kepler_orbit",
    "kepler_system",
    "plummer_sphere",
    "galaxy_merger",
    "spiral_galaxy",
    "kuzmin_disc",
    "uniform_square",
]
