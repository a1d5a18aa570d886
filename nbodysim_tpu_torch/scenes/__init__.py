"""Procedural initial-condition scenes (port of `nbodysim_tpu.scenes`).

Ported: `uniform_disc` (the reference's flagship scene), `kepler`,
`kepler_system`, `plummer` (BASELINE config 2) and `galaxy_merger` (BASELINE
config 5). The other scenes of the JAX package keep their names here and
raise NotImplementedError until they are ported (ROADMAP Queue A).
Every constructor takes the target `device` explicitly.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.scenes.disc import uniform_disc
from nbodysim_tpu_torch.scenes.galaxy import galaxy_merger
from nbodysim_tpu_torch.scenes.kepler import kepler_orbit, kepler_system
from nbodysim_tpu_torch.scenes.plummer import plummer_sphere


def _not_ported(name: str, config: SimConfig, **kwargs) -> ParticleState:
    raise NotImplementedError(
        f"scene {name!r} is not ported to nbodysim_tpu_torch yet "
        f"(ported: uniform_disc, kepler, kepler_system, plummer, "
        f"galaxy_merger)")


SCENES: Dict[str, Callable[..., ParticleState]] = {
    "uniform_disc": uniform_disc,
    "kepler": kepler_orbit,
    "kepler_system": kepler_system,
    "plummer": plummer_sphere,
    "galaxy_merger": galaxy_merger,
    **{name: functools.partial(_not_ported, name)
       for name in ("spiral", "kuzmin")},
}


def init_scene(name: str, config: SimConfig, *, device,
               **kwargs) -> ParticleState:
    """Instantiate a named scene for the given config on `device`."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    return SCENES[name](config, device=device, **kwargs)


__all__ = [
    "SCENES",
    "init_scene",
    "uniform_disc",
    "galaxy_merger",
    "kepler_orbit",
    "kepler_system",
    "plummer_sphere",
]
