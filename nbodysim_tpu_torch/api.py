"""High-level user API (port of `nbodysim_tpu.api`).

`Simulation` mirrors the reference's `class Simulation` surface
(Simulation.hpp:49-75: construct -> `step()` -> read state / `frame` / `dt`)
as a stateful wrapper over the functional core; `simulate` is the functional
entry point. `Simulation` runs on the card unless the caller asks for the
CPU (`device="cpu"`); `simulate` runs where the state lies.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from nbodysim_tpu_torch.config import SimConfig
from nbodysim_tpu_torch.core.state import ParticleState
from nbodysim_tpu_torch.physics.collisions import (
    resolve_collision_phase_for_state,
)
from nbodysim_tpu_torch.physics.barneshut import (
    _OVERFLOW_CAP, bh_near_overflow)
from nbodysim_tpu_torch.physics.barneshut3d import bh3_near_overflow
from nbodysim_tpu_torch.physics.forces import resolve_config_for_state
from nbodysim_tpu_torch.physics.integrators import (
    make_rollout,
    make_step,
    prime_accelerations,
)

# Reference dt slider range (main.cpp:865-893).
DT_MIN = 0.001
DT_MAX = 0.1


def clamp_dt(dt: float) -> Tuple[float, bool]:
    """Clamp dt into the reference slider range; returns (dt, was_clamped)."""
    clamped = min(max(dt, DT_MIN), DT_MAX)
    return clamped, clamped != dt


class Simulation:
    """Stateful convenience wrapper (reference: Simulation.hpp:49-75).

    >>> sim = Simulation(SimConfig(n=25_000), scene="uniform_disc")
    >>> sim.run(100)         # 100 steps: K1 + integration + K2 each
    >>> sim.state.pos        # SoA field access (reference: sim.bodies)
    """

    def __init__(
        self,
        config: Optional[SimConfig] = None,
        scene: str = "uniform_disc",
        state: Optional[ParticleState] = None,
        *,
        device="cuda",
        **scene_kwargs,
    ):
        self.config = config or SimConfig()
        self.device = torch.device(device)
        if state is None:
            from nbodysim_tpu_torch.scenes import init_scene

            state = init_scene(scene, self.config, device=self.device,
                               **scene_kwargs)
        else:
            state = state.to(self.device)
        # Pin 'auto' backends to the concrete ones for this device and N
        # (the tree's deep chain switched on where the buckets overflow);
        # what is not ported yet raises here, before any step.
        self.config = resolve_config_for_state(
            state.pos, state.mass, self.config)
        self.config = resolve_collision_phase_for_state(state, self.config)
        if self.config.integrator == "leapfrog_kdk":
            state = prime_accelerations(state, self.config)
        self.state = state
        self._step = make_step(self.config)
        self.check_capacity()

    def check_capacity(self, when: str = "the initial state") -> bool:
        """Host-side capacity checks of the fixed-size exact residuals, which
        silently drop work past their caps. Warns (RuntimeWarning) and
        returns True when:
          * force_backend "bh" (deep chain off): the tree's bucket overflow
            exceeds its residual cap (excess particles get no near field);
          * collisions on the 2D bucket grid ('auto' or 'bucket' above the
            dense threshold): the bucket overflow exceeds the collision
            residual's cap;
          * collisions on the block pass: the block-window overflow does.
        """
        from nbodysim_tpu_torch.physics import collisions

        exceeded = False
        cfg, state = self.config, self.state
        if cfg.force_backend == "bh" and not cfg.bh_deep_levels:
            probe = bh3_near_overflow if state.dim == 3 else bh_near_overflow
            over = probe(state.pos, state.mass, cfg)
            if over > _OVERFLOW_CAP:
                exceeded = True
                warnings.warn(
                    f"BH near-field overflow {over} exceeds the residual "
                    f"capacity {_OVERFLOW_CAP} on {when}; excess particles "
                    f"get no near-field force. Set bh_deep_levels=-1 (the "
                    f"deep-overflow chain), or use force_backend='cuda' for "
                    f"this scene.", RuntimeWarning)
        if not cfg.enable_collisions:
            return exceeded
        cap = collisions._OVERFLOW_CAP
        bp = cfg.collision_broad_phase
        if (state.dim == 2 and bp in ("auto", "bucket")
                and state.n > collisions.DENSE_THRESHOLD):
            # Scenes already switched to the block pass (radius-scaled
            # cells) have no bucket cap to exceed.
            over = collisions.collision_bucket_overflow(state, cfg)
            if over > cap:
                exceeded = True
                warnings.warn(
                    f"collision bucket overflow {over} exceeds the residual "
                    f"capacity {cap} on {when}; excess particles get no "
                    f"collision response. Set collision_broad_phase='block' "
                    f"(radius-scaled cells, full coverage) or raise "
                    f"collision_grid_res / collision_max_neighbors.",
                    RuntimeWarning)
        resolves_block = bp == "block" or (
            bp == "auto" and state.dim == 3
            and state.n > collisions.DENSE_THRESHOLD)
        if resolves_block:
            over = collisions.collision_block_overflow(state, cfg)
            if over > cap:
                exceeded = True
                warnings.warn(
                    f"collision block-window overflow {over} exceeds the "
                    f"residual capacity {cap} on {when}; excess particles "
                    f"get no collision response. Raise "
                    f"collision_block_size.", RuntimeWarning)
        return exceeded

    @property
    def frame(self) -> int:
        return int(self.state.frame)

    @property
    def dt(self) -> float:
        return self.config.dt

    def set_dt(self, dt: float) -> None:
        """Change the timestep (reference: SIMULATION_DT atomic + T/Y keys)."""
        self.config = self.config.replace(dt=dt)
        self._step = make_step(self.config)

    def step(self) -> ParticleState:
        self.state = self._step(self.state)
        return self.state

    def run(self, num_steps: int) -> ParticleState:
        """`num_steps` steps."""
        for _ in range(num_steps):
            self.state = self._step(self.state)
        return self.state

    def diagnostics(self):
        from nbodysim_tpu_torch.diagnostics.metrics import diagnostics

        return diagnostics(self.state, self.config)

    def system_metrics(self):
        from nbodysim_tpu_torch.diagnostics.metrics import system_metrics

        return system_metrics(self.state, self.config)


def simulate(
    state: ParticleState,
    config: SimConfig,
    num_steps: int,
) -> ParticleState:
    """Functional rollout: `num_steps` steps on the state's device, as the
    JAX package's `simulate`: it primes leapfrog and rolls out. The state
    probes ('auto' pinned from the particles' occupancy, the capacity
    checks) are `Simulation`'s; here each step resolves 'auto' by N."""
    if config.integrator == "leapfrog_kdk":
        state = prime_accelerations(state, config)
    return make_rollout(config, num_steps)(state)
