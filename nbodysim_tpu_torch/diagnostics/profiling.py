"""Profiling and performance meters (port of
`nbodysim_tpu.diagnostics.profiling`).

  * `trace(log_dir)` — context manager around `torch.profiler`, writing a
    Chrome trace (chrome://tracing, Perfetto) of the host and, on a card,
    the device timeline into `log_dir`.
  * `Stopwatch` — wall-clock laps. PyTorch returns before the card has
    finished, so each lap synchronizes CUDA at its start and end: a lap
    measures the work, not its enqueue.
  * `chain_evals`, `measure_force_throughput`, `measure_step_throughput` —
    the BASELINE.json meters the bench uses. Every result names the device
    it ran on.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from nbodysim_tpu_torch.core.state import resolve_device


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


@contextlib.contextmanager
def trace(log_dir: str = "traces"):
    """Profile the enclosed work with `torch.profiler` (CPU, and CUDA where
    a card is present) and write `log_dir/trace_<pid>.json`, a Chrome
    trace. Yields `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        _sync()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class Stopwatch:
    """Wall-clock meter for repeated work; on a card each lap starts and
    ends with a synchronize.

    >>> sw = Stopwatch()
    >>> with sw.lap():
    ...     rollout(state)
    >>> sw.rate(units=n_steps)
    """

    def __init__(self):
        self.laps: list[float] = []

    @contextlib.contextmanager
    def lap(self):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.laps.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.laps) if self.laps else float("nan")

    @property
    def total(self) -> float:
        return sum(self.laps)

    def rate(self, units: float = 1.0) -> float:
        """units per second, using the best lap."""
        return units / self.best


def chain_evals(fn: Callable, reps: int) -> Callable:
    """A function of (x, a) running `reps` dependent evals of fn(x, a)
    (x <- x + 1e-9 * fn(x, a)) and returning a scalar checksum, so a lap
    reads 4 bytes back, not the [N, D] result."""

    def chained(x, a):
        for _ in range(reps):
            x = x + 1e-9 * fn(x, a)
        return x.sum()

    return chained


def measure_force_throughput(
    n: int,
    backend: str = "cuda",
    reps: int = 10,
    dim: int = 2,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Pairs/sec of a force backend at size n: one warm chain of `reps`
    evals, then the best of 3 timed chains. Positions uniform in
    +-30000, masses in [0.1, 10], from a generator seeded with `seed`."""
    from nbodysim_tpu_torch.config import SimConfig
    from nbodysim_tpu_torch.physics.forces import compute_accelerations

    device = resolve_device(device)
    config = SimConfig(n=n, dim=dim, force_backend=backend)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pos = -30000.0 + 60000.0 * torch.rand((n, dim), generator=g,
                                          device=device)
    mass = 0.1 + 9.9 * torch.rand(n, generator=g, device=device)
    f = chain_evals(lambda p, m: compute_accelerations(p, m, config), reps)
    float(f(pos, mass))  # build + warm
    sw = Stopwatch()
    for _ in range(3):
        with sw.lap():
            float(f(pos, mass))
    per_eval = sw.best / reps
    return {
        "n": n,
        "backend": backend,
        "device": device_name(device),
        "seconds_per_eval": per_eval,
        "pairs_per_second": n * n / per_eval,
    }


def measure_step_throughput(
    n: int, reps: int = 10, scene: str = "uniform_disc", laps: int = 3,
    device="cuda", **config_kw
) -> dict:
    """Full steps/sec (forces + integrate + collisions) over `reps`
    steps, best of `laps` after one warm run. The probes are
    `Simulation`'s: 'auto' force and collision phases resolved from the
    scene's particles, leapfrog primed."""
    from nbodysim_tpu_torch.config import SimConfig
    from nbodysim_tpu_torch.physics.collisions import (
        resolve_collision_phase_for_state)
    from nbodysim_tpu_torch.physics.forces import resolve_config_for_state
    from nbodysim_tpu_torch.physics.integrators import (
        make_rollout, prime_accelerations)
    from nbodysim_tpu_torch.scenes import init_scene

    device = resolve_device(device)
    config = SimConfig(n=n, **config_kw)
    state = init_scene(scene, config, device=device)
    config = resolve_config_for_state(state.pos, state.mass, config)
    config = resolve_collision_phase_for_state(state, config)
    if config.integrator == "leapfrog_kdk":
        state = prime_accelerations(state, config)
    rollout = make_rollout(config, reps)
    float(rollout(state).pos.sum())  # build + warm
    sw = Stopwatch()
    for _ in range(laps):
        with sw.lap():
            float(rollout(state).pos.sum())
    return {
        "n": n,
        "device": device_name(device),
        "steps_per_second": reps / sw.best,
        "seconds_per_step": sw.best / reps,
    }
