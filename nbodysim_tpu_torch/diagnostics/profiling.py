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
  * `span`, `host_read`, `count`, `recording` — the program's own spans and
    counters. `span(name)` marks a stage of the step (`step`, `forces`,
    `collisions`, the tree's `tree.*`, the block and bucket passes'
    `collide.*`, the viewer's `render` and `hud`); `host_read(t, what)` is
    every read of a device value the step has to make (one host sync,
    counted as `host_syncs`, inside the span `host_read.<what>`);
    `count(name, value)` adds a number the program already holds on the
    host. With nothing
    recording and no profiler running, a span or a read costs one flag
    check. Under `recording()` the spans and counters are kept in memory
    (the `Recorder` it yields); under a `torch.profiler` (`trace` or any
    other) each span is a host range of the trace, beside the aten ops, so
    the kernels it launched and the device's idle gaps can be named by it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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
    trace in which the program's spans are host ranges beside the aten
    ops. Yields `log_dir`."""
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


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

# Spans whose extent on the device's clock a recording keeps (a CUDA event
# at each edge): the layers of the step, and the bucket collision pass's
# stencil, the one stage whose device time is read on its own.
LAYER_SPANS = ("step", "forces", "collisions", "collide.stencil")

# The active recording. One per process: the spans sit deep in the physics,
# which takes no recorder argument; `recording()` sets and restores it.
_recorder: Optional["Recorder"] = None


class SpanRecord:
    """One span of a recording: its name, the index of the span it opened
    in (None at the top), its host start and end (`time.perf_counter_ns`),
    and for a layer span on a card its two CUDA events."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "events")

    def __init__(self, name: str, parent: Optional[int], start_ns: int,
                 events):
        self.name = name
        self.parent = parent
        self.start_ns = start_ns
        self.end_ns = start_ns
        self.events = events

    @property
    def host_ms(self) -> float:
        return 1e-6 * (self.end_ns - self.start_ns)

    @property
    def device_ms(self) -> Optional[float]:
        """Start to end of the span on the device's clock (its events
        complete); None without events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _matches(name: str, pattern: str) -> bool:
    """`pattern` names one span, or with a trailing dot every span under
    that prefix (`host_read.`)."""
    if pattern.endswith("."):
        return name.startswith(pattern)
    return name == pattern


class Recorder:
    """What one `recording()` kept: `spans` in the order they opened,
    `counters` by name (`host_syncs`, the tree's row counts, the overflow
    counts the tree's and the collision pass's residual branches read)."""

    def __init__(self, device_events: bool):
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, int] = {"host_syncs": 0}
        self._open: List[int] = []
        # The events go on the stream current when the recording opened
        # (the step's): looking it up at every edge costs more host time
        # than the record itself.
        self._stream = torch.cuda.current_stream() if device_events else None

    def _enter(self, name: str) -> int:
        events = None
        if self._stream is not None and name in LAYER_SPANS:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(self._stream)
        parent = self._open[-1] if self._open else None
        self.spans.append(SpanRecord(name, parent, time.perf_counter_ns(),
                                     events))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def _exit(self, idx: int) -> None:
        s = self.spans[idx]
        s.end_ns = time.perf_counter_ns()
        if s.events is not None:
            s.events[1].record(self._stream)
        self._open.pop()

    def add(self, name: str, value: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def under(self, idx: int, pattern: str) -> bool:
        """Whether span `idx` opened inside a span matching `pattern`."""
        p = self.spans[idx].parent
        while p is not None:
            if _matches(self.spans[p].name, pattern):
                return True
            p = self.spans[p].parent
        return False

    def select(self, pattern: str, under: Optional[str] = None
               ) -> List[SpanRecord]:
        """The spans matching `pattern` (and opened inside a span matching
        `under`, where given)."""
        return [s for i, s in enumerate(self.spans)
                if _matches(s.name, pattern)
                and (under is None or self.under(i, under))]

    def host_ms(self, pattern: str, under: Optional[str] = None) -> float:
        """Host ms summed over the spans `select` picks."""
        return sum(s.host_ms for s in self.select(pattern, under))

    def device_ms(self, pattern: str) -> Optional[float]:
        """Device-clock ms summed over the layer spans matching `pattern`;
        None where they have no events (a CPU run) or none ran."""
        spans = self.select(pattern)
        if not spans or any(s.events is None for s in spans):
            return None
        return sum(s.device_ms for s in spans)

    def summary(self) -> Dict[str, dict]:
        """{name: {"calls", "host_ms", "device_ms"}}, names in the order
        they first opened; device_ms None but for layer spans on a card."""
        out: Dict[str, dict] = {}
        for s in self.spans:
            if s.name not in out:
                out[s.name] = {"calls": 0, "host_ms": 0.0,
                               "device_ms": self.device_ms(s.name)}
            out[s.name]["calls"] += 1
            out[s.name]["host_ms"] += s.host_ms
        return out


# The span while nothing records: stateless, so one serves every call.
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "_rec", "_idx", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # The profiler's light host range: `record_function` would also add
        # a device-side annotation over the span's kernels, which a trace
        # reduction that unions device intervals would count as busy time.
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        self._rec = _recorder
        if self._rec is not None:
            self._idx = self._rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._exit(self._idx)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str):
    """Context manager marking a stage of the program as `name`: kept by
    the active `recording()`, and a host range of an active
    `torch.profiler` trace. With neither it costs one flag check."""
    if _recorder is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def host_read(t: torch.Tensor, what: str):
    """`t.item()`: the Python value of a one-element tensor the program has
    to read on the host, which on a card waits for every queued operation
    (a host sync); `t.tolist()` for a longer one, still one sync. Recorded,
    it counts `host_syncs` and runs inside the span `host_read.<what>`, the
    time the host sits blocked."""
    read = torch.Tensor.item if t.numel() == 1 else torch.Tensor.tolist
    rec = _recorder
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return read(t)
    with _Span("host_read." + what):
        value = read(t)
    if rec is not None:
        rec.add("host_syncs", 1)
    return value


def count(name: str, value: int) -> None:
    """Add `value`, a number the program already holds on the host (never
    a device tensor: a counter adds no sync), to the counter `name` of the
    active recording; nothing without one."""
    if _recorder is not None:
        _recorder.add(name, value)


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the enclosed work; yields the
    `Recorder`, complete when the block closes. Layer spans keep CUDA
    events where CUDA is in use (on the stream current at the start), so
    `Recorder.device_ms` gives their extent on the device's clock. A
    nested recording takes over until it closes.

    >>> with recording() as rec:
    ...     sim.run(10)
    >>> rec.counters["host_syncs"], rec.summary()["forces"]["host_ms"]
    """
    global _recorder
    prev = _recorder
    rec = Recorder(device_events=torch.cuda.is_available()
                   and torch.cuda.is_initialized())
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev
