"""Benchmark harness of the PyTorch/CUDA port (the counterpart of the
repository's root `bench.py`): one JSON line a measurement.

    python -m nbodysim_tpu_torch.bench [--n N] [--reps R] [--full]
                                       [--config 1..5] [--drift-gate]
                                       [--device cuda|cpu]

The first line names the device: the card's name and power limit (as
`nvidia-smi --query-gpu=name,power.limit` prints them) and the torch, CUDA
and nvcc versions. The default run then prints K1's pairs/s at --n (default
N=1,048,576) and at N=65,536, fused steps/s of the N=25k reference step,
the 2D tree code's pairs-equivalent/s at N=1M, and a bounded BASELINE
config-5 line (the N=4M galaxy merger, forces only, one warm and one timed
lap of 2 steps); --full adds the 3D octree at N=1M. --config 1..5 runs one
BASELINE.json preset, --drift-gate the 10k-step energy-drift gate
(scripts/drift_gate.py's run). The metric names are the root bench's.
Every lap ends with a synchronize; runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from nbodysim_tpu_torch.core.state import resolve_device
from nbodysim_tpu_torch.diagnostics.profiling import (
    Stopwatch, chain_evals, device_name, measure_force_throughput,
    measure_step_throughput)

def _line(metric: str, value, unit, **extra) -> dict:
    return {"metric": metric, "value": value, "unit": unit, **extra}


def device_header(device) -> dict:
    """The device line: name, power limit (the card's, from nvidia-smi),
    torch, CUDA and nvcc versions."""
    device = torch.device(device)
    head = {"device": device_name(device), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if device.type == "cuda":
        head["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        from nbodysim_tpu_torch.kernels import _build

        head["nvcc"] = subprocess.run(
            [_build._nvcc(), "--version"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[-1]
    return head


def _force_backend(device: torch.device) -> str:
    """K1 on a card, its plain version on the CPU."""
    return "cuda" if device.type == "cuda" else "torch"


def _bench_kernel(n: int, reps: int, device) -> float:
    """Pairs/sec of K1 (`allpairs_accelerations`), `reps` chained evals a
    lap, best of 3 after one warm lap."""
    from nbodysim_tpu_torch.kernels.allpairs import allpairs_accelerations

    g = torch.Generator(device=device)
    g.manual_seed(0)
    pos = -30000.0 + 60000.0 * torch.rand((n, 2), generator=g, device=device)
    mass = 0.1 + 9.9 * torch.rand(n, generator=g, device=device)
    f = chain_evals(lambda p, m: allpairs_accelerations(p, m, eps_sq=1.0),
                    reps)
    float(f(pos, mass))
    sw = Stopwatch()
    for _ in range(3):
        with sw.lap():
            float(f(pos, mass))
    return n * n / (sw.best / reps)


def _bench_step(n: int, reps: int, device) -> float:
    """Full steps/sec (forces + integrate + collisions) of the reference
    config at N=n, `reps` steps a lap, best of 3 after one warm lap."""
    from nbodysim_tpu_torch.config import SimConfig
    from nbodysim_tpu_torch.physics.integrators import make_rollout
    from nbodysim_tpu_torch.scenes import init_scene

    config = SimConfig(n=n)
    state = init_scene("uniform_disc", config, device=device)
    rollout = make_rollout(config, reps)
    float(rollout(state).pos.sum())
    sw = Stopwatch()
    for _ in range(3):
        with sw.lap():
            float(rollout(state).pos.sum())
    return reps / sw.best


def drift_gate(device, n: int = 4096, steps: int = 10_000,
               chunk: int = 500) -> dict:
    """The energy-drift gate (scripts/drift_gate.py): a Plummer sphere of
    N=4096, leapfrog, dt 0.5, softening 10, `steps` steps; the worst
    |dE/E| over the chunk ends against BASELINE's bar of 1e-4."""
    from nbodysim_tpu_torch.config import SimConfig
    from nbodysim_tpu_torch.diagnostics.metrics import diagnostics
    from nbodysim_tpu_torch.physics.integrators import (
        make_rollout, prime_accelerations)
    from nbodysim_tpu_torch.scenes import init_scene

    config = SimConfig(n=n, dt=0.5, softening=10.0,
                       integrator="leapfrog_kdk", enable_collisions=False,
                       enable_boundary=False, enable_velocity_clamp=False,
                       force_backend=_force_backend(device))
    state = prime_accelerations(
        init_scene("plummer", config, total_mass=1e4, scale_radius=1000.0,
                   device=device), config)
    e0 = float(diagnostics(state, config).total_energy)
    roll = make_rollout(config, chunk)
    worst = 0.0
    for _ in range(steps // chunk):
        state = roll(state)
        e = float(diagnostics(state, config).total_energy)
        worst = max(worst, abs(e - e0) / abs(e0))
    return _line(f"drift gate: Plummer N={n} leapfrog worst |dE/E| over "
                 f"{steps} steps", worst, "relative", limit=1e-4,
                 passed=worst <= 1e-4, device=device_name(device))


def _bench_baseline_config(idx: int, device) -> dict:
    """BASELINE.json configs 1-5 as runnable presets (one dict each;
    config 5 prints its forces-only line first)."""
    from nbodysim_tpu_torch.config import SimConfig
    from nbodysim_tpu_torch.diagnostics.metrics import diagnostics
    from nbodysim_tpu_torch.physics.integrators import (
        make_rollout, prime_accelerations)
    from nbodysim_tpu_torch.scenes import init_scene

    backend = _force_backend(device)
    if idx == 1:   # 2-body Kepler orbit: phase error after one period
        from nbodysim_tpu_torch.scenes.kepler import (
            kepler_orbit, kepler_period)

        config = SimConfig(n=2, dt=0.02, softening=0.0,
                           integrator="leapfrog_kdk", enable_collisions=False,
                           enable_boundary=False, enable_velocity_clamp=False,
                           force_backend=backend)
        state = prime_accelerations(
            kepler_orbit(config, central_mass=1e6, semi_major=1000.0,
                         device=device), config)
        steps = int(round(kepler_period(config, 1e6, 1.0, 1000.0)
                          / config.dt))
        out = make_rollout(config, steps)(state)
        err = float(torch.linalg.vector_norm(out.pos[1] - state.pos[1]))
        return _line("config1 Kepler phase error after 1 period",
                     err / (2 * math.pi * 1000.0),
                     "fraction of circumference")
    if idx == 2:   # Plummer 4096 energy drift over 1k steps
        config = SimConfig(n=4096, dt=0.5, softening=10.0,
                           integrator="leapfrog_kdk", enable_collisions=False,
                           enable_boundary=False, enable_velocity_clamp=False,
                           force_backend=backend)
        state = prime_accelerations(
            init_scene("plummer", config, total_mass=1e4,
                       scale_radius=1000.0, device=device), config)
        e0 = float(diagnostics(state, config).total_energy)
        out = make_rollout(config, 1000)(state)
        e1 = float(diagnostics(out, config).total_energy)
        drift = abs(e1 - e0) / abs(e0)
        return _line("config2 Plummer |dE/E| over 1k steps", drift,
                     "relative", limit=1e-4, passed=drift <= 1e-4)
    if idx in (3, 4):   # all-pairs at 64k / 1M on one device
        n, reps = (65536, 10) if idx == 3 else (1 << 20, 2)
        out = measure_force_throughput(n, backend=backend, reps=reps,
                                       device=device)
        what = ("config3 all-pairs pairs/s at N=64k" if idx == 3 else
                "config4 all-pairs pairs/s at N=1M (1 chip)")
        return _line(what, out["pairs_per_second"], "pairs/s")
    if idx == 5:   # 4M galaxy merger, tree code with the deep chain
        kw = dict(reps=3, scene="galaxy_merger", force_backend="bh",
                  bh_deep_levels=-1, integrator="leapfrog_kdk", dt=0.05,
                  device=device)
        out_nc = measure_step_throughput(1 << 22, enable_collisions=False,
                                         **kw)
        print(json.dumps(_line(
            "config5 galaxy-merger steps/s at N=4M (BH, forces only, "
            "1 chip)", out_nc["steps_per_second"], "steps/s")), flush=True)
        out = measure_step_throughput(1 << 22, enable_collisions=True, **kw)
        return _line("config5 galaxy-merger steps/s at N=4M (BH + "
                     "collisions, 1 chip)", out["steps_per_second"],
                     "steps/s")
    raise SystemExit(f"unknown --config {idx} (1-5)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m nbodysim_tpu_torch.bench")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=None,
                    help="evals chained per lap (default: 3 at N>=512k, "
                         "10 below)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--config", type=int, default=None,
                    help="run a BASELINE.json config preset (1-5)")
    ap.add_argument("--drift-gate", action="store_true",
                    help="run the 10k-step energy-drift gate only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    print(json.dumps(device_header(device)), flush=True)

    def emit(line):
        print(json.dumps(line), flush=True)

    if args.drift_gate:
        emit(drift_gate(device))
        return
    if args.config is not None:
        emit(_bench_baseline_config(args.config, device))
        return

    reps = args.reps if args.reps else (3 if args.n >= (1 << 19) else 10)
    emit(_line(f"pairwise interactions/sec/chip (all-pairs kernel, "
               f"N={args.n})", _bench_kernel(args.n, reps, device),
               "pairs/s"))
    if args.n != 65536:
        emit(_line("pairwise interactions/sec/chip (all-pairs kernel, "
                   "N=65536)", _bench_kernel(65536, 10, device), "pairs/s"))
    emit(_line("fused steps/sec (N=25000 reference config)",
               _bench_step(25_000, 10, device), "steps/s"))
    bh = measure_force_throughput(1 << 20, backend="bh", reps=3,
                                  device=device)
    emit(_line("FMM tree-code pairs-equivalent/sec/chip (N=1M)",
               bh["pairs_per_second"], "pairs-equiv/s"))
    c5 = measure_step_throughput(
        1 << 22, reps=2, laps=1, scene="galaxy_merger", force_backend="bh",
        bh_deep_levels=-1, integrator="leapfrog_kdk",
        enable_collisions=False, dt=0.05, device=device)
    emit(_line("config5 galaxy-merger steps/s at N=4M (BH + deep + tiles, "
               "forces only, 1 chip, bounded)", c5["steps_per_second"],
               "steps/s"))
    if args.full:
        bh3 = measure_force_throughput(1 << 20, backend="bh", reps=3, dim=3,
                                       device=device)
        emit(_line("3D octree FMM pairs-equivalent/sec/chip (N=1M)",
                   bh3["pairs_per_second"], "pairs-equiv/s"))


if __name__ == "__main__":
    main()
