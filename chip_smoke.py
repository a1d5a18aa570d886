#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`nbodysim_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device   — the card's name and power limit (nvidia-smi), torch, CUDA
                and nvcc versions; exits non-zero without a CUDA device;
  2. build    — compiles the CUDA kernels from nbodysim_tpu_torch/csrc/;
  3. K1       — the all-pairs gravity kernel against its plain torch
                version on the card, on six cases, each within
                1e-5 * max|a|;
  4. K2       — the collision kernel against its plain version on dense
                colliding clouds (2D, 3D) and the N=25k disc, within
                1e-5 * max(max|v|, 10), with momentum conservation;
  5. main     — Simulation(SimConfig(n=25_000), scene="uniform_disc",
                device="cuda").run(200): finite state and energies, both
                kernels launched exactly 200 times, K1 and K2 again on the
                evolved state, one step through the kernels against one
                step through the plain versions (1e-5 * max|x|, max|v|);
  6. timings  — kernel and plain times at the main path's shapes, and K1
                pairs/s at N=65,536 and N=1,048,576.

Then one JSON line per kernel, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def main() -> None:
    import torch

    # -- 1. device -----------------------------------------------------------
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    from nbodysim_tpu_torch import SimConfig, Simulation
    from nbodysim_tpu_torch.kernels import _build
    from nbodysim_tpu_torch.kernels.allpairs import (
        allpairs_accelerations, allpairs_accelerations_plain)
    from nbodysim_tpu_torch.kernels.collide import (
        allpairs_collision_deltas, collision_deltas_plain)
    from nbodysim_tpu_torch.physics.integrators import make_step
    from nbodysim_tpu_torch.scenes import uniform_disc

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    say("device", f"{smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {nvcc[-1]}")
    # The plain versions use elementwise products only; TF32 is never on
    # their path, and these are left at PyTorch's defaults.
    say("device", f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    say("build", f"{lib_path.name} in {time.perf_counter() - t0:.2f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say("build", line.strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    # -- 3. K1 against its plain version ---------------------------------------
    def k1_case(name, pos, mass, eps_sq, g=1.0, src_pos=None, src_mass=None,
                rtol=None):
        kw = dict(eps_sq=eps_sq, g_const=g, src_pos=src_pos,
                  src_mass=src_mass)
        got = allpairs_accelerations(pos, mass, **kw)
        ref = allpairs_accelerations_plain(pos, mass, **kw)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite")
        err = (got - ref).abs()
        scale = float(ref.abs().max())
        if rtol is None:
            tol = 1e-5 * scale
            ok = float(err.max()) <= tol
        else:
            tol = rtol
            ok = bool((err <= rtol * ref.abs()).all())
        say("K1", f"{name}: max_abs_err={float(err.max()):.3e} "
            f"max|a|={scale:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"K1 {name} disagrees with its plain version")
        return float(err.max())

    disc = uniform_disc(SimConfig(n=25_000), device=dev)
    p3 = uniform((4096, 3), -1000.0, 1000.0)
    m3 = uniform((4096,), 0.1, 10.0)
    m3[::17] = 0.0   # zero-mass sources are inert
    base = torch.tensor([50000.0, -70000.0], device=dev)
    far = torch.stack([base, base + torch.tensor([3.0, 4.0], device=dev)])
    p0 = uniform((257, 2), -100.0, 100.0)
    p0[256] = p0[3]  # a coincident pair
    k1_errs = [
        k1_case("2D disc N=25000", disc.pos, disc.mass, 1.0),
        k1_case("3D N=4096 (every 17th mass 0)", p3, m3, 1.0),
        k1_case("far from origin (5e4, -7e4), 5 apart", far,
                torch.tensor([2.0, 8.0], device=dev), 1.0, rtol=1e-5),
        k1_case("eps=0 with a coincident pair", p0,
                uniform((257,), 0.1, 10.0), 0.0),
        k1_case("separate sources 4096 <- 3001",
                uniform((4096, 2), -1e4, 1e4), None, 1.0,
                src_pos=uniform((3001, 2), -1e4, 1e4),
                src_mass=uniform((3001,), 0.1, 10.0)),
        k1_case("g=2.5 N=5000", uniform((5000, 2), -1e4, 1e4),
                uniform((5000,), 0.1, 10.0), 1.0, g=2.5),
    ]

    # -- 4. K2 against its plain version ---------------------------------------
    def k2_case(name, pos, vel, mass, radius):
        dp, dv = allpairs_collision_deltas(pos, vel, mass, radius,
                                           impulse=1.5)
        rp, rv = collision_deltas_plain(pos, vel, mass, radius, impulse=1.5)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(dp).all() and torch.isfinite(dv).all()),
                f"K2 {name}: non-finite")
        scale = float((vel + rv).abs().max())
        tol = 1e-5 * max(scale, 10.0)
        err_p = float(((pos + dp) - (pos + rp)).abs().max())
        err_v = float(((vel + dv) - (vel + rv)).abs().max())
        p_before = (mass[:, None] * vel).sum(0)
        p_after = (mass[:, None] * (vel + dv)).sum(0)
        drift = float((p_after - p_before).abs().max())
        p_tol = 1e-2 * float(p_before.abs().max())
        n_hit = int((rv.abs().sum(-1) + rp.abs().sum(-1) > 0).sum())
        ok = err_p <= tol and err_v <= tol and drift <= p_tol
        say("K2", f"{name}: particles hit={n_hit} err_pos={err_p:.3e} "
            f"err_vel={err_v:.3e} tol={tol:.3e} momentum drift={drift:.3e} "
            f"(tol {p_tol:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"K2 {name} disagrees with its plain version")
        return max(float((dp - rp).abs().max()), float((dv - rv).abs().max()))

    k2_errs = []
    for dim, half in ((2, 37.0), (3, 24.0)):
        # The density of tests/test_collisions.py's N=300 cloud in [-10, 10]^D.
        mass = uniform((4096,), 0.5, 2.0)
        k2_errs.append(k2_case(
            f"{dim}D dense cloud N=4096", uniform((4096, dim), -half, half),
            uniform((4096, dim), -5.0, 5.0), mass, mass.pow(1 / 3) * 1.5))
    k2_errs.append(k2_case("2D disc N=25000", disc.pos, disc.vel, disc.mass,
                           disc.radius))

    # -- 5. main path --------------------------------------------------------
    sim = Simulation(SimConfig(n=25_000), scene="uniform_disc", device="cuda")
    require(sim.config.force_backend == "cuda",
            f"force backend resolved to {sim.config.force_backend}")
    sim.run(5)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    allpairs_accelerations.launches = 0
    allpairs_collision_deltas.launches = 0
    start.record()
    sim.run(200)
    end.record()
    torch.cuda.synchronize()
    launches = {"K1": allpairs_accelerations.launches,
                "K2": allpairs_collision_deltas.launches}
    steps_per_s = 200 / (start.elapsed_time(end) / 1e3)
    say("main", f"launches during run(200): {launches}; frame {sim.frame}; "
        f"{steps_per_s:.1f} steps/s (CUDA events, after 5 warm-up steps)")
    require(launches == {"K1": 200, "K2": 200},
            f"kernel launches {launches}, expected 200 each")
    require(sim.frame == 205, f"frame {sim.frame}, expected 205")
    st = sim.state
    for name in ("pos", "vel", "acc", "mass", "radius"):
        require(bool(torch.isfinite(getattr(st, name)).all()),
                f"main path: non-finite {name}")
    d = sim.diagnostics()
    energies = [float(d.kinetic), float(d.potential), float(d.total_energy)]
    say("main", f"diagnostics: KE={energies[0]:.6e} PE={energies[1]:.6e} "
        f"E={energies[2]:.6e} |p|={float(d.momentum.abs().max()):.6e}")
    require(all(map(math.isfinite, energies)), "main path: non-finite energies")
    # The kernels again on the evolved state (these launches are not counted).
    k1_errs.append(k1_case("2D disc after 205 steps", st.pos, st.mass, 1.0))
    k2_errs.append(k2_case("2D disc after 205 steps", st.pos, st.vel, st.mass,
                           st.radius))
    plain_cfg = sim.config.replace(force_backend="torch",
                                   collision_backend="torch")
    out_k = make_step(sim.config)(st)
    out_p = make_step(plain_cfg)(st)
    torch.cuda.synchronize()
    tol_x = 1e-5 * float(out_p.pos.abs().max())
    tol_v = 1e-5 * float(out_p.vel.abs().max())
    err_x = float((out_k.pos - out_p.pos).abs().max())
    err_v = float((out_k.vel - out_p.vel).abs().max())
    ok = err_x <= tol_x and err_v <= tol_v
    say("main", f"one step kernels vs plain: err_pos={err_x:.3e} "
        f"(tol {tol_x:.3e}) err_vel={err_v:.3e} (tol {tol_v:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "one step through the kernels disagrees with the plain step")

    # -- 6. timings ----------------------------------------------------------
    def time_ms(fn, iters, warmup=1):
        for _ in range(warmup):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def k1(pos, mass):
        return lambda: allpairs_accelerations(pos, mass, eps_sq=1.0)

    def k1_plain(pos, mass):
        return lambda: allpairs_accelerations_plain(pos, mass, eps_sq=1.0)

    def k2(s):
        return lambda: allpairs_collision_deltas(
            s.pos, s.vel, s.mass, s.radius, impulse=1.5)

    def k2_plain(s):
        return lambda: collision_deltas_plain(
            s.pos, s.vel, s.mass, s.radius, impulse=1.5)

    times = {}
    disc65 = uniform_disc(SimConfig(n=65_536), device=dev)
    for n, s in ((25_000, disc), (65_536, disc65)):
        for kname, fk, fp, iters in (("K1", k1(s.pos, s.mass),
                                      k1_plain(s.pos, s.mass), (20, 3)),
                                     ("K2", k2(s), k2_plain(s), (20, 2))):
            ms = time_ms(fk, iters[0])
            plain_ms = time_ms(fp, iters[1])
            times[(kname, n)] = (ms, plain_ms)
            say("timings", f"{kname} disc N={n}: kernel {ms:.4f} ms "
                f"({n * n / ms * 1e3:.4e} pairs/s), plain {plain_ms:.4f} ms "
                f"({n * n / plain_ms * 1e3:.4e} pairs/s)")
    # K2 on a cell-sorted disc: whether the TPU wrapper's sort would pay.
    q = 256
    mn = disc.pos.min(0).values
    span = (disc.pos.max(0).values - mn).clamp_min(1e-9)
    cell = ((disc.pos - mn) / span * q).to(torch.int32).clamp(0, q - 1)
    order = torch.argsort(cell[:, 0] * q + cell[:, 1])
    sorted_disc = disc.replace(pos=disc.pos[order], vel=disc.vel[order],
                               mass=disc.mass[order],
                               radius=disc.radius[order])
    ms_sorted = time_ms(k2(sorted_disc), 20)

    def sort_only():
        c = ((disc.pos - disc.pos.min(0).values) / span * q).to(torch.int32)
        o = torch.argsort(c.clamp(0, q - 1)[:, 0] * q + c[:, 1])
        inv = torch.empty_like(o)
        inv[o] = torch.arange(o.numel(), device=dev)
        return disc.pos[o], disc.vel[o], disc.mass[o], disc.radius[o], inv

    say("timings", f"K2 disc N=25000 on cell-sorted input: {ms_sorted:.4f} "
        f"ms (unsorted {times[('K2', 25_000)][0]:.4f} ms); the sort and "
        f"gathers alone: {time_ms(sort_only, 20):.4f} ms")
    for n in (65_536, 1_048_576):
        pos = uniform((n, 2), -30000.0, 30000.0)
        mass = uniform((n,), 0.1, 10.0)
        ms = time_ms(k1(pos, mass), 3 if n > 100_000 else 20)
        plain = ("plain skipped at N=1M (~1e12 pairs through [2048, 4096] "
                 "blocks: minutes)" if n > 100_000 else
                 f"plain {n * n / time_ms(k1_plain(pos, mass), 3) * 1e3:.4e}"
                 f" pairs/s")
        say("timings", f"K1 uniform N={n}: {ms:.4f} ms, "
            f"{n * n / ms * 1e3:.4e} pairs/s; {plain}")

    kernels = [
        {"name": "K1 allpairs_accelerations", "route": "cuda",
         "source": "nbodysim_tpu_torch/csrc/allpairs.cu",
         "replaces": "nbodysim_tpu/kernels/allpairs.py:56",
         "launches": launches["K1"], "max_abs_err": max(k1_errs),
         "ms": times[("K1", 25_000)][0],
         "plain_ms": times[("K1", 25_000)][1]},
        {"name": "K2 allpairs_collision_deltas", "route": "cuda",
         "source": "nbodysim_tpu_torch/csrc/collide.cu",
         "replaces": "nbodysim_tpu/kernels/collide.py:40",
         "launches": launches["K2"], "max_abs_err": max(k2_errs),
         "ms": times[("K2", 25_000)][0],
         "plain_ms": times[("K2", 25_000)][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
