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
  6. timings  — kernel and plain times at the main path's shapes, K1
                pairs/s at N=65,536 and N=1,048,576, and the tree code at
                N=1,048,576 uniform +-3e4 (bench.py:232's input): one eval
                through the kernels and through the plain versions, its
                stage split, and K3, K4 and K1 (outliers <- all) at the
                eval's shapes beside their plain versions and bounds;
  7. tree     — K3 against its plain version on random partially filled
                bucket grids and on the N=1M grid, K4 at [1M x 4096], K1 at
                [4096 x 1M], the whole tree eval through the kernels against
                the plain route (1e-5 * max|a|) and against exact K1 forces
                (median relative error < 1e-2), Simulation(SimConfig(n=1M,
                enable_collisions=False)) under 'auto' running 20 steps
                with K1, K3 and K4 launched exactly once per step, and the
                N=131,072 disc raising NotImplementedError (it needs the
                deep-overflow chain, not ported).

Then one JSON line with every kernel's numbers (bounds from the H100's
memory rate, f32 rate and MUFU rsqrt rate), the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Any failed check exits non-zero.
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

    import torch.nn.functional as F

    from nbodysim_tpu_torch import ParticleState, SimConfig, Simulation
    from nbodysim_tpu_torch.diagnostics.metrics import kinetic_energy
    from nbodysim_tpu_torch.kernels import _build
    from nbodysim_tpu_torch.kernels.allpairs import (
        _launch, allpairs_accelerations, allpairs_accelerations_plain,
        allpairs_accelerations_wide, source_splits)
    from nbodysim_tpu_torch.kernels.collide import (
        allpairs_collision_deltas, collision_deltas_plain)
    from nbodysim_tpu_torch.kernels.nearfield import (
        bucket_stencil, bucket_stencil_plain)
    from nbodysim_tpu_torch.physics import barneshut as bh
    from nbodysim_tpu_torch.physics.forces import (
        potential_energy, resolve_config_for_state)
    from nbodysim_tpu_torch.physics.integrators import make_step
    from nbodysim_tpu_torch.scenes import uniform_disc

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip())
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say("device", f"{smi} | max SM clock {max_sm_mhz:.0f} MHz, {n_sms} SMs "
        f"| torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"{nvcc[-1]}")
    # The plain versions use elementwise products only, and the tree code's
    # M2L convolution switches cuDNN's TF32 off around its own call; these
    # are left at PyTorch's defaults.
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
    # bench.py:232's input for the force headline and the tree code.
    upos = uniform((1 << 20, 2), -30000.0, 30000.0)
    umass = uniform((1 << 20,), 0.1, 10.0)
    for n in (65_536, 1_048_576):
        pos = (upos if n == 1 << 20 else
               uniform((n, 2), -30000.0, 30000.0))
        mass = umass if n == 1 << 20 else uniform((n,), 0.1, 10.0)
        ms = time_ms(k1(pos, mass), 3 if n > 100_000 else 20)
        plain = ("plain skipped at N=1M (~1e12 pairs through [2048, 4096] "
                 "blocks: minutes)" if n > 100_000 else
                 f"plain {n * n / time_ms(k1_plain(pos, mass), 3) * 1e3:.4e}"
                 f" pairs/s")
        say("timings", f"K1 uniform N={n}: {ms:.4f} ms, "
            f"{n * n / ms * 1e3:.4e} pairs/s; {plain}")

    # Bounds: the larger of the bytes moved over the memory rate and the
    # operations over the peak rate of their unit (H100 SXM: 3.35 TB/s,
    # 67 TFLOP/s f32), with the MUFU rsqrt pipe at
    # 16/clk/SM as the rsqrt unit's rate (132 SMs x 16 x 1.98 GHz = 4.18e12/s
    # at the H100's maximum SM clock).
    mufu_rate = n_sms * 16 * max_sm_mhz * 1e6

    def bound(nbytes, flops, rsqrts=0.0):
        t_bytes = nbytes / 3.35e12
        t_ops = max(flops / 67e12, rsqrts / mufu_rate)
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes > t_ops else "operations")

    # A softened pair in 2D: 2 sub, 2 FMA (d^2 + eps), 3 mul, 2 FMA (sums)
    # = 13 flops and one rsqrt (K1, K3, K4 alike). K2's overlap test on
    # pairs that do not touch (the disc has none): 2 sub, 2 mul + 1 add
    # (d^2), 1 add + 1 mul ((r_i + r_j)^2) = 7 flops.
    def pair_bound(pairs, nbytes):
        return bound(nbytes, 13.0 * pairs, pairs)

    # -- the tree code at N = 1M ---------------------------------------------
    n1m = 1 << 20
    tcfg = SimConfig(n=n1m, enable_collisions=False)
    levels, radius = bh._resolve_levels(tcfg, n1m), bh._resolve_radius(tcfg)
    rr, res, cap = radius - 1, 1 << levels, bh.NEAR_CAP
    eps, gc = tcfg.eps_sq, tcfg.g_const

    def tree(use_kernels):
        return lambda: bh.bh_accelerations(upos, umass, tcfg,
                                           use_kernels=use_kernels)

    tree_ms = time_ms(tree(True), 10, warmup=2)
    tree_plain_ms = time_ms(tree(False), 2)
    say("timings", f"tree eval N={n1m} uniform (L={levels}, R={radius}): "
        f"{tree_ms:.4f} ms through the kernels "
        f"({n1m * n1m / tree_ms * 1e3:.4e} pairs-equivalent/s, N^2/t), "
        f"{tree_plain_ms:.4f} ms through the "
        f"plain versions")

    # Stage split: each stage alone, on the eval's own intermediate inputs.
    ext = bh._extract_heavy_outliers(upos, umass)
    out_i = ext["out_i"]
    opos = upos[out_i]
    k1_src_m = torch.where(ext["is_heavy"], 0.0, umass)
    k4_src_m = torch.where(ext["out_sel"] & ~ext["is_heavy"][out_i],
                           umass[out_i], 0.0)
    grids, corner, size, ci, flat = bh._build_pyramid(
        ext["bulk_pos"], ext["tree_mass"], levels)
    flat_nf = torch.where(ext["is_out"],
                          res * res + torch.arange(n1m, device=dev), flat)
    buckets = bh._bucket_grid(upos, ext["tree_mass"], ci, flat_nf, res, cap,
                              rr)
    stages = {
        "extraction": time_ms(
            lambda: bh._extract_heavy_outliers(upos, umass), 10),
        "heavy coupling": time_ms(lambda: bh.heavy_coupling(
            upos, ext["h_pos"], ext["h_mass"], eps, gc), 10),
        "K1 outliers <- all": time_ms(lambda: allpairs_accelerations(
            opos, None, eps_sq=eps, g_const=gc, src_pos=upos,
            src_mass=k1_src_m), 10),
        "K4 bulk <- outliers": time_ms(lambda: allpairs_accelerations_wide(
            upos, opos, k4_src_m, eps_sq=eps, g_const=gc), 10),
        "pyramid": time_ms(lambda: bh._build_pyramid(
            ext["bulk_pos"], ext["tree_mass"], levels), 10),
    }
    terms = {}
    for lv in range(2, levels + 1):
        stages[f"M2L level {lv}"] = time_ms(
            lambda: bh._m2l_level(grids[lv], corner, size, eps, radius), 10)
        terms[lv] = bh._m2l_level(grids[lv], corner, size, eps, radius)

    def l2l():
        local = terms[2]
        for lv in range(3, levels + 1):
            up = bh._l2l_upsample(local, size / (1 << lv))
            local = tuple(u + t for u, t in zip(up, terms[lv]))
        return local

    local = l2l()
    stages["L2L"] = time_ms(l2l, 10)
    stages["L2P"] = time_ms(
        lambda: bh._l2p_eval(local, ci, upos, corner, size, levels), 10)
    stages["sort and bucket scatter"] = time_ms(lambda: bh._bucket_grid(
        upos, ext["tree_mass"], ci, flat_nf, res, cap, rr), 10)
    stages["K3 near field"] = time_ms(lambda: bucket_stencil(
        *buckets.grid, rr=rr, eps_sq=eps, center_rows=res), 20)
    nax, nay = bucket_stencil(*buckets.grid, rr=rr, eps_sq=eps,
                              center_rows=res)
    stages["bucket gather"] = time_ms(
        lambda: bh._bucket_gather(buckets, nax, nay, res, cap), 10)
    acc_s = bh._bucket_gather(buckets, nax, nay, res, cap)
    overflow = int(buckets.overflow)
    stages[f"residual (overflow {overflow})"] = time_ms(
        lambda: bh._overflow_residual(buckets, acc_s, eps, rr), 3)
    staged = sum(stages.values())
    # The uniform input may leave no cell over the cap (overflow 0, no
    # residual pass); the small tier's cost, as any overflow of 1-1024 runs
    # it, on the same particles:
    residual_small_ms = time_ms(
        lambda: bh._overflow_residual(
            buckets._replace(overflow=torch.ones((), device=dev)), acc_s,
            eps, rr), 3)
    for name, ms in stages.items():
        say("timings", f"  tree stage {name}: {ms:.4f} ms "
            f"({100 * ms / tree_ms:.1f}% of the eval)")
    # Its pass (b), all targets <- 1024 sources, at the JAX package's
    # 2048-wide blocks and at the 32768-wide blocks the port uses on the card.
    o_args = (buckets.pos_s[:1024], buckets.mass_s[:1024],
              buckets.ci_s[:1024])
    pass_b = {bs: time_ms(lambda: bh._near_masked_blocked(
        buckets.pos_s, buckets.ci_s, *o_args, eps, rr, bs), 2)
        for bs in (2048, 32768)}
    say("timings", f"  residual pass (b) [{n1m} x 1024]: "
        f"{pass_b[2048]:.4f} ms in 2048-wide blocks, {pass_b[32768]:.4f} ms "
        f"in 32768-wide blocks")
    say("timings", f"  stages sum to {staged:.4f} ms against the eval's "
        f"{tree_ms:.4f}; the residual's small tier (1024-wide, for an "
        f"overflow of 1-1024) takes {residual_small_ms:.4f} ms")
    # The same input with 20 bodies moved into one cell: the eval as it runs
    # with the small residual tier.
    cpos = upos.clone()
    cpos[:20] = upos[20] + 1e-3 * torch.arange(
        1, 21, device=dev, dtype=torch.float32)[:, None]
    tree_over_ms = time_ms(lambda: bh.bh_accelerations(cpos, umass, tcfg),
                           10, warmup=2)
    say("timings", f"tree eval with 20 bodies moved into one cell (overflow "
        f"{bh.bh_near_overflow(cpos, umass, tcfg)}): {tree_over_ms:.4f} ms")
    # Device busy time of the eval (kernel rows of a torch.profiler trace,
    # their intervals merged) against its wall time.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            tree(True)()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, last_end = 0.0, -math.inf
    for a, b in spans:
        if b > last_end:
            busy_us += b - max(a, last_end)
            last_end = b
    if spans:
        busy_ms = busy_us / 3e3
        say("timings", f"tree eval device busy {busy_ms:.4f} ms per eval "
            f"(torch.profiler, {len(spans)} device rows over 3 evals): "
            f"{100 * busy_ms / tree_ms:.1f}% of the unprofiled "
            f"{tree_ms:.4f} ms, so the device idles "
            f"{100 * (1 - busy_ms / tree_ms):.1f}%")
    else:
        say("timings", "tree eval device busy: not measured (the profiler "
            "recorded no device rows)")

    # K3, K4 and K1 at the eval's shapes: kernel, plain, bound.
    # Occupied slots per cell, and their sum over each cell's (2rr+1)^2
    # neighbours (zero past the grid's columns; the halo rows are zero).
    occ = F.pad((buckets.grid[2] != 0).sum(-1).to(torch.float64), (rr, rr))
    box = sum(occ[ox:ox + res, oy:oy + res]
              for ox in range(2 * rr + 1) for oy in range(2 * rr + 1))
    k3_pairs = float((occ[rr:rr + res, rr:rr + res] * box).sum())
    k3_written = float(cap * box.sum())
    k3_full = float(res * res * cap * cap * (2 * rr + 1) ** 2)
    k3_bytes = 4.0 * (3 * buckets.grid[0].numel() + 2 * res * res * cap)
    k3_bound, k3_by = pair_bound(k3_pairs, k3_bytes)
    k3_plain = time_ms(lambda: bucket_stencil_plain(
        *buckets.grid, rr, eps, res), 2)
    tree_k = {
        "K3": (stages["K3 near field"], k3_plain, k3_bound, k3_by),
        "K4": (stages["K4 bulk <- outliers"], time_ms(
            lambda: allpairs_accelerations_plain(
                upos, None, eps_sq=eps, g_const=gc, src_pos=opos,
                src_mass=k4_src_m), 2),
               *pair_bound(float(n1m) * opos.shape[0],
                           4.0 * (2 * n1m * 2 + 3 * opos.shape[0]))),
        "K1 outliers": (stages["K1 outliers <- all"], time_ms(
            lambda: allpairs_accelerations_plain(
                opos, None, eps_sq=eps, g_const=gc, src_pos=upos,
                src_mass=k1_src_m), 2),
            *pair_bound(float(n1m) * opos.shape[0],
                        4.0 * (3 * n1m + 4 * opos.shape[0]))),
    }
    k1_unsplit = time_ms(lambda: _launch(opos, upos, k1_src_m, eps, gc, "K1",
                                         splits=1), 10)
    say("timings", f"K3 N=1M grid: {k3_pairs:.4e} occupied pairs (the "
        f"bound's work), {k3_written:.4e} evaluated (every target slot x "
        f"occupied sources), {k3_full:.4e} in the full K x K stencil")
    for name, (ms, plain_ms, bnd, by) in tree_k.items():
        say("timings", f"{name} at the tree's shape: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    say("timings", f"K1 outliers without the source split: {k1_unsplit:.4f} "
        f"ms (split into {source_splits(opos.shape[0], n1m, dev)} chunks: "
        f"{tree_k['K1 outliers'][0]:.4f} ms)")

    # -- 7. tree -------------------------------------------------------------
    def k3_case(name, grid, eps_sq, rows, r):
        got = bucket_stencil(*grid, rr=r, eps_sq=eps_sq, center_rows=rows)
        ref = bucket_stencil_plain(*grid, r, eps_sq, rows)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(a).all()) for a in got),
                f"K3 {name}: non-finite")
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        scale = max(float(b.abs().max()) for b in ref)
        ok = err <= 1e-5 * scale
        say("tree", f"K3 {name}: max_abs_err={err:.3e} max|a|={scale:.3e} "
            f"tol={1e-5 * scale:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"K3 {name} disagrees with its plain version")
        return err

    def random_grid(rows, width, slots, r):
        shape = (rows + 2 * r, width, slots)
        m = uniform(shape, 0.0, 2.0)
        m = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.4,
                        m, 0.0)
        return uniform(shape, -5.0, 5.0), uniform(shape, -5.0, 5.0), m

    k3_errs = [
        k3_case("random 40%-filled 12x32x8, rr=2", random_grid(12, 32, 8, 2),
                1.0, 12, 2),
        k3_case("random 40%-filled 512x512x16, rr=2",
                random_grid(512, 512, 16, 2), 1.0, 512, 2),
        k3_case("random 13x37x16, rr=1, eps=0", random_grid(13, 37, 16, 1),
                0.0, 13, 1),
        k3_case(f"the N=1M tree grid {res}x{res}x{cap}, rr={rr}",
                buckets.grid, eps, res, rr),
    ]

    def rect_case(name, fn, tgt, src, src_m):
        got = fn(tgt, src, src_m)
        ref = allpairs_accelerations_plain(tgt, None, eps_sq=eps, g_const=gc,
                                           src_pos=src, src_mass=src_m)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= 1e-5 * scale
        say("tree", f"{name}: max_abs_err={err:.3e} max|a|={scale:.3e} "
            f"tol={1e-5 * scale:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"{name} disagrees with its plain version")
        return err

    k4_err = rect_case(
        f"K4 bulk <- outliers [{n1m} x {opos.shape[0]}]",
        lambda t, sp, sm: allpairs_accelerations_wide(
            t, sp, sm, eps_sq=eps, g_const=gc), upos, opos, k4_src_m)
    k1_tree_err = rect_case(
        f"K1 outliers <- all [{opos.shape[0]} x {n1m}]",
        lambda t, sp, sm: allpairs_accelerations(
            t, None, eps_sq=eps, g_const=gc, src_pos=sp, src_mass=sm),
        opos, upos, k1_src_m)

    a_kern = bh.bh_accelerations(upos, umass, tcfg)
    a_plain = bh.bh_accelerations(upos, umass, tcfg, use_kernels=False)
    a_exact = allpairs_accelerations(upos, umass, eps_sq=eps, g_const=gc)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(a_kern).all()), "tree eval: non-finite")
    err = float((a_kern - a_plain).abs().max())
    scale = float(a_plain.abs().max())
    say("tree", f"tree eval N={n1m} kernels vs plain route: max_abs_err="
        f"{err:.3e} max|a|={scale:.3e} tol={1e-5 * scale:.3e} (index_add_ "
        f"atomics vary the pyramid's last bits) "
        f"{'ok' if err <= 1e-5 * scale else 'FAIL'}")
    require(err <= 1e-5 * scale, "tree eval through the kernels disagrees "
            "with the plain route")
    a_kern_o = bh.bh_accelerations(cpos, umass, tcfg)
    a_plain_o = bh.bh_accelerations(cpos, umass, tcfg, use_kernels=False)
    torch.cuda.synchronize()
    err_o = float((a_kern_o - a_plain_o).abs().max())
    scale_o = float(a_plain_o.abs().max())
    ok_o = bool(torch.isfinite(a_kern_o).all()) and err_o <= 1e-5 * scale_o
    say("tree", f"tree eval with the small residual tier, kernels vs plain "
        f"route: max_abs_err={err_o:.3e} max|a|={scale_o:.3e} "
        f"tol={1e-5 * scale_o:.3e} {'ok' if ok_o else 'FAIL'}")
    require(ok_o, "tree eval with overflow disagrees with the plain route")
    rel = ((a_kern - a_exact).norm(dim=1)
           / (a_exact.norm(dim=1) + 1e-12))
    med = float(rel.median())
    say("tree", f"tree vs exact K1 N={n1m}: median relative error "
        f"{med:.4e}, 99th percentile "
        f"{float(rel.kthvalue(int(0.99 * n1m)).values):.4e}"
        f" (bound: median < 1e-2) {'ok' if med < 1e-2 else 'FAIL'}")
    require(med < 1e-2, "tree forces too far from the exact ones")

    # The tree's main path: Simulation under 'auto' at N = 1M.
    state = ParticleState.create(upos, torch.zeros_like(upos), umass)
    tsim = Simulation(tcfg, state=state, device="cuda")
    require(tsim.config.force_backend == "bh",
            f"N=1M force backend resolved to {tsim.config.force_backend}")
    tsim.run(2)  # warm-up
    torch.cuda.synchronize()
    allpairs_accelerations.launches = 0
    allpairs_accelerations_wide.launches = 0
    bucket_stencil.launches = 0
    start.record()
    tsim.run(20)
    end.record()
    torch.cuda.synchronize()
    tree_launches = {"K1": allpairs_accelerations.launches,
                     "K3": bucket_stencil.launches,
                     "K4": allpairs_accelerations_wide.launches}
    tree_steps_per_s = 20 / (start.elapsed_time(end) / 1e3)
    say("tree", f"launches during run(20) at N={n1m}: {tree_launches}; "
        f"{tree_steps_per_s:.3f} steps/s (CUDA events, after 2 warm-up "
        f"steps)")
    require(tree_launches == {"K1": 20, "K3": 20, "K4": 20},
            f"tree kernel launches {tree_launches}, expected 20 each")
    st = tsim.state
    for name in ("pos", "vel", "acc"):
        require(bool(torch.isfinite(getattr(st, name)).all()),
                f"tree path: non-finite {name}")
    ke = float(kinetic_energy(st))
    pe = float(potential_energy(st.pos, st.mass, eps, gc, block_size=8192))
    say("tree", f"frame {tsim.frame}: KE={ke:.6e} PE={pe:.6e}")
    require(math.isfinite(ke) and math.isfinite(pe),
            "tree path: non-finite energies")

    disc131 = uniform_disc(SimConfig(n=131_072), device=dev)
    try:
        resolve_config_for_state(disc131.pos, disc131.mass,
                                 SimConfig(n=131_072))
    except NotImplementedError as exc:
        say("tree", f"uniform_disc N=131072 under auto raises "
            f"NotImplementedError: {exc}")
    else:
        fail("uniform_disc N=131072 under auto did not raise; it needs the "
             "deep-overflow chain")

    n25 = 25_000.0
    k1_bound, k1_by = pair_bound(n25 * n25, 4.0 * n25 * (3 + 2))
    k2_bound, k2_by = bound(4.0 * n25 * (2 + 2 + 1 + 1 + 2 + 2),
                            7.0 * n25 * n25)

    def entry(name, source, replaces, launched, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    allpairs_cu = "nbodysim_tpu_torch/csrc/allpairs.cu"
    kernels = [
        entry("K1 allpairs_accelerations (N=25k main path)", allpairs_cu,
              "nbodysim_tpu/kernels/allpairs.py:56", launches["K1"],
              max(k1_errs), *times[("K1", 25_000)], (k1_bound, k1_by)),
        entry("K1 allpairs_accelerations (tree: 4096 outliers <- 1M)",
              allpairs_cu, "nbodysim_tpu/kernels/allpairs.py:56",
              tree_launches["K1"], k1_tree_err,
              *tree_k["K1 outliers"][:2], tree_k["K1 outliers"][2:]),
        entry("K2 allpairs_collision_deltas",
              "nbodysim_tpu_torch/csrc/collide.cu",
              "nbodysim_tpu/kernels/collide.py:40", launches["K2"],
              max(k2_errs), *times[("K2", 25_000)], (k2_bound, k2_by)),
        entry("K3 bucket_stencil", "nbodysim_tpu_torch/csrc/nearfield.cu",
              "nbodysim_tpu/kernels/nearfield.py:49", tree_launches["K3"],
              max(k3_errs), *tree_k["K3"][:2], tree_k["K3"][2:]),
        entry("K4 allpairs_accelerations_wide", allpairs_cu,
              "nbodysim_tpu/kernels/allpairs.py:105", tree_launches["K4"],
              k4_err, *tree_k["K4"][:2], tree_k["K4"][2:]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
