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
                deep-overflow chain, not ported);
  8. collide  — K5 against its plain version on 2D and 3D colliding clouds
                (max_cheb 1 and None), at both big-body shapes [64 x 1M] and
                [1M x 64] (with smalls moved inside the nuclei, so pairs
                fire) and at the full-cap residual shape [1M x 16384]; K6
                and the whole block pass through the kernels against the
                plain route on 2D and 3D blobs with uncovered blocks and on
                the N=1M galaxy merger (1e-5 * max(max|v|, 10), momentum);
                K1 on the merger's N=1M state against its plain version on
                4096 rows (1e-5 * max|a|); the N=4M merger under 'auto'
                (block pass, its overflow, launches of one pass, one pass
                timed by stage); Simulation of the N=1M merger (force_backend
                "cuda", collisions resolved to the block pass): 1 warm-up
                step, then run(3) with K1 and K6 launched once per step and
                K5 at least twice; one bucket pass on phase 6's N=1M uniform
                input with random velocities under 'auto';
  9. tree3d   — K7 against its plain version on random partially filled 3D
                bucket grids (rr = 1..4, eps = 0) and on the N=1M cube's
                grid, K1 at [4096 x 1M] and K4 at [1M x 4096] in 3D, the
                octree eval at N=1,048,576 uniform +-3e4 (profiling.py:99's
                input; its bucket overflow and residual tier printed) through
                the kernels against the plain route (1e-5 * max|a|) and
                against exact K1 forces on 4096 rows (median relative error
                < 1.5e-2), one eval timed whole and by stage with its device
                idle share, Simulation(SimConfig(n=1M, dim=3,
                enable_collisions=False)) under 'auto' running 20 steps with
                K1, K4 and K7 launched exactly once per step, and a 3D
                Plummer sphere at N=131,072 raising NotImplementedError (it
                needs the deep-overflow chain, not ported).

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
import warnings


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def k5_needed_pairs(tgt, src, max_cheb, chunk=8192) -> float:
    """K5's pair tests that this data needs (the bound's work): both masses
    > 0 and, with `max_cheb`, int32 cells within that Chebyshev distance."""
    t_live, s_live = tgt[2] > 0, src[2] > 0
    if max_cheb is None:
        return float(t_live.sum()) * float(s_live.sum())
    tc, sc = tgt[4][t_live], src[4][s_live]
    total = 0
    for i in range(0, tc.shape[0], chunk):
        cheb = (sc[None] - tc[i:i + chunk, None]).abs().amax(-1)
        total = total + (cheb <= max_cheb).sum()
    return float(total)


def k6_needed_pairs(s, planes) -> float:
    """Pairs that K6's masks let through on this data (the bound's work):
    keys, both rows `ok`, not the same row. Per ok target, the ok rows of
    its 3^D neighbouring cells: one lex range of the sorted keys per lead
    offset, the trailing key within +-1."""
    import torch
    import torch.nn.functional as F

    from nbodysim_tpu_torch.kernels.collide_block import lead_offsets
    from nbodysim_tpu_torch.physics.collisions import _lex_searchsorted

    keys = s.keys
    dim = keys.shape[0]
    ok = planes[-1] > 0
    cum = F.pad(torch.cumsum(ok.to(torch.int64), 0), (1, 0))
    kt = keys[:, ok]
    offs = torch.tensor(lead_offsets(dim), dtype=torch.int32,
                        device=keys.device)                   # [n_off, D-1]
    lead = [kt[a][:, None] + offs[None, :, a] for a in range(dim - 1)]
    tail = kt[dim - 1][:, None].expand(-1, offs.shape[0])
    lo = _lex_searchsorted(list(keys), lead + [tail - 1], False, s.n_tot)
    hi = _lex_searchsorted(list(keys), lead + [tail + 1], True, s.n_tot)
    return float((cum[hi.long()] - cum[lo.long()]).sum() - kt.shape[1])


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
        allpairs_collision_deltas, collision_deltas_plain, rect_pair_deltas,
        rect_pair_deltas_plain)
    from nbodysim_tpu_torch.kernels.collide_block import (
        block_collision_deltas, block_collision_deltas_plain)
    from nbodysim_tpu_torch.kernels.nearfield import (
        bucket_stencil, bucket_stencil3, bucket_stencil3_plain,
        bucket_stencil_plain)
    from nbodysim_tpu_torch.physics import barneshut as bh
    from nbodysim_tpu_torch.physics import barneshut3d as bh3
    from nbodysim_tpu_torch.physics import collisions as coll
    from nbodysim_tpu_torch.physics.forces import (
        _partial_potential, potential_energy, resolve_config_for_state)
    from nbodysim_tpu_torch.physics.integrators import make_step
    from nbodysim_tpu_torch.scenes import init_scene, uniform_disc

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
            f"{n * n / ms * 1e3:.4e} pairs/s; {plain}; bound "
            "{:.4f} ms ({})".format(*pair_bound(float(n) * n,
                                                4.0 * n * (3 + 2))))

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
        lambda: bh._bucket_gather(buckets, (nax, nay), res, cap), 10)
    acc_s = bh._bucket_gather(buckets, (nax, nay), res, cap)
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

    # -- 8. collide ----------------------------------------------------------
    t_phase8 = time.perf_counter()

    def collide_close(name, got, ref, vel, extra=""):
        """K2's rule: within 1e-5 * max(max|v|, 10) of the plain version."""
        tol = 1e-5 * max(float(vel.abs().max()), 10.0)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        ok = all(bool(torch.isfinite(a).all()) for a in got) and err <= tol
        say("collide", f"{name}: max_abs_err={err:.3e} tol={tol:.3e}{extra} "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name} disagrees with its plain version")
        return err

    def momentum_ok(name, mass, v0, v1):
        p0 = (mass[:, None] * v0).sum(0)
        p1 = (mass[:, None] * v1).sum(0)
        drift = float((p1 - p0).abs().max())
        tol = 1e-5 * float((mass[:, None] * v0.abs()).sum())
        say("collide", f"{name}: momentum drift {drift:.3e} (tol {tol:.3e}) "
            f"{'ok' if drift <= tol else 'FAIL'}")
        require(drift <= tol, f"{name}: momentum not conserved")

    def cloud(n, dim, half):
        mass = uniform((n,), 0.5, 2.0)
        radius = mass.pow(1 / 3) * 1.5
        mass[::7] = 0.0
        pos = uniform((n, dim), -half, half)
        return (pos, uniform((n, dim), -5.0, 5.0), mass, radius,
                torch.floor(pos / 3.0).to(torch.int32))

    def overlapping_pairs(tgt, src, max_cheb):
        d = src[0][None] - tgt[0][:, None]
        hit = ((d * d).sum(-1) <= (tgt[3][:, None] + src[3][None]) ** 2)
        hit &= (tgt[2][:, None] > 0) & (src[2][None] > 0)
        if max_cheb is not None:
            hit &= (src[4][None] - tgt[4][:, None]).abs().amax(-1) <= max_cheb
        return int(hit.sum())

    def since():
        return f"[{time.perf_counter() - t_phase8:.1f} s into phase 8]"

    def timed(fn):
        """One call of `fn` and its time (CUDA events): the plain versions'
        times at the large shapes come from their one comparison run."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    plain_ms = {}

    def k5_case(name, tgt, src, max_cheb, need_hits):
        got = rect_pair_deltas(tgt, src, dim=tgt[0].shape[1], impulse=1.5,
                               max_cheb=max_cheb)
        ref, plain_ms[name] = timed(lambda: rect_pair_deltas_plain(
            tgt, src, dim=tgt[0].shape[1], impulse=1.5, max_cheb=max_cheb))
        extra = ""
        if need_hits:
            hits = overlapping_pairs(tgt, src, max_cheb)
            extra = f" overlapping pairs={hits}"
            require(hits > 0, f"K5 {name}: no overlapping pair")
        return collide_close(f"K5 {name}", got, ref, tgt[1] + ref[1], extra)

    for dim, half in ((2, 37.0), (3, 24.0)):
        tgt, src = cloud(4096, dim, half), cloud(2048, dim, half)
        for mc in (1, None):
            k5_case(f"{dim}D cloud 4096 <- 2048, max_cheb={mc}", tgt, src, mc,
                    True)

    # The N = 1M galaxy merger: the main path's scene.
    n_m = 1 << 20
    mcfg = SimConfig(n=n_m, dt=0.05, integrator="leapfrog_kdk",
                     force_backend="cuda")
    merger = init_scene("galaxy_merger", mcfg, device=dev)
    bcfg = mcfg.replace(collision_broad_phase="block",
                        collision_cell_size=0.0)
    ms_ = coll._block_structure(merger.pos, merger.radius, bcfg)
    mbp = coll._block_planes(merger, ms_)
    fs = mbp.fields_s
    bigs = ms_.bigs
    big_src = (merger.pos[bigs.top_i], merger.vel[bigs.top_i],
               torch.where(bigs.big_sel, merger.mass[bigs.top_i], 0.0),
               merger.radius[bigs.top_i], ms_.cell[bigs.top_i])
    small_src = (fs[0], fs[1], torch.where(mbp.big_s, 0.0, fs[2]), fs[3],
                 fs[4])
    say("collide", f"merger N={n_m}: cell {float(bigs.cell_size):.4f}, "
        f"{int(bigs.is_big.sum())} big bodies, "
        f"{int((~ms_.ok_blk).sum())} of {ms_.ok_blk.numel()} blocks "
        f"uncovered")
    k5_big_name = f"bigs <- all [{bigs.top_i.numel()} x {n_m}]"
    # The scene's nuclei overlap no small body (no pair fires): the same
    # shapes again with 64 smalls moved inside the nuclei.
    big_rows = bigs.top_i[bigs.big_sel]
    moved = torch.randperm(n_m, generator=gen, device=dev)[:64]
    moved = moved[~mbp.big_s[moved]]
    near = torch.arange(moved.numel(), device=dev) % big_rows.numel()
    ang = uniform((moved.numel(),), 0.0, 2 * math.pi)
    dist = uniform((moved.numel(),), 0.1, 0.9) * merger.radius[big_rows][near]
    pos_in = fs[0].clone()
    pos_in[moved] = merger.pos[big_rows][near] + dist[:, None] * torch.stack(
        [ang.cos(), ang.sin()], 1)
    fs_in = (pos_in,) + tuple(fs[1:])
    k5_big_errs = [
        k5_case(k5_big_name, big_src, small_src, None, False),
        k5_case(f"bigs <- all, {moved.numel()} smalls inside the nuclei",
                big_src, (pos_in,) + tuple(small_src[1:]), None, True),
        k5_case(f"all <- bigs [{n_m} x {bigs.top_i.numel()}], "
                f"{moved.numel()} smalls inside the nuclei", fs_in, big_src,
                None, True)]
    sel = torch.randperm(n_m, generator=gen, device=dev)[:coll._OVERFLOW_CAP]
    o_src = tuple(f[sel] for f in fs)
    k5_res_name = f"full-cap residual [{n_m} x {coll._OVERFLOW_CAP}]"
    k5_res_err = k5_case(k5_res_name, fs, o_src, 1, False)
    say("collide", f"K5 checks done {since()}")

    # K6 and the whole block pass: kernels against the plain route.
    def block_case(name, state, cfg):
        s_ = coll._block_structure(state.pos, state.radius, cfg)
        planes = coll._block_planes(state, s_).planes
        args = (planes, s_.keys, s_.w_lo, s_.w_hi)
        got = block_collision_deltas(*args, t_blk=s_.t_blk, impulse=1.5)
        ref, plain_ms[name] = timed(lambda: block_collision_deltas_plain(
            *args, t_blk=s_.t_blk, impulse=1.5))
        over = coll.collision_block_overflow(state, cfg)
        err = collide_close(f"K6 {name}", got, ref, state.vel,
                            f" block overflow={over}")
        # The pass's deltas (positions of ~3e5 would round pos + dpos to
        # 0.03), then the pass as the step calls it.
        kern = coll._block_deltas(state, cfg, True)
        plain = coll._block_deltas(state, cfg, False)
        torch.cuda.synchronize()
        collide_close(f"block pass {name}, kernels vs plain route", kern,
                      plain, state.vel + plain[1])
        out = coll.resolve_collisions(state, cfg)
        momentum_ok(f"block pass {name}", state.mass, state.vel, out.vel)
        return err, over

    k6_errs = []
    for dim, half in ((2, 120.0), (3, 32.0)):
        n_b = 32_768
        pos = uniform((n_b, dim), -half, half)
        pos[:3000] = uniform((3000, dim), 0.05, 0.95)   # one crowded cell
        mass = uniform((n_b,), 0.5, 2.0)
        radius = uniform((n_b,), 0.5, 1.0)
        radius[0], mass[0] = 15.0, 100.0                 # one big body
        blob = ParticleState.create(pos, uniform((n_b, dim), -5.0, 5.0),
                                    mass, radius)
        err, over = block_case(
            f"{dim}D blob N={n_b}", blob,
            SimConfig(n=n_b, dim=dim, collision_broad_phase="block",
                      collision_cell_size=0.0))
        require(over > 0, f"{dim}D blob: no uncovered block")
        k6_errs.append(err)
    k6_merger_name = f"merger N={n_m}"
    k6_errs.append(block_case(k6_merger_name, merger, bcfg)[0])
    say("collide", f"K6 and block pass checks done {since()}")

    # K1 at the main path's own shape and input: the merger's N = 1M state,
    # unsplit, against its plain version on 4096 random target rows.
    a_m, k1_merger_ms = timed(lambda: allpairs_accelerations(
        merger.pos, merger.mass, eps_sq=mcfg.eps_sq, g_const=mcfg.g_const))
    rows = torch.randperm(n_m, generator=gen, device=dev)[:4096]
    ref_rows, k1_rows_plain_ms = timed(lambda: allpairs_accelerations_plain(
        merger.pos[rows], None, eps_sq=mcfg.eps_sq, g_const=mcfg.g_const,
        src_pos=merger.pos, src_mass=merger.mass))
    k1_merger_err = float((a_m[rows] - ref_rows).abs().max())
    scale = float(ref_rows.abs().max())
    ok = (bool(torch.isfinite(a_m).all())
          and k1_merger_err <= 1e-5 * scale)
    # Both against the same rows in f64: how far each f32 sum drifts.
    ref64 = allpairs_accelerations_plain(
        merger.pos[rows].double(), None, eps_sq=mcfg.eps_sq,
        g_const=mcfg.g_const, src_pos=merger.pos.double(),
        src_mass=merger.mass.double())
    say("collide", f"K1 merger [{n_m} x {n_m}]: {k1_merger_ms:.4f} ms "
        f"(one launch), 4096 rows against the plain version "
        f"({k1_rows_plain_ms:.4f} ms): max_abs_err={k1_merger_err:.3e} "
        f"max|a|={scale:.3e} tol={1e-5 * scale:.3e} "
        f"{'ok' if ok else 'FAIL'}; against f64: kernel "
        f"{float((a_m[rows] - ref64).abs().max()):.3e}, plain "
        f"{float((ref_rows - ref64).abs().max()):.3e}")
    require(ok, "K1 on the N=1M merger disagrees with its plain version")
    del a_m

    # The N = 4M merger under 'auto': one pass, timed by stage.
    n4 = 1 << 22
    cfg4 = SimConfig(n=n4, dt=0.05, integrator="leapfrog_kdk",
                     force_backend="cuda")
    merger4 = init_scene("galaxy_merger", cfg4, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg4 = coll.resolve_collision_phase_for_state(merger4, cfg4)
    require((cfg4.collision_broad_phase, cfg4.collision_cell_size)
            == ("block", 0.0), f"N=4M merger resolved to "
            f"{cfg4.collision_broad_phase}, cell {cfg4.collision_cell_size}")
    over4 = coll.collision_block_overflow(merger4, cfg4)
    say("collide", f"merger N={n4} under auto: {cfg4.collision_broad_phase} "
        f"(cell size {cfg4.collision_cell_size}; {len(caught)} warning: "
        f"{str(caught[0].message)[:60] if caught else ''}...), block "
        f"overflow {over4}")
    counted = (allpairs_accelerations, allpairs_accelerations_wide,
               allpairs_collision_deltas, bucket_stencil, rect_pair_deltas,
               block_collision_deltas)
    for c in counted:
        c.launches = 0
    coll.resolve_collisions(merger4, cfg4)
    torch.cuda.synchronize()
    pass4_launches = {"K5": rect_pair_deltas.launches,
                      "K6": block_collision_deltas.launches,
                      "other": sum(c.launches for c in counted[:4])}
    say("collide", f"launches during one pass at N={n4}: {pass4_launches}")
    require(pass4_launches == {"K5": 4 if over4 > 0 else 2, "K6": 1,
                               "other": 0},
            f"N=4M pass launches {pass4_launches}: expected K6 once, K5 "
            f"twice for the bigs and twice for the residual")
    pass4_ms = time_ms(lambda: coll.resolve_collisions(merger4, cfg4), 5,
                       warmup=2)
    s4 = coll._block_structure(merger4.pos, merger4.radius, cfg4)
    bp4 = coll._block_planes(merger4, s4)
    dp4, dv4 = coll._block_dense_deltas(bp4.planes, s4, cfg4, True)
    dp4, dv4 = dp4[:n4], dv4[:n4]
    inv4 = torch.empty_like(s4.order)
    inv4[s4.order] = torch.arange(n4, device=dev)
    top4 = s4.bigs.top_i
    big4 = (merger4.pos[top4], merger4.vel[top4],
            torch.where(s4.bigs.big_sel, merger4.mass[top4], 0.0),
            merger4.radius[top4], s4.cell[top4])

    def scatter_back():
        inv = torch.empty_like(s4.order)
        inv[s4.order] = torch.arange(n4, device=dev)
        return merger4.pos + dp4[inv], merger4.vel + dv4[inv]

    stages4 = {
        "structure and sort": time_ms(lambda: coll._block_planes(
            merger4, coll._block_structure(merger4.pos, merger4.radius,
                                           cfg4)), 5),
        "K6": time_ms(lambda: coll._block_dense_deltas(bp4.planes, s4, cfg4,
                                                       True), 10),
        "big-body K5 (2 launches)": time_ms(
            lambda: coll._big_body_corrections(
                dp4, dv4, bp4.fields_s, bp4.big_s, big4, s4.bigs.big_sel,
                inv4[top4], 1.5, 2, True), 10),
    }
    # The residual's own launches, counted over one call on the pass's
    # intermediates (the JSON line's residual-shape K5 entry).
    rect_pair_deltas.launches = 0
    if over4 > 0:
        coll._residual_corrections(dp4, dv4, bp4.fields_s, bp4.ok_p,
                                   bp4.big_s, 1.5, 2, True)
        torch.cuda.synchronize()
        residual_launches = rect_pair_deltas.launches
        stages4["residual K5 (2 launches)"] = time_ms(
            lambda: coll._residual_corrections(
                dp4, dv4, bp4.fields_s, bp4.ok_p, bp4.big_s, 1.5, 2, True), 5)
    else:
        residual_launches = 0
    stages4["scatter back"] = time_ms(scatter_back, 10)
    say("collide", f"merger N={n4}: one block pass {pass4_ms:.4f} ms "
        f"through the kernels (CUDA events, 5 passes after 2)")
    for name, ms in stages4.items():
        say("collide", f"  stage {name}: {ms:.4f} ms "
            f"({100 * ms / pass4_ms:.1f}% of the pass)")
    span4 = (s4.w_hi - s4.w_lo).clamp_min(0)
    say("collide", f"K6 N={n4}: {k6_needed_pairs(s4, bp4.planes):.4e} pairs "
        f"through its masks (the bound's work), "
        f"{float(span4[s4.ok_blk].sum()) * s4.t_blk:.4e} in-span pairs "
        f"tested, {s4.ok_blk.numel() * span4.shape[1] * (2 * s4.t_blk + 512) * s4.t_blk:.4e} "
        f"in the TPU form's fixed windows")
    del merger4, s4, bp4, dp4, dv4, inv4
    say("collide", f"N=4M pass timed {since()}")

    # The main path of this slice: Simulation of the N = 1M merger.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        msim = Simulation(mcfg, scene="galaxy_merger", device="cuda")
    require(msim.config.collision_broad_phase == "block",
            f"N=1M merger collisions resolved to "
            f"{msim.config.collision_broad_phase}")
    require(msim.config.force_backend == "cuda",
            f"N=1M merger force backend {msim.config.force_backend}")
    msim.run(1)  # warm-up
    torch.cuda.synchronize()
    for c in counted:
        c.launches = 0
    start.record()
    msim.run(3)
    end.record()
    torch.cuda.synchronize()
    merger_launches = {"K1": allpairs_accelerations.launches,
                       "K2": allpairs_collision_deltas.launches,
                       "K3": bucket_stencil.launches,
                       "K4": allpairs_accelerations_wide.launches,
                       "K5": rect_pair_deltas.launches,
                       "K6": block_collision_deltas.launches}
    merger_steps_per_s = 3 / (start.elapsed_time(end) / 1e3)
    say("collide", f"launches during run(3) of the N={n_m} merger: "
        f"{merger_launches}; {merger_steps_per_s:.4f} steps/s (CUDA events, "
        f"after 1 warm-up step; {len(caught)} warnings at init)")
    require(merger_launches["K1"] == 3 and merger_launches["K6"] == 3
            and merger_launches["K5"] >= 6 and merger_launches["K5"] % 2 == 0
            and merger_launches["K2"] == merger_launches["K3"]
            == merger_launches["K4"] == 0,
            f"merger kernel launches {merger_launches}: expected K1 and K6 "
            f"once per step, K5 at least twice")
    mst = msim.state
    for name in ("pos", "vel", "acc"):
        require(bool(torch.isfinite(getattr(mst, name)).all()),
                f"merger path: non-finite {name}")
    ke = float(kinetic_energy(mst))
    # The potential over pairs of 65536-row slabs j >= i, off-diagonal
    # slabs counted twice: half the pair work of potential_energy.
    slab = 1 << 16
    pe_sum = 0.0
    for i0 in range(0, n_m, slab):
        for j0 in range(i0, n_m, slab):
            part = _partial_potential(
                mst.pos[i0:i0 + slab], mst.mass[i0:i0 + slab],
                mst.pos[j0:j0 + slab], mst.mass[j0:j0 + slab],
                mcfg.eps_sq, block_size=8192)
            pe_sum += (1.0 if i0 == j0 else 2.0) * float(part)
    pe = -0.5 * mcfg.g_const * pe_sum
    say("collide", f"merger frame {msim.frame}: KE={ke:.6e} PE={pe:.6e} "
        f"{since()}")
    require(math.isfinite(ke) and math.isfinite(pe),
            "merger path: non-finite energies")

    # Kernel and plain times at the main path's shapes (the N=1M merger).
    k6_args = (mbp.planes, ms_.keys, ms_.w_lo, ms_.w_hi)
    k6_ms = time_ms(lambda: block_collision_deltas(
        *k6_args, t_blk=ms_.t_blk, impulse=1.5), 20)
    k6_plain_ms = plain_ms[k6_merger_name]
    # The bound's work is the pairs K6's masks let through on this data;
    # the in-span pairs it tests and the TPU form's windows beside it.
    span_m = (ms_.w_hi - ms_.w_lo).clamp_min(0)
    k6_in_span = float(span_m[ms_.ok_blk].sum()) * ms_.t_blk
    k6_pairs = k6_needed_pairs(ms_, mbp.planes)
    n_tot = ms_.n_tot
    k6_bnd = bound(4.0 * (n_tot * (2 * 2 + 3) + n_tot * 2 + 2 * n_tot * 2
                          + 2 * span_m.numel()), 7.0 * k6_pairs)
    say("collide", f"K6 merger N={n_m}: kernel {k6_ms:.4f} ms, plain "
        f"{k6_plain_ms:.4f} ms, {k6_pairs:.4e} pairs through its masks (the "
        f"bound's work), {k6_in_span:.4e} in-span pairs tested "
        f"({k6_in_span / k6_ms * 1e3:.4e} pairs/s), "
        f"{ms_.ok_blk.numel() * span_m.shape[1] * (2 * ms_.t_blk + 512) * ms_.t_blk:.4e}"
        f" in the TPU form's windows, bound {k6_bnd[0]:.4f} ms "
        f"({k6_bnd[1]})")

    def k5_times(tgt, src, max_cheb, name):
        kw = dict(dim=2, impulse=1.5, max_cheb=max_cheb)
        ms = time_ms(lambda: rect_pair_deltas(tgt, src, **kw), 10)
        plain = plain_ms[name]
        cols = 2 + 2 + 1 + 1 + (0 if max_cheb is None else 2)
        rows_t, rows_s = tgt[0].shape[0], src[0].shape[0]
        needed = k5_needed_pairs(tgt, src, max_cheb)
        bnd = bound(4.0 * (cols * (rows_t + rows_s) + 4 * rows_t),
                    7.0 * needed)
        return ms, plain, bnd, needed, float(rows_t) * rows_s

    k5_big = k5_times(big_src, small_src, None, k5_big_name)
    k5_res = k5_times(fs, o_src, 1, k5_res_name)
    for name, (ms, plain, bnd, needed, tested) in (
            (f"bigs <- all [64 x {n_m}]", k5_big),
            (f"residual [{n_m} x {coll._OVERFLOW_CAP}]", k5_res)):
        say("collide", f"K5 {name}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, {needed:.4e} pairs through its masks (the bound's work) "
            f"of {tested:.4e} tested, bound {bnd[0]:.4f} ms ({bnd[1]})")

    # One bucket pass: phase 6's N = 1M uniform input, random velocities.
    ustate = ParticleState.create(upos, uniform((n1m, 2), -5.0, 5.0), umass)
    ucfg = coll.resolve_collision_phase_for_state(ustate, SimConfig(n=n1m))
    require(coll._broad_phase(ustate, ucfg) == "bucket",
            f"N=1M uniform collisions resolved to "
            f"{coll._broad_phase(ustate, ucfg)}")
    bucket_ms = time_ms(lambda: coll.resolve_collisions(ustate, ucfg), 3)
    uout = coll.resolve_collisions(ustate, ucfg)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(uout.pos).all()
                 and torch.isfinite(uout.vel).all()),
            "bucket pass: non-finite")
    say("collide", f"bucket pass N={n1m} uniform: {bucket_ms:.4f} ms "
        f"(overflow {coll.collision_bucket_overflow(ustate, ucfg)}, "
        f"bodies moved {int(((uout.pos - upos).abs().sum(-1) > 0).sum())})")
    momentum_ok("bucket pass N=1M", umass, ustate.vel, uout.vel)
    say("collide", f"phase 8 took {time.perf_counter() - t_phase8:.1f} s")

    # -- 9. tree3d -----------------------------------------------------------
    t_phase9 = time.perf_counter()

    def k7_case(name, grid, eps_sq, rows, r):
        got = bucket_stencil3(*grid, rr=r, eps_sq=eps_sq, center_rows=rows)
        ref = bucket_stencil3_plain(*grid, r, eps_sq, rows)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(a).all()) for a in got),
                f"K7 {name}: non-finite")
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        scale = max(float(b.abs().max()) for b in ref)
        ok = err <= 1e-5 * scale
        say("tree3d", f"K7 {name}: max_abs_err={err:.3e} max|a|={scale:.3e} "
            f"tol={1e-5 * scale:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"K7 {name} disagrees with its plain version")
        return err

    def random_grid3(rows, width, slots, r, fill):
        shape = (rows + 2 * r, width, width, slots)
        m = uniform(shape, 0.0, 2.0)
        m = torch.where(torch.rand(shape, generator=gen, device=dev) < fill,
                        m, 0.0)
        return tuple(uniform(shape, -5.0, 5.0) for _ in range(3)) + (m,)

    k7_errs = [
        k7_case(f"random 30%-filled 64^3 x 16, rr={r}",
                random_grid3(64, 64, 16, r, 0.3), 1.0, 64, r)
        for r in (1, 2)]
    k7_errs += [
        k7_case("random 30%-filled 20x21x21 x 16, rr=3",
                random_grid3(20, 21, 16, 3, 0.3), 1.0, 20, 3),
        k7_case("random 30%-filled 20x21x21 x 16, rr=4",
                random_grid3(20, 21, 16, 4, 0.3), 1.0, 20, 4),
        k7_case("random 13x18x18 x 16, rr=1, eps=0",
                random_grid3(13, 18, 16, 1, 0.3), 0.0, 13, 1),
        k7_case("random 9x11x11 x 8, rr=4, eps=0",
                random_grid3(9, 11, 8, 4, 0.3), 0.0, 9, 4),
    ]

    # The JAX package's 3D headline input (diagnostics/profiling.py:99-101).
    n3 = 1 << 20
    cfg3 = SimConfig(n=n3, dim=3, enable_collisions=False)
    pos3 = uniform((n3, 3), -30000.0, 30000.0)
    mass3 = uniform((n3,), 0.1, 10.0)
    levels3 = bh3._resolve_levels3(cfg3, n3)
    radius3 = bh3._resolve_radius3(cfg3)
    rr3, res3 = radius3 - 1, 1 << levels3

    def tier(over):
        if over == 0:
            return "none (no residual pass)"
        if over <= min(n3, bh._OVERFLOW_SMALL):
            return f"small ({bh._OVERFLOW_SMALL}-wide)"
        return f"full ({min(n3, bh._OVERFLOW_CAP)}-wide)"

    over3 = bh3.bh3_near_overflow(pos3, mass3, cfg3)
    say("tree3d", f"uniform cube N={n3} +-3e4: {res3}^3 cells (L={levels3}), "
        f"R={radius3}; bucket overflow {over3}, residual tier {tier(over3)}")

    ext3 = bh._extract_heavy_outliers(pos3, mass3)
    out3 = ext3["out_i"]
    opos3 = pos3[out3]
    k1_src3 = torch.where(ext3["is_heavy"], 0.0, mass3)
    k4_src3 = torch.where(ext3["out_sel"] & ~ext3["is_heavy"][out3],
                          mass3[out3], 0.0)
    k4_err3 = rect_case(
        f"K4 3D bulk <- outliers [{n3} x {opos3.shape[0]}]",
        lambda t, sp, sm: allpairs_accelerations_wide(
            t, sp, sm, eps_sq=eps, g_const=gc), pos3, opos3, k4_src3)
    k1_err3 = rect_case(
        f"K1 3D outliers <- all [{opos3.shape[0]} x {n3}]",
        lambda t, sp, sm: allpairs_accelerations(
            t, None, eps_sq=eps, g_const=gc, src_pos=sp, src_mass=sm),
        opos3, pos3, k1_src3)

    grids3, corner3, size3, ci3, flat3 = bh3._build_pyramid3(
        ext3["bulk_pos"], ext3["tree_mass"], levels3)
    flat_nf3 = bh._outlier_flat_ids(flat3, ext3["is_out"], res3 ** 3)
    b3 = bh._bucket_grid(pos3, ext3["tree_mass"], ci3, flat_nf3, res3, cap,
                         rr3)
    k7_errs.append(k7_case(
        f"the N=1M cube's grid {res3}^3 x {cap}, rr={rr3}", b3.grid, eps,
        res3, rr3))

    a3_kern = bh3.bh3_accelerations(pos3, mass3, cfg3)
    a3_plain, tree3_plain_ms = timed(lambda: bh3.bh3_accelerations(
        pos3, mass3, cfg3, use_kernels=False))
    torch.cuda.synchronize()
    require(bool(torch.isfinite(a3_kern).all()), "3D tree eval: non-finite")
    err3 = float((a3_kern - a3_plain).abs().max())
    scale3 = float(a3_plain.abs().max())
    say("tree3d", f"octree eval N={n3} kernels vs plain route: max_abs_err="
        f"{err3:.3e} max|a|={scale3:.3e} tol={1e-5 * scale3:.3e} (index_add_ "
        f"atomics vary the pyramid's last bits) "
        f"{'ok' if err3 <= 1e-5 * scale3 else 'FAIL'}")
    require(err3 <= 1e-5 * scale3, "3D tree eval through the kernels "
            "disagrees with the plain route")
    rows3 = torch.randperm(n3, generator=gen, device=dev)[:4096]
    exact3 = allpairs_accelerations(pos3[rows3], None, eps_sq=eps,
                                    g_const=gc, src_pos=pos3,
                                    src_mass=mass3)
    rel3 = ((a3_kern[rows3] - exact3).norm(dim=1)
            / (exact3.norm(dim=1) + 1e-12))
    med3 = float(rel3.median())
    say("tree3d", f"octree vs exact K1 on 4096 rows: median relative error "
        f"{med3:.4e}, 99th percentile "
        f"{float(rel3.kthvalue(int(0.99 * 4096)).values):.4e} (bound: "
        f"median < 1.5e-2) {'ok' if med3 < 1.5e-2 else 'FAIL'}")
    require(med3 < 1.5e-2, "3D tree forces too far from the exact ones")
    del a3_kern, a3_plain

    # One eval timed whole, and each stage alone on its own intermediates.
    tree3_ms = time_ms(lambda: bh3.bh3_accelerations(pos3, mass3, cfg3), 10,
                       warmup=2)
    stages3 = {
        "extraction": time_ms(
            lambda: bh._extract_heavy_outliers(pos3, mass3), 10),
        "heavy coupling": time_ms(lambda: bh.heavy_coupling(
            pos3, ext3["h_pos"], ext3["h_mass"], eps, gc), 10),
        "K1 outliers <- all": time_ms(lambda: allpairs_accelerations(
            opos3, None, eps_sq=eps, g_const=gc, src_pos=pos3,
            src_mass=k1_src3), 10),
        "K4 bulk <- outliers": time_ms(lambda: allpairs_accelerations_wide(
            pos3, opos3, k4_src3, eps_sq=eps, g_const=gc), 10),
        "pyramid": time_ms(lambda: bh3._build_pyramid3(
            ext3["bulk_pos"], ext3["tree_mass"], levels3), 10),
    }
    terms3 = {}
    for lv in range(2, levels3 + 1):
        stages3[f"M2L level {lv}"] = time_ms(lambda: bh3._m2l_level3(
            grids3[lv], corner3, size3, eps, radius3), 10)
        terms3[lv] = bh3._m2l_level3(grids3[lv], corner3, size3, eps,
                                     radius3)

    def l2l3():
        local = terms3[2]
        for lv in range(3, levels3 + 1):
            up = bh3._l2l_upsample3(local, size3 / (1 << lv))
            local = tuple(u + t for u, t in zip(up, terms3[lv]))
        return local

    local3 = l2l3()
    stages3["L2L"] = time_ms(l2l3, 10)
    stages3["L2P"] = time_ms(lambda: bh3._l2p_eval3(
        local3, ci3, pos3, corner3, size3, levels3), 10)
    stages3["sort and bucket scatter"] = time_ms(lambda: bh._bucket_grid(
        pos3, ext3["tree_mass"], ci3, flat_nf3, res3, cap, rr3), 10)
    stages3["K7 near field"] = time_ms(lambda: bucket_stencil3(
        *b3.grid, rr=rr3, eps_sq=eps, center_rows=res3), 20)
    nacc3 = bucket_stencil3(*b3.grid, rr=rr3, eps_sq=eps, center_rows=res3)
    stages3["bucket gather"] = time_ms(
        lambda: bh._bucket_gather(b3, nacc3, res3, cap), 10)
    acc_s3 = bh._bucket_gather(b3, nacc3, res3, cap)
    stages3[f"residual (overflow {int(b3.overflow)})"] = time_ms(
        lambda: bh._overflow_residual(b3, acc_s3, eps, rr3), 3)
    residual3_small_ms = time_ms(
        lambda: bh._overflow_residual(
            b3._replace(overflow=torch.ones((), device=dev)), acc_s3, eps,
            rr3), 3)
    say("timings", f"octree eval N={n3} uniform (L={levels3}, R={radius3}): "
        f"{tree3_ms:.4f} ms through the kernels "
        f"({n3 * n3 / tree3_ms * 1e3:.4e} pairs-equivalent/s, N^2/t), "
        f"{tree3_plain_ms:.4f} ms through the plain versions (one eval)")
    for name, ms in stages3.items():
        say("timings", f"  octree stage {name}: {ms:.4f} ms "
            f"({100 * ms / tree3_ms:.1f}% of the eval)")
    say("timings", f"  stages sum to {sum(stages3.values()):.4f} ms against "
        f"the eval's {tree3_ms:.4f}; the residual's small tier (for an "
        f"overflow of 1-1024) takes {residual3_small_ms:.4f} ms")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof3:
        for _ in range(3):
            bh3.bh3_accelerations(pos3, mass3, cfg3)
        torch.cuda.synchronize()
    spans3 = sorted((e.time_range.start, e.time_range.end)
                    for e in prof3.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    busy3_us, last_end = 0.0, -math.inf
    for a, b in spans3:
        if b > last_end:
            busy3_us += b - max(a, last_end)
            last_end = b
    if spans3:
        busy3_ms = busy3_us / 3e3
        say("timings", f"octree eval device busy {busy3_ms:.4f} ms per eval "
            f"(torch.profiler, {len(spans3)} device rows over 3 evals): "
            f"{100 * busy3_ms / tree3_ms:.1f}% of the unprofiled "
            f"{tree3_ms:.4f} ms, so the device idles "
            f"{100 * (1 - busy3_ms / tree3_ms):.1f}%")
    else:
        say("timings", "octree eval device busy: not measured (the profiler "
            "recorded no device rows)")

    # K7 at the eval's shape: kernel, plain, bound. A 3D softened pair: 3
    # sub, d^2 + eps (1 mul, 3 FMA), 3 mul, 3 FMA = 19 flops, one rsqrt.
    def pair_bound3(pairs, nbytes):
        return bound(nbytes, 19.0 * pairs, pairs)

    occ3 = F.pad((b3.grid[3] != 0).sum(-1).to(torch.float64),
                 (rr3, rr3, rr3, rr3))
    box3 = sum(occ3[ox:ox + res3, oy:oy + res3, oz:oz + res3]
               for ox in range(2 * rr3 + 1) for oy in range(2 * rr3 + 1)
               for oz in range(2 * rr3 + 1))
    k7_pairs = float((occ3[rr3:rr3 + res3, rr3:rr3 + res3, rr3:rr3 + res3]
                      * box3).sum())
    k7_evaluated = float(cap * box3.sum())
    k7_bytes = 4.0 * (4 * b3.grid[0].numel() + 3 * res3 ** 3 * cap)
    k7_plain_ms = time_ms(lambda: bucket_stencil3_plain(
        *b3.grid, rr3, eps, res3), 2)
    tree3_k = {
        "K7": (stages3["K7 near field"], k7_plain_ms,
               *pair_bound3(k7_pairs, k7_bytes)),
        "K4": (stages3["K4 bulk <- outliers"], time_ms(
            lambda: allpairs_accelerations_plain(
                pos3, None, eps_sq=eps, g_const=gc, src_pos=opos3,
                src_mass=k4_src3), 2),
               *pair_bound3(float(n3) * opos3.shape[0],
                            4.0 * (6 * n3 + 4 * opos3.shape[0]))),
        "K1 outliers": (stages3["K1 outliers <- all"], time_ms(
            lambda: allpairs_accelerations_plain(
                opos3, None, eps_sq=eps, g_const=gc, src_pos=pos3,
                src_mass=k1_src3), 2),
            *pair_bound3(float(n3) * opos3.shape[0],
                         4.0 * (4 * n3 + 6 * opos3.shape[0]))),
    }
    say("timings", f"K7 N=1M grid: {k7_pairs:.4e} occupied pairs (the "
        f"bound's work), {k7_evaluated:.4e} evaluated (every target slot x "
        f"occupied sources), "
        f"{float(res3 ** 3 * cap * cap * (2 * rr3 + 1) ** 3):.4e} in the "
        f"full K x K stencil")
    for name, (ms, plain_ms_, bnd, by) in tree3_k.items():
        say("timings", f"{name} at the octree's shape: kernel {ms:.4f} ms, "
            f"plain {plain_ms_:.4f} ms, bound {bnd:.4f} ms ({by})")
    del b3, nacc3, acc_s3, local3, terms3, grids3

    # The octree's main path: Simulation under 'auto' at N = 1M in 3D.
    sim3 = Simulation(cfg3, state=ParticleState.create(
        pos3, torch.zeros_like(pos3), mass3), device="cuda")
    resolved3 = (sim3.config.force_backend, sim3.config.bh_deep_levels,
                 sim3.config.bh_nf_sparse)
    say("tree3d", f"Simulation N={n3} dim=3 under auto resolved to "
        f"(force_backend, bh_deep_levels, bh_nf_sparse) = {resolved3}")
    require(resolved3 == ("bh", 0, 0), f"3D N=1M resolved to {resolved3}")
    sim3.run(2)  # warm-up
    torch.cuda.synchronize()
    for c in counted + (bucket_stencil3,):
        c.launches = 0
    start.record()
    sim3.run(20)
    end.record()
    torch.cuda.synchronize()
    launches3 = {"K1": allpairs_accelerations.launches,
                 "K4": allpairs_accelerations_wide.launches,
                 "K7": bucket_stencil3.launches,
                 "other": sum(c.launches for c in counted
                              if c not in (allpairs_accelerations,
                                           allpairs_accelerations_wide))}
    tree3_steps_per_s = 20 / (start.elapsed_time(end) / 1e3)
    st3 = sim3.state
    over3_after = bh3.bh3_near_overflow(st3.pos, st3.mass, sim3.config)
    say("tree3d", f"launches during run(20) at N={n3}: {launches3}; "
        f"{tree3_steps_per_s:.4f} steps/s (CUDA events, after 2 warm-up "
        f"steps); bucket overflow after the run {over3_after}, residual "
        f"tier {tier(over3_after)}")
    require(launches3 == {"K1": 20, "K4": 20, "K7": 20, "other": 0},
            f"octree kernel launches {launches3}, expected K1, K4 and K7 "
            f"20 each")
    require(sim3.frame == 22, f"frame {sim3.frame}, expected 22")
    for name in ("pos", "vel", "acc"):
        require(bool(torch.isfinite(getattr(st3, name)).all()),
                f"3D tree path: non-finite {name}")
    ke3 = float(kinetic_energy(st3))
    say("tree3d", f"frame {sim3.frame}: KE={ke3:.6e}")
    require(math.isfinite(ke3) and ke3 > 0, "3D tree path: bad kinetic energy")
    del sim3, st3, pos3, mass3

    # What still raises: a Plummer sphere too clustered for the buckets.
    pcfg = SimConfig(n=131_072, dim=3)
    plum = init_scene("plummer", pcfg, device=dev, virialize=False)
    over_pl = bh3.bh3_near_overflow(plum.pos, plum.mass, pcfg)
    try:
        resolve_config_for_state(plum.pos, plum.mass, pcfg)
    except NotImplementedError as exc:
        require("item 10" in str(exc), f"unexpected message: {exc}")
        say("tree3d", f"plummer N=131072 dim=3 (overflow {over_pl}) under "
            f"auto raises NotImplementedError: {exc}")
    else:
        fail("3D plummer N=131072 under auto did not raise; it needs the "
             "deep-overflow chain")
    say("tree3d", f"phase 9 took {time.perf_counter() - t_phase9:.1f} s")

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
        entry("K5 rect_pair_deltas (N=1M merger's big-body passes; timed at "
              "bigs <- all, 64 x 1M)",
              "nbodysim_tpu_torch/csrc/collide.cu",
              "nbodysim_tpu/kernels/collide.py:250", merger_launches["K5"],
              max(k5_big_errs), *k5_big[:3]),
        entry("K5 rect_pair_deltas (residual; launches: the N=4M pass's "
              "residual, timed at 1M x 16384)",
              "nbodysim_tpu_torch/csrc/collide.cu",
              "nbodysim_tpu/kernels/collide.py:250", residual_launches,
              k5_res_err, *k5_res[:3]),
        entry("K6 block_collision_deltas (merger N=1M)",
              "nbodysim_tpu_torch/csrc/collide_block.cu",
              "nbodysim_tpu/kernels/collide_block.py:47",
              merger_launches["K6"], max(k6_errs), k6_ms, k6_plain_ms,
              k6_bnd),
        entry(f"K7 bucket_stencil3 (octree N=1M, {res3}^3 x {cap}, rr={rr3})",
              "nbodysim_tpu_torch/csrc/nearfield3.cu",
              "nbodysim_tpu/kernels/nearfield.py:262", launches3["K7"],
              max(k7_errs), *tree3_k["K7"][:2], tree3_k["K7"][2:]),
        entry("K1 allpairs_accelerations (octree: 4096 outliers <- 1M, D=3)",
              allpairs_cu, "nbodysim_tpu/kernels/allpairs.py:56",
              launches3["K1"], k1_err3, *tree3_k["K1 outliers"][:2],
              tree3_k["K1 outliers"][2:]),
        entry("K4 allpairs_accelerations_wide (octree: 1M x 4096, D=3)",
              allpairs_cu, "nbodysim_tpu/kernels/allpairs.py:105",
              launches3["K4"], k4_err3, *tree3_k["K4"][:2],
              tree3_k["K4"][2:]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
