#!/usr/bin/env python3
"""Time the port's K1/K4 (all-pairs gravity), K2/K5 (collision test) and
K3/K7 (the trees' near field) kernels, and the paths they carry, for one or
more checkouts of the repository on one GPU, in the order given.

    python scripts/torch_kernel_ab.py PARENT CHANGE CHANGE PARENT

Each ROOT is a directory holding `nbodysim_tpu_torch/`; each is timed in a
process of its own (the package builds its kernels into ROOT/build), on the
same inputs made on the card (seed 0; the trees' N=1M square and cube from
seeds 6 and 9, as chip_smoke.py makes them). Interleave the roots (A B B A) to
see the spread between runs of one version. Per root it prints one JSON
line of times in ms (CUDA events, after warm-up): K1 at N=25k and 65,536 on
the disc and uniform input, on the N=1M galaxy merger (1M x 1M), the 2D and
3D tree couplings at N=1M (K1 outliers <- all, K4 bulk <- outliers), K3
and K7 on the N=1M trees' bucket grids (512^2 x 16, rr=2 and 64^3 x 16,
rr=1) with the grid's bucket overflow, one 2D and one 3D tree eval at
N=1M with its device busy time
(torch.profiler over 3 evals, device rows merged), K2 on
the N=25k and N=65,536 discs, K5 at the merger's big-body shape [64 x 1M]
and its full-cap residual shape [1M x 16384], and steps/s of the N=25k disc
(run(200)) and of the N=1M merger (run(2)), with the N=25k step's device
operations and busy time (torch.profiler over 20 steps) and its idle share
against the unprofiled step time, and the SM clock
and power draw during the 1M x 1M launches (nvidia-smi every 100 ms). Where
a checkout's K1 launcher takes a targets-per-thread count, k = 2 and 4 are
timed beside the default. K6 (the block pass's dense stage) is timed on
three shapes: the N=1M galaxy merger in 2D (cell floor 0, as the smoke's
main path), the N=4,194,304 merger's pass under 'auto' and the 3D N=1M
merger under 'auto'; its largest difference from its plain version
(`block_collision_deltas_plain`, the checkout's own) is read on four
colliding blobs with one crowded cell (8192 bodies with 400 in the cell, as
the GPU tests' crowded case, and 32,768 with 3000, as the smoke's blobs; 2D
and 3D), beside the 1e-5 * max(max|v|, 10) tolerance of the velocities
before the pass. `--only k6` times K6 alone. Then a table, and with --out,
the JSON of all runs in that file.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def _worker(root: str, only: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import nbodysim_tpu_torch as nt
    from nbodysim_tpu_torch.kernels import _build
    from nbodysim_tpu_torch.kernels import allpairs as kap
    from nbodysim_tpu_torch.kernels import collide as kco
    from nbodysim_tpu_torch.kernels import nearfield as knf
    from nbodysim_tpu_torch.physics import barneshut as bh
    from nbodysim_tpu_torch.physics import barneshut3d as bh3
    from nbodysim_tpu_torch.physics import collisions as coll
    from nbodysim_tpu_torch.scenes import init_scene, uniform_disc

    assert Path(nt.__file__).resolve().is_relative_to(Path(root).resolve())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def uniform(shape, lo, hi, g=gen):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def time_ms(fn, iters, warmup=2):
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

    has_k = "k" in inspect.signature(kap._launch).parameters
    # Older near-field wrappers take no occupancy (`counts`).
    has_counts = "counts" in inspect.signature(
        knf.bucket_stencil).parameters
    out = {"root": root, "build_s": build_s}

    def k1(name, tgt, mass, iters, **kw):
        out[name] = time_ms(lambda: kap.allpairs_accelerations(
            tgt, mass, **kw), iters)
        src, src_m = kw.get("src_pos", tgt), kw.get("src_mass", mass)
        for k in (2, 4) if has_k else ():
            out[f"{name} k={k}"] = time_ms(lambda: kap._launch(
                tgt, src, src_m, kw["eps_sq"], kw.get("g_const", 1.0), "K1",
                k=k), iters)

    def k4(name, tgt, src, src_m, iters, eps):
        out[name] = time_ms(lambda: kap.allpairs_accelerations_wide(
            tgt, src, src_m, eps_sq=eps), iters)
        for k in (2, 4) if has_k else ():
            out[f"{name} k={k}"] = time_ms(lambda: kap._launch(
                tgt, src, src_m, eps, 1.0, "K4", k=k), iters)

    _k6_times(out, nt, coll, init_scene, time_ms, dev)
    if only == "k6":
        return out

    disc = uniform_disc(nt.SimConfig(n=25_000), device=dev)
    disc65 = uniform_disc(nt.SimConfig(n=65_536), device=dev)
    k1("K1 disc N=25000", disc.pos, disc.mass, 50, eps_sq=1.0)
    k1("K1 disc N=65536", disc65.pos, disc65.mass, 20, eps_sq=1.0)
    for name, s in (("K2 disc N=25000", disc), ("K2 disc N=65536", disc65)):
        out[name] = time_ms(lambda s=s: kco.allpairs_collision_deltas(
            s.pos, s.vel, s.mass, s.radius, impulse=1.5), 50)

    eps = nt.SimConfig().eps_sq
    for dim in (2, 3):
        # chip_smoke.py's N=1M square and cube: each from a generator of its
        # own, seeded as there.
        g = torch.Generator(device=dev)
        g.manual_seed(6 if dim == 2 else 9)
        upos = uniform((1 << 20, dim), -30000.0, 30000.0, g)
        umass = uniform((1 << 20,), 0.1, 10.0, g)
        ext = bh._extract_heavy_outliers(upos, umass)
        opos = upos[ext["out_i"]]
        k1_src_m = torch.where(ext["is_heavy"], 0.0, umass)
        k4_src_m = torch.where(ext["out_sel"] & ~ext["is_heavy"][ext["out_i"]],
                               umass[ext["out_i"]], 0.0)
        k1(f"K1 {dim}D outliers <- all [4096 x 1M]", opos, None, 20,
           eps_sq=eps, src_pos=upos, src_mass=k1_src_m)
        k4(f"K4 {dim}D bulk <- outliers [1M x 4096]", upos, opos, k4_src_m,
           20, eps)
        # The tree's bucket grid, as its eval builds it, and the eval.
        tcfg = nt.SimConfig(n=1 << 20, dim=dim, enable_collisions=False)
        if dim == 2:
            levels, radius = (bh._resolve_levels(tcfg, 1 << 20),
                              bh._resolve_radius(tcfg))
            build, kernel, name = bh._build_pyramid, knf.bucket_stencil, "K3"
        else:
            levels, radius = (bh3._resolve_levels3(tcfg, 1 << 20),
                              bh3._resolve_radius3(tcfg))
            build, kernel, name = (bh3._build_pyramid3, knf.bucket_stencil3,
                                   "K7")
        rr, res = radius - 1, 1 << levels
        _, _, _, ci, flat = build(ext["bulk_pos"], ext["tree_mass"], levels)
        b = bh._bucket_grid(upos, ext["tree_mass"], ci, bh._outlier_flat_ids(
            flat, ext["is_out"], res ** dim), res, bh.NEAR_CAP, rr)
        kw = dict(rr=rr, eps_sq=eps, center_rows=res)
        if has_counts:
            kw["counts"] = b.counts
        out[f"{name} N=1M tree grid {res}^{dim} x 16, rr={rr}"] = time_ms(
            lambda: kernel(*b.grid, **kw), 50)
        out[f"{dim}D bucket overflow"] = int(b.overflow)
        del b, ci, flat

        def tree_eval():
            return bh.bh_accelerations(upos, umass, tcfg)

        out[f"{dim}D tree eval N=1M"] = time_ms(tree_eval, 5)
        out[f"{dim}D tree eval device busy"] = _device_busy(
            lambda: [tree_eval() for _ in range(3)], 3, torch)[1]
        del upos, umass, ext

    mcfg = nt.SimConfig(n=1 << 20, dt=0.05, integrator="leapfrog_kdk",
                        force_backend="cuda")
    merger = init_scene("galaxy_merger", mcfg, device=dev)
    clocks = subprocess.Popen(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    k1("K1 merger [1M x 1M]", merger.pos, merger.mass, 2, eps_sq=mcfg.eps_sq,
       g_const=mcfg.g_const)
    clocks.terminate()
    samples = [tuple(map(float, ln.split(","))) for ln in
               clocks.communicate()[0].splitlines() if ln.count(",") == 1]
    if samples:
        busy = sorted(samples)[len(samples) // 4:]   # drop idle samples
        out["SM MHz during K1 merger (median, upper 3/4)"] = \
            busy[len(busy) // 2][0]
        out["W during K1 merger (max)"] = max(w for _, w in samples)
    bcfg = mcfg.replace(collision_broad_phase="block",
                        collision_cell_size=0.0)
    ms_ = coll._block_structure(merger.pos, merger.radius, bcfg)
    mbp = coll._block_planes(merger, ms_)
    fs, bigs = mbp.fields_s, ms_.bigs
    big_src = (merger.pos[bigs.top_i], merger.vel[bigs.top_i],
               torch.where(bigs.big_sel, merger.mass[bigs.top_i], 0.0),
               merger.radius[bigs.top_i], ms_.cell[bigs.top_i])
    small_src = (fs[0], fs[1], torch.where(mbp.big_s, 0.0, fs[2]), fs[3],
                 fs[4])
    sel = torch.randperm(1 << 20, generator=gen, device=dev)[
        :coll._OVERFLOW_CAP]
    o_src = tuple(f[sel] for f in fs)
    out["K5 bigs <- all [64 x 1M]"] = time_ms(lambda: kco.rect_pair_deltas(
        big_src, small_src, dim=2, impulse=1.5, max_cheb=None), 20)
    out["K5 residual [1M x 16384]"] = time_ms(lambda: kco.rect_pair_deltas(
        fs, o_src, dim=2, impulse=1.5, max_cheb=1), 5)
    del ms_, mbp, fs, small_src, o_src, merger

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, cfg, scene, warm, steps in (
            ("N=25k disc steps/s", nt.SimConfig(n=25_000), "uniform_disc",
             5, 200),
            ("N=1M merger steps/s", mcfg, "galaxy_merger", 1, 2)):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sim = nt.Simulation(cfg, scene=scene, device="cuda")
        sim.run(warm)
        torch.cuda.synchronize()
        start.record()
        sim.run(steps)
        end.record()
        torch.cuda.synchronize()
        out[name] = steps / (start.elapsed_time(end) / 1e3)
        if scene == "uniform_disc":
            # Over 20 steps; the idle share holds the busy time against the
            # unprofiled step time, since the profiler slows the host.
            ops, busy_ms = _device_busy(lambda: sim.run(20), 20, torch)
            out["N=25k device ops per step"] = ops
            out["N=25k device busy ms per step"] = busy_ms
            out["N=25k device idle share"] = 1.0 - busy_ms * out[name] / 1e3
        del sim
    return out


def _k6_times(out, nt, coll, init_scene, time_ms, dev):
    """K6 on its three shapes, each through the checkout's own block
    structure and wrapper."""
    import warnings

    import torch

    from nbodysim_tpu_torch.kernels.collide_block import (
        block_collision_deltas, block_collision_deltas_plain)
    for dim, n, crowd in ((2, 8192, 400), (3, 8192, 400), (2, 32_768, 3000),
                          (3, 32_768, 3000)):
        g = torch.Generator(device=dev)
        g.manual_seed(40 + dim)

        def uni(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

        half = (60.0 if dim == 2 else 20.0) * (n / 8192) ** (1 / dim)
        pos = uni((n, dim), -half, half)
        pos[1:1 + crowd] = uni((crowd, dim), 0.05, 0.95)
        mass, radius = uni((n,), 0.5, 2.0), uni((n,), 0.5, 1.0)
        radius[0], mass[0] = 15.0, 100.0
        state = nt.ParticleState.create(pos, uni((n, dim), -5.0, 5.0), mass,
                                        radius)
        cfg = nt.SimConfig(n=n, dim=dim, collision_broad_phase="block",
                           collision_cell_size=0.0)
        s = coll._block_structure(state.pos, state.radius, cfg)
        args = (coll._block_planes(state, s).planes, s.keys, s.w_lo, s.w_hi)
        got = block_collision_deltas(*args, t_blk=s.t_blk, impulse=1.5)
        ref = block_collision_deltas_plain(*args, t_blk=s.t_blk, impulse=1.5)
        name = f"K6 err vs plain, {dim}D blob N={n}, {crowd} in a cell"
        out[name] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        out[name + ", / tol"] = out[name] / (
            1e-5 * max(float(state.vel.abs().max()), 10.0))
        del state, s, args, got, ref
    for name, n, dim in (("K6 2D merger N=1M", 1 << 20, 2),
                         ("K6 N=4M merger pass", 1 << 22, 2),
                         ("K6 3D merger N=1M", 1 << 20, 3)):
        cfg = nt.SimConfig(n=n, dim=dim, dt=0.05, integrator="leapfrog_kdk",
                           force_backend="cuda")
        state = init_scene("galaxy_merger", cfg, device=dev)
        if n == 1 << 20 and dim == 2:
            cfg = cfg.replace(collision_broad_phase="block",
                              collision_cell_size=0.0)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                cfg = coll.resolve_collision_phase_for_state(state, cfg)
        s = coll._block_structure(state.pos, state.radius, cfg)
        planes = coll._block_planes(state, s).planes
        out[name] = time_ms(lambda: block_collision_deltas(
            planes, s.keys, s.w_lo, s.w_hi, t_blk=s.t_blk, impulse=1.5), 20)
        del state, s, planes


def _device_busy(fn, count: int, torch):
    """(device rows, device busy ms) per unit over one torch.profiler window
    that runs `fn` once, `count` units' worth: the device rows' intervals
    merged, so overlapping rows count once."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, last = 0.0, float("-inf")
    for a, b in spans:
        if b > last:
            busy += b - max(a, last)
            last = b
    return len(spans) / count, busy / count / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--out", help="write every run's JSON to this file")
    ap.add_argument("--only", choices=("all", "k6"), default="all",
                    help="time everything (default) or K6 alone")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(_worker(args.worker, args.only)),
              flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    runs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", root,
                               "--only", args.only],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            sys.exit(f"worker for {root} failed ({proc.returncode})")
        runs.append(json.loads(lines[-1][len("RESULT "):]))
        print(json.dumps(runs[-1]), flush=True)
    keys = [k for k in dict.fromkeys(k for r in runs for k in r)
            if k not in ("root", "build_s")]
    print(f"{'':44s}" + "".join(f"{r['root'][-14:]:>16s}" for r in runs))
    for k in keys:
        print(f"{k:44s}" + "".join(
            f"{r[k]:16.6g}" if k in r else f"{'-':>16s}" for r in runs))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": smi.strip(), "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
