#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`nbodysim_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device   — the card's name and power limit (nvidia-smi), torch, CUDA
                and nvcc versions; exits non-zero without a CUDA device;
  2. build    — compiles the CUDA kernels from nbodysim_tpu_torch/csrc/,
                and reads K1's and the potential kernel's inner loops and
                K2's batch test from the library's SASS (cuobjdump):
                instructions per pair;
  3. K1       — the all-pairs gravity kernel against its plain torch
                version on the card, on seven cases (both targets-per-thread
                variants, the source split, one target and one source),
                each within 1e-5 * max|a|;
  4. K2       — the collision kernel against its plain version on dense
                colliding clouds (2D, 3D, a ragged 3D one) and the N=25k
                disc, within 1e-5 * max(max|v|, 10), with momentum
                conservation and the same particles hit;
  5. main     — Simulation(SimConfig(n=25_000), scene="uniform_disc")
                (no device: the card is the default).run(200): finite state
                and energies, both kernels launched exactly 200 times, the
                step's device operations and idle share (torch.profiler), K1
                and K2 again on the evolved state, one step through the
                kernels against one step through the plain versions
                (1e-5 * max|x|, max|v|); diagnostics() launching the
                potential kernel once, the kernel on the evolved state
                against the plain version in float64 (4e-6 relative);
  6. timings  — kernel and plain times at the main path's shapes (K2 on the
                initial and the evolved disc; the potential kernel on the
                disc, with its bound), K1
                pairs/s at N=65,536 and N=1,048,576, and the tree code at
                N=1,048,576 uniform +-3e4 (bench.py:232's input, from a
                generator of its own): one eval
                through the kernels and through the plain versions, its
                stage split, and K3, K4 and K1 (outliers <- all) at the
                eval's shapes beside their plain versions and bounds, with
                K3's pairs needed against the lane-pairs its warps issue
                (a model estimate);
  7. tree     — K3 against its plain version (1e-5 * max|a| below each
                cell's count, exactly 0 above it) on random partially
                filled bucket grids, on grids filled the force path's way
                (rr 0-4, K < 16 and = 16, every cell full, massless
                particles in a cell's last occupied slot, eps = 0 with
                coincident pairs) and on the N=1M grid, K4 at [1M x 4096],
                K1 at [4096 x 1M], the whole tree eval through the kernels
                against the plain route (1e-5 * max|a|) and against exact K1
                forces (median relative error < 1e-2),
                Simulation(SimConfig(n=1M, enable_collisions=False)) under
                'auto' running 20 steps with K1, K3 and K4 launched exactly
                once per step, the M2L kernel once a level and no other
                kernel, and the N=131,072 disc
                under 'auto' resolving to the deep-overflow chain with tiles
                (with its warning) and running 2 steps;
  8. collide  — K5 against its plain version on 2D and 3D colliding clouds
                (max_cheb 1 and None), at both big-body shapes [64 x 1M] and
                [1M x 64] (with smalls moved inside the nuclei, so pairs
                fire) and at the full-cap residual shape [1M x 16384]; K6
                and the whole block pass through the kernels against the
                plain route on 2D and 3D blobs with uncovered blocks, on
                the N=1M galaxy merger and on the 3D N=1M galaxy merger under
                'auto' (1e-5 * max(max|v|, 10), momentum), with K6's time,
                bound, needed pairs against the rows its counting launch
                measures walked, and the 3D pass's launches;
                K1 on the merger's N=1M state against its plain version on
                4096 rows (1e-5 * max|a|), with the SM clock and power draw
                during the launch; the N=4M merger under 'auto'
                (block pass, its overflow, launches of one pass, one pass
                timed by stage), and one force eval of its state under
                config 5's forces (the deep chain), timed, with the 2D M2L
                kernel launched 14 times (levels 2-10, deep 11-12, 3 tile
                sub-levels), and the kernel at its 4096^2 and 2048^2 levels
                against its plain version (F and J within 1e-5, H within
                2e-5 of the class's max |value|), timed beside its bound
                (useful multiply-adds at 67 TFLOP/s) and the plain route
                (cuDNN, library_ms); Simulation of the
                N=1M merger (force_backend "cuda", collisions resolved to the
                block pass): 1 warm-up step, then run(3) with K1 and K6
                launched once per step, K5 at least twice and no M2L, then
                the same under config 5's forces ("bh", bh_deep_levels=-1)
                with K1, K3, K4 and K6 once per step and the M2L kernel
                once a level; one bucket pass on phase 6's
                N=1M uniform input with random velocities under 'auto';
  9. tree3d   — K7 against its plain version, as K3 in phase 7, on random
                partially filled 3D bucket grids (rr = 1..4, eps = 0), on
                grids filled the force path's way (rr 1-4, full cells,
                massless last slots, coincident pairs) and on the N=1M
                cube's grid, with its pairs needed against the lane-pairs
                issued (a model estimate), K1 at [4096 x 1M] and K4 at [1M x 4096] in 3D, the
                octree eval at N=1,048,576 uniform +-3e4 (profiling.py:99's
                input, from a generator of its own; its bucket overflow
                and residual tier printed) through
                the kernels against the plain route (1e-5 * max|a|) and
                against exact K1 forces on 4096 rows (median relative error
                < 1.5e-2), one eval timed whole and by stage with its device
                idle share, Simulation(SimConfig(n=1M, dim=3,
                enable_collisions=False)) under 'auto' running 20 steps with
                K1, K4 and K7 launched exactly once per step, and a 3D
                Plummer sphere at N=131,072 under 'auto' resolving to the 3D
                deep-overflow chain with tiles (with its warning) and
                running 2 steps;
 10. deep     — Simulation(SimConfig(n=1,048,576), scene="uniform_disc")
                under 'auto': the deep-overflow chain with its tiles (and
                the warning that says so); the overflow, deep-path, refined
                and halo shares; one eval timed whole and by stage with its
                device idle share; the eval through the kernels against the
                plain route (1e-5 * max|a|, index_add_ deterministic for
                the comparison) and against exact K1 forces on 4096 rows
                (median relative error < 2e-2 off the deep path, max|a| <
                10x the exact one on it); the 2D M2L kernel at the deep
                chain's 2048^2 and 1024^2 levels as in phase 8; 1 warm-up
                step, then run(5) with K1, K3 and K4 launched exactly once
                per step and the M2L kernel 13 times a step; K1, K3 and K4
                at the deep path's shapes against their plain versions,
                timed and bounded;
 11. deep3d   — Simulation(SimConfig(n=1,048,576, dim=3), scene="plummer")
                under 'auto' (collisions on): the 3D deep-overflow chain
                with its tiles and the dense near field; the same report as
                phase 10 (shares, one eval timed whole and by stage with its
                device idle share and peak memory, kernels vs plain route
                with deterministic index_add_, vs exact K1 on 4096 rows with
                the JAX tests' 3D bounds: median < 3e-2 off the deep path,
                max|a| < 10x on it), 1 warm-up step, then run(3) with K1, K4
                and K7 once per step and the M2L kernel once a level; K1, K4
                and K7 at its shapes against their plain versions, timed and
                bounded; the M2L kernel at its 256^3 and 128^3 levels
                against its plain version (each term within 1e-5 of its
                max |value|), timed beside its bound (useful multiply-adds
                at 67 TFLOP/s) and the plain route (cuDNN, library_ms).
                The 3D galaxy merger at N=1M under 'auto' (the sparse near
                field, its valid rows and sources printed): the same report,
                run(3) with K1 and K4 once per step, no K7, the M2L kernel
                once a level. The clustered blob
                (scripts/bench3d_clustered.py's input, `scenes/blob.py`):
                its resolution and one timed eval.
 12. surface  — the product surface through its entry points: `cli info`
                (it names the card); `cli run` of the N=25k disc for 200
                steps (--log-every 50 --checkpoint-every 100; K1 and K2
                launched 200 times each), its HUD steps/s, then the run
                resumed from its ckpt_0000100.npz to step 200, whose
                checkpoint must equal the uninterrupted one bit for bit;
                the sorted-hash pass (collision_broad_phase="hash") on the
                2D and 3D N=1M galaxy mergers: its overflow and big bodies,
                the pass timed (CUDA events, 5 after 2), every K5 launch of
                one pass against the plain route's same call, the pass
                through the kernels against collision_backend="torch"
                (1e-5 * max(max|v|, 10)) and momentum (1e-5 of sum m|v|);
                render_frame at 1200 x 900 on phase 10's N=1M disc in its
                normal, performance and overlay modes, timed, each against
                the CPU's frame of the same state (at most 0.1% of the
                pixels more than 1 apart); render_rollout of 10 frames of
                1 step into an AsyncFrameWriter with a numpy sink (the M2L
                kernel 13 times a tree eval);
                `nbodysim_tpu_torch.bench`'s default run and --config 1, 2
                and 5 (config 5: the N=4M merger, forces only and with
                collisions), their JSON lines printed; the drift gate
                (Plummer N=4096, leapfrog, 10,000 steps: worst |dE/E| <=
                1e-4); `profiling.trace` around 3 steps (a Chrome trace
                with the device's kernels). Scratch files go to the
                gitignored build/smoke12/.
 13. sharded  — the multi-device step (`nbodysim_tpu_torch.parallel`) on
                torch.distributed, neither run a scaling figure. World size
                2 over gloo, both ranks on the one card (spawned, joined,
                kernels built beforehand): the N=25k disc step (the ring: K1
                twice a rank; the gathered dense pass: K2's row range once)
                against the single-device step (pos 1e-6 * max|x|, vel
                1e-3), the banded 2D eval on phase 6's N=1M input (256 rows
                a band; K1, K3 on the band window, K4 once a rank) and the
                banded deep chain on phase 10's N=1M disc against the
                single-device tree (2e-5 * max|a|), each rank's launches and
                band window capacity; the banded block pass on phase 8's
                N=1M merger, the banded bucket grid on phase 6's N=1M
                square (res 512) and the banded hash pass on phase 12's 3D
                N=1M merger against the single-device passes' deltas
                (1e-5 * max(max|v|, 10)), the banded octree on phase 9's
                N=1M cube and the N=1M Plummer sphere's banded deep chain
                and tiles (index_add_ deterministic) against
                bh3_accelerations (2e-5 * max|a|), 2 make_sharded_step
                steps each of the N=1M disc and Plummer sphere under the
                configs Simulation resolves against Simulation.run(2)
                (1e-6 * max|x|, 1e-5 * max|v|), each rank's launches and
                work counts; a checkpoint written at P=2. Then
                world size 1 over NCCL in this process: make_sharded_step
                against Simulation.run(200) on the N=25k disc (bit for bit,
                K1 and K2 200 times each, both steps/s), the sharded
                rollout, the leapfrog prime and 10 steps (bit for bit), the
                N=1M disc under auto for 5 steps (the replicated tree: K1,
                K3, K4 once a step), a sharded checkpoint at step 3 resumed
                to step 6 (bit for bit) and the P=2 checkpoint resumed at
                P=1 (2e-6 * max|x|, 2e-5 * max|v|). K1 at the ring's hop, K2
                in its row range, K3 on the band window, and rank 0's first
                band launch of K5 (the residual's pass (b) on its chunk of
                sorted targets), K6 (its band of blocks) and K7 (its x-slab
                window), K1 on the octree's outlier range and K4 on its
                local rows against their plain versions, timed and
                bounded. Scratch in build/smoke13/.

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
from pathlib import Path
from types import SimpleNamespace


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def sass_report(lib_path, cuobjdump) -> list:
    """Instructions per pair in K1's and the potential kernel's inner loops
    and K2's batch test, read from the built library's SASS: lines to
    print. An inner loop is the kernel's shortest backward branch (16
    sources x k targets); K2's batch
    test is the straight run at the head of its second-longest loop, up to
    the first branch after its first compare (16 sources x 2 targets)."""
    import collections
    import re

    proc = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True)
    funcs, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(3),
                                m.group(4)))
    out = []
    for key, what, pairs in (
            ("allpairs_kernelILi2ELi2ELb0", "K1 2D k=2 inner loop", 32),
            ("allpairs_kernelILi2ELi4ELb0", "K1 2D k=4 inner loop", 64),
            ("allpairs_kernelILi3ELi4ELb0", "K1 3D k=4 inner loop", 64),
            ("potential_kernelILi2ELi2E", "potential 2D k=2 inner loop", 32),
            ("potential_kernelILi2ELi4E", "potential 2D k=4 inner loop", 64),
            ("potential_kernelILi3ELi4E", "potential 3D k=4 inner loop", 64),
            ("collide_kernelILi2ELb0ELb0", "K2 2D batch test", 32),
            ("collide_kernelILi3ELb0ELb0", "K2 3D batch test", 32),
            ("collide_kernelILi2ELb1ELb1", "K5 2D cell test", 32)):
        ins = next((v for k, v in funcs.items() if key in k), None)
        if not ins:
            out.append(f"{what}: not measured (no {key} in the SASS)")
            continue
        loops = sorted(((int(t.group(1), 16), a) for a, op, rest in ins
                        if op.startswith("BRA")
                        and (t := re.search(r"0x([0-9a-f]+)", rest))
                        and int(t.group(1), 16) < a),
                       key=lambda lh: lh[1] - lh[0])
        body = []
        if what.startswith(("K1", "potential")):
            body = [op for a, op, _ in ins if loops[0][0] <= a <= loops[0][1]]
        else:
            lo, hi = loops[-2]
            for a, op, _ in ins:
                if lo <= a <= hi:
                    if (op.startswith(("BRA", "BSSY")) and any(
                            o.startswith(("FSETP", "ISETP")) for o in body)):
                        break
                    body.append(op)
        count = collections.Counter(op.split(".")[0] for op in body)
        out.append(f"{what}: {len(body)} instructions for {pairs} pairs, "
                   f"{len(body) / pairs:.2f} a pair: {dict(count.most_common())}")
    return out


def one_over(b):
    """A tree bucket grid (`barneshut._Buckets`) as if its first sorted body
    were past its cell's cap: an overflow of 1, what the residual's small
    tier takes."""
    import torch

    in_cap = b.in_cap.clone()
    in_cap[0] = False
    return b._replace(in_cap=in_cap, overflow=torch.ones_like(b.overflow))


def device_profile(fn, count: int):
    """(device rows, device busy ms) per unit of work, over one
    torch.profiler window that runs `fn` once, `count` units' worth (a
    step, an eval): the rows' intervals are merged, so overlapping rows
    count once."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, last_end = 0.0, -math.inf
    for a, b in spans:
        if b > last_end:
            busy_us += b - max(a, last_end)
            last_end = b
    return len(spans) / count, busy_us / count / 1e3


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


def near_pairs(counts_w, rows: int, rr: int, cap: int):
    """Pair counts of the near-field kernels (K3 in 2D, K7 in 3D) on a grid
    with occupancy `counts_w` [rows + 2rr, res(, res)] (halo included):
    (needed, issued, every_slot). `needed`: each occupied target slot
    against the occupied slots of its (2rr+1)^D cells, the pairs the
    kernel's active lanes evaluate. `issued`: a model estimate, not a
    measurement, of the lane-pairs the warps issue: each of a warp's
    (2rr+1)^(D-1) runs charged 32 lanes x its longest lane's run, the
    compacted targets of a tile (its shape read from the kernel library)
    mapped onto warps of 32 in cell order, the tile's sources in one chunk.
    `every_slot`: all K slots of every cell against the occupied sources,
    the work of a kernel with a thread for every slot."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from nbodysim_tpu_torch.kernels import _build

    dim = counts_w.dim()
    res = counts_w.shape[-1]
    width = 2 * rr + 1
    tile = (ctypes.c_int * 3)()
    _build.check(_build.library().nb_nearfield_tile(dim, tile),
                 "nb_nearfield_tile")
    tile = tuple(tile)
    tile_cells = tile[0] * tile[1] * tile[2]
    tile_warps = (tile_cells * cap + 31) // 32
    cw = counts_w.to(torch.float64)
    # Runs along the innermost axis, then one per line offset.
    pz = F.pad(cw, (rr, rr) + ((rr, rr) if dim == 3 else ()))
    zsum = sum(pz[..., oc:oc + res] for oc in range(width))
    if dim == 2:
        runs = torch.stack([zsum[oa:oa + rows] for oa in range(width)], -1)
    else:
        runs = torch.stack([zsum[oa:oa + rows, ob:ob + res]
                            for oa in range(width) for ob in range(width)],
                           -1)
    tgt = cw[rr:rr + rows]                      # [rows, res(, res)]
    needed = float((tgt * runs.sum(-1)).sum())
    idx = torch.meshgrid(*(torch.arange(n, device=cw.device)
                           for n in tgt.shape), indexing="ij")
    if dim == 2:
        idx = (idx[0], torch.zeros_like(idx[0]), idx[1])
    n_tiles = [(n + t - 1) // t for n, t in zip(
        (rows, res if dim == 3 else 1, res), tile)]
    block = ((idx[0] // tile[0]) * n_tiles[1] + idx[1] // tile[1]) \
        * n_tiles[2] + idx[2] // tile[2]
    local = ((idx[0] % tile[0]) * tile[1] + idx[1] % tile[1]) * tile[2] \
        + idx[2] % tile[2]
    order = torch.argsort((block * tile_cells + local).reshape(-1))
    blk = block.reshape(-1)[order]
    cnt = tgt.reshape(-1)[order].long()
    run = runs.reshape(-1, runs.shape[-1])[order]
    excl = torch.cumsum(cnt, 0) - cnt
    start = torch.full((int(blk.max()) + 1,), 1 << 62, dtype=torch.long,
                       device=cw.device).scatter_reduce(0, blk, excl, "amin")
    first = excl - start[blk]
    live = cnt > 0
    warps = torch.zeros((start.shape[0] * tile_warps, run.shape[-1]),
                        dtype=torch.float64, device=cw.device)
    for w in (first // 32, (first + cnt - 1).clamp_min(0) // 32):
        key = (blk * tile_warps + w)[live]
        warps.scatter_reduce_(0, key[:, None].expand(-1, run.shape[-1]),
                              run[live], "amax")
    return needed, float(32 * warps.sum()), float(cap * runs.sum(-1).sum())


def _np_state(st) -> dict:
    """A state's fields as numpy arrays (what a spawned rank is given)."""
    return {k: getattr(st, k).detach().cpu().numpy()
            for k in ("pos", "vel", "acc", "mass", "radius", "frame")}


def _sharded_worker(rank: int, jobs: dict) -> dict:
    """One rank of phase 13's world-size-2 run: gloo, both ranks on the one
    card. Runs the N=25k disc step (the ring and K2's row range), the
    banded 2D eval on phase 6's N=1M input (K3 on its band window, whose
    first launch's operands it keeps), the banded deep chain on the N=1M
    disc, and a checkpoint written at P=2; returns what the parent holds
    against the single-device results (rank 0: the whole arrays)."""
    import torch

    from nbodysim_tpu_torch import ParticleState, SimConfig
    from nbodysim_tpu_torch.io import save_checkpoint
    from nbodysim_tpu_torch.kernels.allpairs import (
        allpairs_accelerations, allpairs_accelerations_wide)
    from nbodysim_tpu_torch.kernels.collide import (
        allpairs_collision_deltas, rect_pair_deltas)
    from nbodysim_tpu_torch.kernels.collide_block import (
        block_collision_deltas)
    from nbodysim_tpu_torch.kernels.nearfield import bucket_stencil3
    from nbodysim_tpu_torch.parallel import (
        comm, make_mesh, make_sharded_step, shard_state, tree, tree3d)
    from nbodysim_tpu_torch.parallel import collisions as pcoll
    from nbodysim_tpu_torch.parallel.sharded import gather_state, mesh_device
    from nbodysim_tpu_torch.physics import collisions as coll

    mesh = make_mesh()                 # the card, in the spawned gloo group
    dev = mesh_device(mesh)
    ax = comm.mesh_axis(mesh, "shards")
    real_k3 = tree.bucket_stencil
    counters = {"K1": allpairs_accelerations, "K2": allpairs_collision_deltas,
                "K3": real_k3, "K4": allpairs_accelerations_wide,
                "K5": rect_pair_deltas, "K6": block_collision_deltas,
                "K7": bucket_stencil3}
    out = {"rank": rank}

    def launches():
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}

    def reset():
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0

    def whole(x):
        return comm.all_gather(x, ax).cpu().numpy()

    def local(a):
        n_l = a.shape[0] // ax.size
        return torch.from_numpy(a[rank * n_l:(rank + 1) * n_l]).to(dev)

    def events_ms(fn, iters):
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

    # The N=25k disc: one sharded step (K1 twice a rank, K2 once).
    cfg = SimConfig(**jobs["disc_cfg"])
    ss = shard_state(ParticleState.from_numpy(jobs["disc"], dev), mesh)
    step = make_sharded_step(cfg, mesh)
    step(ss)
    reset()
    s1 = step(ss)
    out["disc_launches"] = launches()
    g = gather_state(s1)
    out["disc"] = {"pos": g.pos.cpu().numpy(), "vel": g.vel.cpu().numpy()}
    out["disc_step_ms"] = events_ms(lambda: step(ss), 20)

    # The banded 2D eval on the N=1M uniform square; K3's first operands.
    ucfg = SimConfig(**jobs["u_cfg"])
    kept = []

    def k3_keep(bx, by, bm, **kw):
        if not kept:
            kept.append(tuple(t.cpu() for t in (bx, by, bm, kw["counts"]))
                        + (kw["rr"], kw["eps_sq"], kw["center_rows"]))
        return real_k3(bx, by, bm, **kw)

    upl, uml = local(jobs["upos"]), local(jobs["umass"])
    tree.bucket_stencil = k3_keep
    try:
        tree.banded_tree_accelerations(upl, uml, ucfg, ax)   # warm-up
        reset()
        acc = tree.banded_tree_accelerations(upl, uml, ucfg, ax)
        out["u_launches"] = launches()
    finally:
        tree.bucket_stencil = real_k3
    out["u_work"] = dict(tree.banded_tree_accelerations.work)
    out["u_acc"] = whole(acc)
    out["u_ms"] = events_ms(
        lambda: tree.banded_tree_accelerations(upl, uml, ucfg, ax), 3)
    if rank == 0:
        out["k3_operands"] = kept[0]

    # The banded deep chain (and tiles) on the N=1M disc, index_add_
    # deterministic as for the single-device eval it is held to.
    dcfg = SimConfig(**jobs["d_cfg"])
    dpl, dml = local(jobs["dpos"]), local(jobs["dmass"])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reset()
        acc = tree.banded_tree_accelerations(dpl, dml, dcfg, ax)
        out["d_launches"] = launches()
    finally:
        torch.use_deterministic_algorithms(False)
    out["d_work"] = dict(tree.banded_tree_accelerations.work)
    out["d_acc"] = whole(acc)
    out["d_ms"] = events_ms(
        lambda: tree.banded_tree_accelerations(dpl, dml, dcfg, ax), 3)

    # ---- the banded broad phases and the banded octree ----------------
    # Each pass once to warm up, once with the launches counted, 3 times
    # timed; rank 0 keeps the operands of the first band launch of K5 (the
    # residual's pass (b) on its chunk of sorted targets where the pass
    # runs one), K6 (its band of blocks) and K7 (its x-slab window).
    kept = {}

    def keeper(name, real, want=lambda *a, **kw: True):
        def call(*a, **kw):
            if rank == 0 and name not in kept and want(*a, **kw):
                kept[name] = (tuple(
                    tuple(t.cpu() for t in x) if isinstance(x, tuple)
                    else x.cpu() for x in a), dict(
                    (k, v.cpu() if torch.is_tensor(v) else v)
                    for k, v in kw.items()))
            return real(*a, **kw)
        return call

    def band_run(key, fn, det=False, iters=3):
        """fn's result with the launches counted (index_add_ deterministic
        with `det`, as for the single-device result it is held to), and
        its time (index_add_ as the step runs it)."""
        fn()                                           # warm-up
        reset()
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            res = fn()
        finally:
            torch.use_deterministic_algorithms(False)
        out[key + "_launches"] = launches()
        out[key + "_ms"] = events_ms(fn, iters)
        return res

    def local_t(t):
        n_l = t.shape[0] // ax.size
        return t[rank * n_l:(rank + 1) * n_l].contiguous()

    n_l = jobs["bucket"]["pos"].shape[0] // ax.size
    k5_band = keeper("K5", rect_pair_deltas, lambda tgt, src, **kw: (
        tgt[0].shape[0] == n_l and kw.get("max_cheb") == 1))
    saved = (coll.rect_pair_deltas, coll.block_collision_deltas,
             tree3d.bucket_stencil3)
    coll.rect_pair_deltas = k5_band
    coll.block_collision_deltas = keeper("K6", block_collision_deltas)
    tree3d.bucket_stencil3 = keeper("K7", bucket_stencil3)
    try:
        for key in ("block", "bucket", "hash"):
            st = ParticleState.from_numpy(jobs[key], dev)
            cfg_c = SimConfig(**jobs[key + "_cfg"])
            args = [local_t(getattr(st, f))
                    for f in ("pos", "vel", "mass", "radius")]
            dp, dv = band_run(key, lambda: pcoll.sharded_collision_deltas(
                *args, cfg_c, ax))
            out[key + "_work"] = dict(pcoll.sharded_collision_deltas.work)
            out[key] = (whole(dp), whole(dv))
            if key == "hash" and "overflow_rows" not in out["hash_work"]:
                # No residual on this input (the same on both ranks): its
                # first K5 band launch.
                coll.rect_pair_deltas = keeper("K5", rect_pair_deltas)
                pcoll.sharded_collision_deltas(*args, cfg_c, ax)
            del st, args, dp, dv

        for key in ("cube", "plummer"):
            cfg_t = SimConfig(**jobs[key + "_cfg"])
            pl, ml = local(jobs[key]["pos"]), local(jobs[key]["mass"])
            acc = band_run(key, lambda: tree3d.banded_tree3_accelerations(
                pl, ml, cfg_t, ax), det=key == "plummer")
            out[key + "_work"] = dict(tree3d.banded_tree3_accelerations.work)
            out[key] = whole(acc)
    finally:
        (coll.rect_pair_deltas, coll.block_collision_deltas,
         tree3d.bucket_stencil3) = saved
    if rank == 0:
        out["band_operands"] = kept

    # The slice's path end to end: 2 sharded steps of the N=1M flagship
    # disc and of the N=1M Plummer sphere under the configs Simulation
    # resolved for them, index_add_ deterministic as in the parent's runs;
    # then 2 more steps timed with index_add_ as the step runs it.
    for key in ("disc_steps", "plummer_steps"):
        cfg_s = SimConfig(**jobs[key + "_cfg"])
        sst = shard_state(ParticleState.from_numpy(jobs[key], dev), mesh)
        sstep = make_sharded_step(cfg_s, mesh)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            reset()
            for _ in range(2):
                sst = sstep(sst)
            out[key + "_launches"] = launches()
        finally:
            torch.use_deterministic_algorithms(False)
        out[key + "_work"] = {
            "tree": dict((tree3d.banded_tree3_accelerations if cfg_s.dim == 3
                          else tree.banded_tree_accelerations).work),
            "collisions": dict(pcoll.sharded_collision_deltas.work)}
        g = gather_state(sst)
        out[key] = {"pos": g.pos.cpu().numpy(), "vel": g.vel.cpu().numpy(),
                    "frame": int(g.frame)}
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(2):
            sst = sstep(sst)
        ev1.record()
        torch.cuda.synchronize()
        out[key + "_ms"] = ev0.elapsed_time(ev1) / 2
        del sst, g

    # A checkpoint written at P=2 after 3 steps, and 3 more steps (the
    # reference the parent's P=1 resume is held to).
    for _ in range(3):
        ss = step(ss)
    save_checkpoint(jobs["ck"], ss, cfg)
    for _ in range(3):
        ss = step(ss)
    g = gather_state(ss)
    out["ck_ref"] = {"pos": g.pos.cpu().numpy(), "vel": g.vel.cpu().numpy(),
                     "frame": int(g.frame)}
    out["host_staged"] = sorted(comm.HOST_STAGED)
    if rank != 0:
        for k in ("disc", "u_acc", "d_acc", "ck_ref", "block", "bucket",
                  "hash", "cube", "plummer", "disc_steps", "plummer_steps"):
            out.pop(k)
    return out


def sharded_phase(ctx) -> list:
    """Phase 13: the multi-device step on torch.distributed. World size 2
    over gloo with both ranks on the one card (`_sharded_worker`), then
    world size 1 over NCCL in this process; neither gives a scaling
    figure. Returns the K1 (ring), K2 (row range) and K3 (band window)
    entries of the kernels line."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from nbodysim_tpu_torch import SimConfig, Simulation
    from nbodysim_tpu_torch.io import load_checkpoint_sharded, save_checkpoint
    from nbodysim_tpu_torch.kernels.allpairs import (
        allpairs_accelerations, allpairs_accelerations_plain,
        allpairs_accelerations_wide)
    from nbodysim_tpu_torch.kernels.collide import (
        allpairs_collision_deltas, collision_deltas_plain, rect_pair_deltas,
        rect_pair_deltas_plain)
    from nbodysim_tpu_torch.kernels.collide_block import (
        block_collision_deltas, block_collision_deltas_plain, lead_offsets,
        lex_searchsorted)
    from nbodysim_tpu_torch.kernels.nearfield import (
        bucket_stencil, bucket_stencil3, bucket_stencil3_plain,
        bucket_stencil_plain)
    from nbodysim_tpu_torch.parallel import (
        comm, make_mesh, make_sharded_step, prime_accelerations_sharded,
        shard_state)
    from nbodysim_tpu_torch.parallel.sharded import make_sharded_rollout
    from nbodysim_tpu_torch.physics import barneshut as bh
    from nbodysim_tpu_torch.physics import barneshut3d as bh3
    from nbodysim_tpu_torch.physics import collisions as coll
    from nbodysim_tpu_torch.physics.integrators import make_step
    from nbodysim_tpu_torch.scenes import init_scene

    dev, say_ = ctx.dev, (lambda m: say("sharded", m))
    t13 = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "smoke13"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    counters = {"K1": allpairs_accelerations, "K2": allpairs_collision_deltas,
                "K3": bucket_stencil, "K4": allpairs_accelerations_wide,
                "K5": rect_pair_deltas, "K6": block_collision_deltas,
                "K7": bucket_stencil3}

    def reset():
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0

    def launches(*names):
        torch.cuda.synchronize()
        return {k: counters[k].launches for k in names}

    def close(got, ref, what, x_rel=1e-6, v_abs=1e-3):
        """tests/test_sharding.py's bounds: pos 1e-6 max|x|, vel 1e-3."""
        ex = float(np.abs(got["pos"] - ref["pos"]).max())
        ev = float(np.abs(got["vel"] - ref["vel"]).max())
        tx = x_rel * float(np.abs(ref["pos"]).max())
        ok = ex <= tx and ev <= v_abs
        say_(f"{what}: max|dpos| {ex:.3e} (tol {tx:.3e}), max|dvel| "
             f"{ev:.3e} (tol {v_abs:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"{what} disagrees with the single-device run")

    def np_pv(st):
        return {"pos": st.pos.cpu().numpy(), "vel": st.vel.cpu().numpy()}

    # The same initial state as Simulation's: its own, before any step.
    disc = Simulation(SimConfig(n=25_000), scene="uniform_disc")
    st0, cfg25 = disc.state, disc.config
    dstate, dcfg = ctx.disc_deep
    ck2 = str(work / "ck_p2.npz")

    # This slice's inputs: phase 8's N=1M galaxy merger (the block pass)
    # and N=1M uniform bucket input, phase 12's 3D N=1M merger (the hash
    # pass, its velocities drawn as there), phase 9's N=1M cube, and
    # Simulation's N=1M Plummer sphere (phase 11's) and N=1M flagship disc
    # under the configs it resolves, for the octree eval and the steps.
    merger3 = init_scene("galaxy_merger", SimConfig(n=1 << 20, dim=3),
                         device=dev)
    g123 = torch.Generator(device=dev)
    g123.manual_seed(123)
    merger3 = merger3.replace(vel=merger3.vel + (-5.0 + (5.0 - -5.0) * (
        torch.rand(merger3.vel.shape, generator=g123, device=dev))))
    hcfg = SimConfig(n=1 << 20, dim=3, collision_broad_phase="hash")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        psim = Simulation(SimConfig(n=1 << 20, dim=3), scene="plummer",
                          virialize=False)
        dsim = Simulation(SimConfig(n=1 << 20), scene="uniform_disc")
    band_in = {
        "block": (ctx.merger, ctx.merger_cfg), "bucket": (ctx.ustate,
                                                          ctx.ucfg),
        "hash": (merger3, hcfg)}
    # Phase 9's cube, from its own generator (seed 9) as there.
    cube_gen = torch.Generator(device=dev)
    cube_gen.manual_seed(9)
    cube_pos = -30000.0 + (30000.0 - -30000.0) * torch.rand(
        (1 << 20, 3), generator=cube_gen, device=dev)
    cube_mass = 0.1 + (10.0 - 0.1) * torch.rand(
        (1 << 20,), generator=cube_gen, device=dev)
    tree_in = {"cube": (cube_pos, cube_mass,
                        SimConfig(n=1 << 20, dim=3, enable_collisions=False)),
               "plummer": (psim.state.pos, psim.state.mass, psim.config)}
    say_(f"N=1M disc under auto: {dsim.config.force_backend}, deep "
         f"{dsim.config.bh_deep_levels}, collisions "
         f"{dsim.config.collision_broad_phase}; N=1M Plummer sphere: "
         f"{psim.config.force_backend}, deep {psim.config.bh_deep_levels}, "
         f"collisions {psim.config.collision_broad_phase}, bh_nf_sparse "
         f"{psim.config.bh_nf_sparse}")

    # ---- (b) world size 2 over gloo, both ranks on the one card --------
    jobs = {"disc": _np_state(st0), "disc_cfg": _cfg_fields(cfg25),
            "upos": ctx.upos.cpu().numpy(), "umass": ctx.umass.cpu().numpy(),
            "u_cfg": _cfg_fields(ctx.tcfg),
            "dpos": dstate.pos.cpu().numpy(),
            "dmass": dstate.mass.cpu().numpy(), "d_cfg": _cfg_fields(dcfg),
            "ck": ck2}
    for key, (st_, cfg_) in band_in.items():
        jobs[key], jobs[key + "_cfg"] = _np_state(st_), _cfg_fields(cfg_)
    for key, (p_, m_, cfg_) in tree_in.items():
        jobs[key] = {"pos": p_.cpu().numpy(), "mass": m_.cpu().numpy()}
        jobs[key + "_cfg"] = _cfg_fields(cfg_)
    for key, sim in (("disc_steps", dsim), ("plummer_steps", psim)):
        jobs[key], jobs[key + "_cfg"] = (_np_state(sim.state),
                                         _cfg_fields(sim.config))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = comm.spawn(_sharded_worker, 2, (jobs,), backend="gloo",
                       timeout_s=300.0, threads=4)
    r0 = ranks[0]
    say_(f"world size 2 over gloo, both ranks on the one card: "
         f"{time.perf_counter() - t0:.1f} s with start-up; collectives "
         f"staged through host memory: {r0['host_staged']}")
    for r in ranks:
        say_(f"rank {r['rank']}: disc step launches {r['disc_launches']}, "
             f"banded eval launches {r['u_launches']}, deep chain "
             f"{r['d_launches']}; band {r['u_work']['band_rows']} rows "
             f"(window {r['u_work']['window_rows']}), window capacity "
             f"{r['u_work']['window_capacity']}, sorted "
             f"{r['u_work']['sorted_len']}; deep band capacity "
             f"{r['d_work'].get('deep_capacity')}")
        require(r["disc_launches"]["K1"] == 2 and
                r["disc_launches"]["K2"] == 1,
                f"rank {r['rank']}: the disc step launched "
                f"{r['disc_launches']}, expected K1 twice (the ring), K2 "
                f"once")
        require(r["u_launches"]["K3"] == 1 and r["u_launches"]["K1"] == 1
                and r["u_launches"]["K4"] == 1,
                f"rank {r['rank']}: the banded eval launched "
                f"{r['u_launches']}, expected K1, K3, K4 once")
    one = make_step(cfg25)(st0)
    close(r0["disc"], np_pv(one), "P=2 disc step vs the single-device step")
    say_(f"P=2 disc step {r0['disc_step_ms']:.4f} ms a step on rank 0 "
         f"(CUDA events, 20 steps; two ranks share the card and gloo moves "
         f"the data through host memory: not a scaling figure)")

    def acc_close(got, ref, what):
        scale = float(ref.abs().max())
        err = float(np.abs(got - ref.cpu().numpy()).max())
        ok = err <= 2e-5 * scale
        say_(f"{what}: max_abs_err {err:.3e} (tol 2e-5 * max|a| = "
             f"{2e-5 * scale:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"{what} disagrees with the single-device tree")

    ref_u = bh.bh_accelerations(ctx.upos, ctx.umass, ctx.tcfg)
    acc_close(r0["u_acc"], ref_u, "banded eval, N=1M uniform, P=2")
    say_(f"banded eval N=1M uniform at P=2: {r0['u_ms']:.4f} ms on rank 0 "
         f"(CUDA events, 3 after 1; not a scaling figure)")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref_d = bh.bh_accelerations(dstate.pos, dstate.mass, dcfg)
    finally:
        torch.use_deterministic_algorithms(False)
    acc_close(r0["d_acc"], ref_d, "banded deep chain, N=1M disc, P=2 "
              "(deterministic index_add_)")
    say_(f"banded deep chain N=1M disc at P=2: {r0['d_ms']:.4f} ms on rank "
         f"0 (CUDA events, 3 after 1; not a scaling figure)")

    # ---- this slice: the banded broad phases, the banded octree --------
    for r in ranks:
        for key in ("block", "bucket", "hash", "cube", "plummer"):
            say_(f"rank {r['rank']}: banded {key} launches "
                 f"{r[key + '_launches']}, work {r[key + '_work']}")
        for key in ("disc_steps", "plummer_steps"):
            say_(f"rank {r['rank']}: {key} (2 steps) launches "
                 f"{r[key + '_launches']}, work {r[key + '_work']}")
        require(r["block_launches"]["K6"] == 1
                and r["block_work"]["band_blocks"] > 0,
                f"rank {r['rank']}: the banded block pass launched "
                f"{r['block_launches']}, work {r['block_work']}")
        require(r["hash_launches"]["K5"] >= 2 and r["cube_launches"]["K7"] == 1
                and r["plummer_launches"]["K7"] == 1,
                f"rank {r['rank']}: banded hash K5 "
                f"{r['hash_launches']['K5']}, octree K7 "
                f"{r['cube_launches']['K7']} / "
                f"{r['plummer_launches']['K7']}")
        pl_l, dl_l = r["plummer_steps_launches"], r["disc_steps_launches"]
        require(pl_l["K5"] >= 2 and pl_l["K6"] == 2 and pl_l["K7"] == 2
                and pl_l["K1"] == 2 and pl_l["K4"] == 2,
                f"rank {r['rank']}: the Plummer steps launched {pl_l}, "
                f"expected K1, K4, K6, K7 once a step and K5")
        require(dl_l["K1"] == 2 and dl_l["K3"] == 2 and dl_l["K4"] == 2
                and dl_l["K5"] >= 2,
                f"rank {r['rank']}: the disc steps launched {dl_l}, "
                f"expected K1, K3, K4 once a step and K5")

    # The single-device pass's deltas (pos + dpos - pos would round them to
    # the positions' ulp, 0.03 at the mergers' 3e5).
    single = {"block": coll._block_deltas, "bucket": coll._bucket_deltas,
              "hash": coll._grid_deltas}
    for key, (st_, cfg_) in band_in.items():
        ref = single[key](st_, cfg_, True)
        tol = 1e-5 * max(float(st_.vel.abs().max()), 10.0)
        err = max(float(np.abs(g - b.cpu().numpy()).max())
                  for g, b in zip(r0[key], ref))
        ok = err <= tol and all(np.isfinite(g).all() for g in r0[key])
        say_(f"banded {key} pass ({cfg_.collision_broad_phase}, "
             f"{cfg_.dim}D N=1M) at P=2 vs the single-device pass: "
             f"max_abs_err {err:.3e} (tol 1e-5 * max(max|v|, 10) = "
             f"{tol:.3e}) {'ok' if ok else 'FAIL'}; {r0[key + '_ms']:.4f} ms "
             f"on rank 0 (CUDA events, 3 after 3; not a scaling figure)")
        require(ok, f"the banded {key} pass disagrees with the single device")
        del ref
    for key, (p_, m_, cfg_) in tree_in.items():
        torch.use_deterministic_algorithms(key == "plummer", warn_only=True)
        try:
            ref = bh3.bh3_accelerations(p_, m_, cfg_)
        finally:
            torch.use_deterministic_algorithms(False)
        acc_close(r0[key], ref, f"banded octree {key} N=1M, P=2"
                  + (" (deep chain, tiles; deterministic index_add_)"
                     if key == "plummer" else ""))
        say_(f"banded octree {key} at P=2: {r0[key + '_ms']:.4f} ms on rank "
             f"0 (CUDA events, 3 after 3, index_add_ as the step runs it; "
             f"not a scaling figure)")
        del ref

    # The slice's path end to end: Simulation's 2 steps on one device.
    for key, sim in (("disc_steps", dsim), ("plummer_steps", psim)):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            sim.run(2)
        finally:
            torch.use_deterministic_algorithms(False)
        require(r0[key]["frame"] == int(sim.state.frame), f"{key} frame")
        close(r0[key], np_pv(sim.state), f"{key}: 2 make_sharded_step steps "
              f"at P=2 vs Simulation.run(2), N=1M",
              v_abs=1e-5 * float(sim.state.vel.abs().max()))
        say_(f"{key}: {r0[key + '_ms']:.4f} ms a step on rank 0 (CUDA "
             f"events over steps 3-4, index_add_ as the step runs it; not a "
             f"scaling figure)")
    del psim, dsim, merger3

    # ---- (a) world size 1 over NCCL, in this process ------------------
    dist.init_process_group("nccl", init_method=f"file://{work}/pg1",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        step = make_sharded_step(cfg25, mesh)
        # One step each on a copy first: NCCL sets its communicator up at
        # its first collective.
        step(shard_state(st0, mesh))
        make_step(cfg25)(st0)
        ss = shard_state(st0, mesh)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        reset()
        ev[0].record()
        for _ in range(200):
            ss = step(ss)
        ev[1].record()
        sh_launches = launches("K1", "K2")
        ev[2].record()
        disc.run(200)
        ev[3].record()
        torch.cuda.synchronize()
        sh_sps = 200e3 / ev[0].elapsed_time(ev[1])
        sim_sps = 200e3 / ev[2].elapsed_time(ev[3])
        same = all(torch.equal(getattr(ss, f), getattr(disc.state, f))
                   for f in ("pos", "vel", "acc", "frame"))
        say_(f"P=1 over NCCL, N=25k disc, 200 steps: make_sharded_step "
             f"{sh_sps:.1f} steps/s, Simulation.run {sim_sps:.1f} steps/s "
             f"(CUDA events, after one step each); launches "
             f"{sh_launches}; the states "
             f"{'are bit for bit the same' if same else 'DIFFER'}")
        require(same and sh_launches == {"K1": 200, "K2": 200},
                f"P=1 sharded step: same={same}, launches {sh_launches}")
        ro = make_sharded_rollout(cfg25, mesh, 200)(shard_state(st0, mesh))
        same = all(torch.equal(getattr(ro, f), getattr(disc.state, f))
                   for f in ("pos", "vel", "acc", "frame"))
        say_(f"make_sharded_rollout(200) at P=1: "
             f"{'bit for bit' if same else 'DIFFERS from'} Simulation.run")
        require(same, "the P=1 sharded rollout differs from Simulation.run")

        # The leapfrog prime.
        lf = Simulation(SimConfig(n=25_000, integrator="leapfrog_kdk"),
                        scene="uniform_disc")
        ps = prime_accelerations_sharded(
            shard_state(lf.state.replace(acc=torch.zeros_like(lf.state.acc)),
                        mesh), lf.config, mesh)
        lstep = make_sharded_step(lf.config, mesh)
        primed = torch.equal(ps.acc, lf.state.acc)
        for _ in range(10):
            ps = lstep(ps)
        lf.run(10)
        same = all(torch.equal(getattr(ps, f), getattr(lf.state, f))
                   for f in ("pos", "vel", "acc"))
        say_(f"leapfrog at P=1: prime_accelerations_sharded "
             f"{'equals' if primed else 'DIFFERS from'} Simulation's prime; "
             f"10 steps {'bit for bit' if same else 'DIFFER'}")
        require(primed and same, "the P=1 leapfrog prime or steps differ")

        # The N=1M tree under auto at P=1: the replicated tree.
        big = Simulation(SimConfig(n=1 << 20, enable_collisions=False))
        bs = shard_state(big.state, mesh)
        bstep = make_sharded_step(big.config, mesh)
        # index_add_ deterministic in both runs: the pyramid's sums in one
        # order, so the two runs can agree bit for bit.
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            reset()
            for _ in range(5):
                bs = bstep(bs)
            big_launches = launches("K1", "K3", "K4")
            big.run(5)
        finally:
            torch.use_deterministic_algorithms(False)
        same = all(torch.equal(getattr(bs, f), getattr(big.state, f))
                   for f in ("pos", "vel", "acc"))
        say_(f"N=1M under auto ({big.config.force_backend}, deep "
             f"{big.config.bh_deep_levels}) at P=1 (the replicated tree), 5 "
             f"steps: launches {big_launches}; "
             f"{'bit for bit' if same else 'not bit for bit'} Simulation's")
        require(big_launches == {"K1": 5, "K3": 5, "K4": 5},
                f"N=1M sharded tree launches {big_launches}, expected 5 "
                f"each")
        close(np_pv(bs), np_pv(big.state), "N=1M tree, 5 steps at P=1 vs "
              "Simulation", v_abs=1e-5 * float(big.state.vel.abs().max()))
        del big, bs

        # A sharded checkpoint at step 3, resumed to step 6.
        ss = shard_state(st0, mesh)
        for _ in range(3):
            ss = step(ss)
        path = save_checkpoint(str(work / "ck_p1"), ss, cfg25)
        ref = ss
        for _ in range(3):
            ref = step(ref)
        rs, cfg2 = load_checkpoint_sharded(path, mesh)
        step2 = make_sharded_step(cfg2, mesh)
        for _ in range(3):
            rs = step2(rs)
        same = int(rs.frame) == 6 and all(
            torch.equal(getattr(rs, f), getattr(ref, f))
            for f in ("pos", "vel", "acc", "mass", "radius"))
        say_(f"sharded checkpoint at step 3 resumed to step 6 at P=1: "
             f"{'bit for bit' if same else 'DIFFERS from'} the "
             f"uninterrupted run")
        require(same, "the P=1 sharded resume differs")

        # The checkpoint written at P=2, resumed at P=1.
        rs, cfg2 = load_checkpoint_sharded(ck2, mesh)
        step2 = make_sharded_step(cfg2, mesh)
        for _ in range(3):
            rs = step2(rs)
        got = np_pv(rs)
        ref2 = r0["ck_ref"]
        require(int(rs.frame) == ref2["frame"], "P=2 -> P=1 frame")
        ex = float(np.abs(got["pos"] - ref2["pos"]).max())
        ev_ = float(np.abs(got["vel"] - ref2["vel"]).max())
        tx = 2e-6 * float(np.abs(ref2["pos"]).max())
        tv = 2e-5 * max(float(np.abs(ref2["vel"]).max()), 1e-12)
        ok = ex <= tx and ev_ <= tv
        say_(f"checkpoint written at P=2, resumed at P=1 for 3 steps: "
             f"max|dpos| {ex:.3e} (tol {tx:.3e}), max|dvel| {ev_:.3e} (tol "
             f"{tv:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, "the P=2 checkpoint resumed at P=1 disagrees")
    finally:
        dist.destroy_process_group()

    # ---- the launch forms against their plain versions ----------------
    n = st0.n
    n_l = n // 2
    pos, mass = st0.pos, st0.mass
    eps, gc = cfg25.eps_sq, cfg25.g_const

    def hop(fn):
        return lambda: fn(pos[:n_l], None, eps_sq=eps, g_const=gc,
                          src_pos=pos[n_l:], src_mass=mass[n_l:])

    got, want = hop(allpairs_accelerations)(), hop(
        allpairs_accelerations_plain)()
    k1_err = float((got - want).abs().max())
    k1_tol = 1e-5 * float(want.abs().max())
    require(k1_err <= k1_tol, f"K1 ring hop: {k1_err:.3e} > {k1_tol:.3e}")
    k1_ms = ctx.time_ms(hop(allpairs_accelerations), 20)
    k1_plain = ctx.time_ms(hop(allpairs_accelerations_plain), 2)
    k1_bnd = ctx.pair_bound(float(n_l) * n_l, 4.0 * (2 * n_l + 3 * n_l
                                                     + 2 * n_l))

    fields = (st0.pos, st0.vel, st0.mass, st0.radius)
    imp = cfg25.collision_impulse

    def rows(fn):
        return lambda: fn(*fields, impulse=imp, rows=(n_l, n_l))

    got, want = rows(allpairs_collision_deltas)(), rows(
        collision_deltas_plain)()
    vmax = max(float(st0.vel.abs().max()), 10.0)
    k2_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    require(k2_err <= 1e-5 * vmax,
            f"K2 row range: {k2_err:.3e} > {1e-5 * vmax:.3e}")
    k2_ms = ctx.time_ms(rows(allpairs_collision_deltas), 20)
    k2_plain = ctx.time_ms(rows(collision_deltas_plain), 2)
    k2_bnd = ctx.bound(4.0 * (6 * n + 4 * n_l), 7.0 * n_l * n)

    bx, by, bm, counts, rr, eps_k3, rows_c = r0["k3_operands"]
    grid = tuple(t.to(dev) for t in (bx, by, bm))
    counts = counts.to(dev)
    k3_err = ctx.near_case("sharded", f"band window ({tuple(bx.shape)}, "
                           f"rank 0 of 2)", grid, counts, eps_k3, rows_c, rr)
    k3_ms = ctx.time_ms(lambda: bucket_stencil(
        *grid, counts=counts, rr=rr, eps_sq=eps_k3, center_rows=rows_c), 20)
    k3_plain = ctx.time_ms(lambda: bucket_stencil_plain(
        *grid, rr, eps_k3, rows_c), 2)
    res_w, cap = bx.shape[1], bx.shape[2]
    pairs, _, _ = near_pairs(counts, rows_c, rr, cap)
    k3_bnd = ctx.pair_bound(pairs, 4.0 * (3 * float(counts.sum())
                                          + counts.numel()
                                          + 2 * rows_c * res_w * cap))

    # The band launch forms of K5, K6 and K7 (rank 0's first band launch of
    # each) against their plain versions.
    ops = r0["band_operands"]

    def on_dev(x):
        if isinstance(x, tuple):
            return tuple(t.to(dev) for t in x)
        return x.to(dev) if torch.is_tensor(x) else x

    a5, kw5 = ([on_dev(x) for x in ops["K5"][0]],
               {k: on_dev(v) for k, v in ops["K5"][1].items()})
    got = rect_pair_deltas(*a5, **kw5)
    want = rect_pair_deltas_plain(*a5, **kw5)
    vmax = max(float(a5[0][1].abs().max()), 10.0)
    k5_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    require(k5_err <= 1e-5 * vmax,
            f"K5 band launch: {k5_err:.3e} > {1e-5 * vmax:.3e}")
    k5_ms = ctx.time_ms(lambda: rect_pair_deltas(*a5, **kw5), 5)
    k5_plain = ctx.time_ms(lambda: rect_pair_deltas_plain(*a5, **kw5), 1)
    t5, s5 = a5
    k5_pairs = k5_needed_pairs(t5, s5, kw5["max_cheb"])
    dim5 = kw5["dim"]
    k5_cols = 2 * dim5 + 2 + (0 if kw5["max_cheb"] is None else dim5)
    k5_bnd = ctx.bound(4.0 * (k5_cols * (t5[0].shape[0] + s5[0].shape[0])
                              + 2 * dim5 * t5[0].shape[0]), 7.0 * k5_pairs)
    k5_what = (f"{t5[0].shape[0]} x {s5[0].shape[0]}, "
               + ("the residual's pass (b) on rank 0's chunk of sorted "
                  "targets" if kw5["max_cheb"] == 1 else "a big-body pass")
               + f", {dim5}D")

    a6, kw6 = [on_dev(x) for x in ops["K6"][0]], ops["K6"][1]
    planes6, keys6, wlo6, _ = a6
    dim6, n_tot6 = keys6.shape
    got = block_collision_deltas(*a6, **kw6)
    want = block_collision_deltas_plain(*a6, **kw6)
    vmax = max(float(planes6[dim6:2 * dim6].abs().max()), 10.0)
    k6_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    require(k6_err <= 1e-5 * vmax,
            f"K6 band launch: {k6_err:.3e} > {1e-5 * vmax:.3e}")
    k6_ms = ctx.time_ms(lambda: block_collision_deltas(*a6, **kw6), 5)
    k6_plain = ctx.time_ms(lambda: block_collision_deltas_plain(*a6, **kw6),
                           1)
    t_blk, blk0, nbl = kw6["t_blk"], kw6["blk0"], kw6["nb_loc"]
    r_lo, r_hi = blk0 * t_blk, (blk0 + nbl) * t_blk
    ok6 = planes6[-1] > 0
    cum6 = F.pad(torch.cumsum(ok6.to(torch.int64), 0), (1, 0))
    tsel = ok6.clone()
    tsel[:r_lo] = False
    tsel[r_hi:] = False
    kt = keys6[:, tsel]
    offs6 = torch.tensor(lead_offsets(dim6), dtype=torch.int32, device=dev)
    lead6 = [kt[a][:, None] + offs6[None, :, a] for a in range(dim6 - 1)]
    tail6 = kt[dim6 - 1][:, None].expand(-1, offs6.shape[0])
    lo6 = lex_searchsorted(list(keys6), lead6 + [tail6 - 1], False, n_tot6)
    hi6 = lex_searchsorted(list(keys6), lead6 + [tail6 + 1], True, n_tot6)
    k6_pairs = float((cum6[hi6.long()] - cum6[lo6.long()]).sum()
                     - kt.shape[1])
    k6_bnd = ctx.bound(4.0 * (n_tot6 * (2 * dim6 + 3) + n_tot6 * dim6
                              + 2 * (r_hi - r_lo) * dim6
                              + 2 * wlo6.numel()), 7.0 * k6_pairs)

    a7, kw7 = [on_dev(x) for x in ops["K7"][0]], {
        k: on_dev(v) for k, v in ops["K7"][1].items()}
    counts7, rr7, eps7, rows7 = (kw7["counts"], kw7["rr"], kw7["eps_sq"],
                                 kw7["center_rows"])
    k7_err = ctx.near_case("sharded", f"x-slab window ({tuple(a7[0].shape)},"
                           f" rank 0 of 2)", tuple(a7), counts7, eps7, rows7,
                           rr7)
    k7_ms = ctx.time_ms(lambda: bucket_stencil3(*a7, **kw7), 10)
    k7_plain = ctx.time_ms(lambda: bucket_stencil3_plain(
        *a7, rr7, eps7, rows7), 2)
    res7, cap7 = a7[0].shape[1], a7[0].shape[3]
    k7_pairs, _, _ = near_pairs(counts7, rows7, rr7, cap7)
    k7_bnd = ctx.bound(4.0 * (4 * float(counts7.sum()) + counts7.numel()
                              + 3 * rows7 * res7 * res7 * cap7),
                       19.0 * k7_pairs, k7_pairs)

    # K1 on rank 0's range of the octree's outlier indices (all N
    # sources) and K4 on its local rows (the outliers as sources), at the
    # shapes the banded octree gives them on phase 9's cube at P=2.
    ccfg = tree_in["cube"][2]
    n3c = cube_pos.shape[0]
    ext3 = bh._extract_heavy_outliers(cube_pos, cube_mass)
    out_i3 = ext3["out_i"]
    oi3 = out_i3[:-(-out_i3.shape[0] // 2)]
    nh_mass = torch.where(ext3["is_heavy"], 0.0, cube_mass)
    osm3 = torch.where(ext3["out_sel"] & ~ext3["is_heavy"][out_i3],
                       cube_mass[out_i3], 0.0)
    rows3 = cube_pos[:cube_pos.shape[0] // 2]
    kw3 = dict(eps_sq=ccfg.eps_sq, g_const=ccfg.g_const)
    band_k = {
        "K1": (lambda: allpairs_accelerations(
            cube_pos[oi3], None, src_pos=cube_pos, src_mass=nh_mass, **kw3),
               lambda: allpairs_accelerations_plain(
            cube_pos[oi3], None, src_pos=cube_pos, src_mass=nh_mass, **kw3),
               float(oi3.shape[0]) * cube_pos.shape[0],
               4.0 * (4 * cube_pos.shape[0] + 6 * oi3.shape[0])),
        "K4": (lambda: allpairs_accelerations_wide(
            rows3, cube_pos[out_i3], osm3, **kw3),
               lambda: allpairs_accelerations_plain(
            rows3, None, src_pos=cube_pos[out_i3], src_mass=osm3, **kw3),
               float(rows3.shape[0]) * out_i3.shape[0],
               4.0 * (6 * rows3.shape[0] + 4 * out_i3.shape[0]))}
    band_res = {}
    for k, (kern, plain, pairs, nbytes) in band_k.items():
        got, want = kern(), plain()
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        require(err <= tol, f"{k} on the octree's band: {err:.3e} > "
                f"{tol:.3e}")
        band_res[k] = (err, ctx.time_ms(kern, 10), ctx.time_ms(plain, 1),
                       ctx.bound(nbytes, 19.0 * pairs, pairs))
    del cube_pos, cube_mass, tree_in

    for name, ms, plain_ms, bnd in (("K1 ring hop", k1_ms, k1_plain, k1_bnd),
                                    ("K2 row range", k2_ms, k2_plain,
                                     k2_bnd),
                                    ("K3 band window", k3_ms, k3_plain,
                                     k3_bnd),
                                    (f"K5 band ({k5_what})", k5_ms, k5_plain,
                                     k5_bnd),
                                    (f"K6 band (blocks {blk0}..{blk0 + nbl}"
                                     f" of {n_tot6 // t_blk})", k6_ms,
                                     k6_plain, k6_bnd),
                                    ("K7 x-slab window", k7_ms, k7_plain,
                                     k7_bnd),
                                    (f"K1 octree outlier range "
                                     f"({oi3.shape[0]} x {n3c})",
                                     *band_res["K1"][1:]),
                                    (f"K4 octree local rows "
                                     f"({rows3.shape[0]} x {out_i3.shape[0]})",
                                     *band_res["K4"][1:])):
        say_(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
             f"{bnd[0]:.4f} ms ({bnd[1]})")
    say_(f"phase 13 took {time.perf_counter() - t13:.1f} s")
    pl_l = r0["plummer_steps_launches"]
    return [
        ctx.entry(f"K1 allpairs_accelerations (ring hop, P=2: {n_l} x {n_l}"
                  f"; launches: one step, rank 0)",
                  "nbodysim_tpu_torch/csrc/allpairs.cu",
                  "nbodysim_tpu/kernels/allpairs.py:56",
                  r0["disc_launches"]["K1"], k1_err, k1_ms, k1_plain,
                  k1_bnd),
        ctx.entry(f"K2 allpairs_collision_deltas (row range, P=2: {n_l} "
                  f"rows x {n}; launches: one step, rank 0)",
                  "nbodysim_tpu_torch/csrc/collide.cu",
                  "nbodysim_tpu/kernels/collide.py:40",
                  r0["disc_launches"]["K2"], k2_err, k2_ms, k2_plain,
                  k2_bnd),
        ctx.entry(f"K3 bucket_stencil (band window, P=2: "
                  f"{tuple(bx.shape)}, rr={rr}; launches: one eval, rank 0)",
                  "nbodysim_tpu_torch/csrc/nearfield.cu",
                  "nbodysim_tpu/kernels/nearfield.py:49",
                  r0["u_launches"]["K3"], k3_err, k3_ms, k3_plain, k3_bnd),
        ctx.entry(f"K5 rect_pair_deltas (band form, P=2: {k5_what}; "
                  f"launches: the N=1M Plummer sphere's 2 sharded steps, "
                  f"rank 0)", "nbodysim_tpu_torch/csrc/collide.cu",
                  "nbodysim_tpu/kernels/collide.py:250", pl_l["K5"], k5_err,
                  k5_ms, k5_plain, k5_bnd),
        ctx.entry(f"K6 block_collision_deltas (band of blocks, P=2: blocks "
                  f"{blk0}..{blk0 + nbl} of {n_tot6 // t_blk}, N=1M merger; "
                  f"launches: the N=1M Plummer sphere's 2 sharded steps, "
                  f"rank 0)", "nbodysim_tpu_torch/csrc/collide_block.cu",
                  "nbodysim_tpu/kernels/collide_block.py:47", pl_l["K6"],
                  k6_err, k6_ms, k6_plain, k6_bnd),
        ctx.entry(f"K7 bucket_stencil3 (x-slab window, P=2: "
                  f"{tuple(a7[0].shape)}, rr={rr7}, N=1M cube; launches: the "
                  f"N=1M Plummer sphere's 2 sharded steps, rank 0)",
                  "nbodysim_tpu_torch/csrc/nearfield3.cu",
                  "nbodysim_tpu/kernels/nearfield.py:262", pl_l["K7"],
                  k7_err, k7_ms, k7_plain, k7_bnd),
        ctx.entry(f"K1 allpairs_accelerations (the banded octree's outlier "
                  f"range, P=2: {oi3.shape[0]} x {n3c}, D=3, N=1M cube; "
                  f"launches: the N=1M Plummer sphere's 2 sharded steps, "
                  f"rank 0)", "nbodysim_tpu_torch/csrc/allpairs.cu",
                  "nbodysim_tpu/kernels/allpairs.py:56", pl_l["K1"],
                  *band_res["K1"]),
        ctx.entry(f"K4 allpairs_accelerations_wide (the banded octree's "
                  f"local rows, P=2: {rows3.shape[0]} x {out_i3.shape[0]}, "
                  f"D=3, N=1M cube; launches: the N=1M Plummer sphere's 2 "
                  f"sharded steps, rank 0)",
                  "nbodysim_tpu_torch/csrc/allpairs.cu",
                  "nbodysim_tpu/kernels/allpairs.py:105", pl_l["K4"],
                  *band_res["K4"]),
    ]


def _cfg_fields(cfg) -> dict:
    """A SimConfig's fields as a picklable dict (torch dtype included)."""
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def main() -> None:
    import torch

    # -- 1. device -----------------------------------------------------------
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    from nbodysim_tpu_torch import ParticleState, SimConfig, Simulation
    from nbodysim_tpu_torch.diagnostics.metrics import kinetic_energy
    from nbodysim_tpu_torch.kernels import _build
    from nbodysim_tpu_torch.kernels.allpairs import (
        _launch, allpairs_accelerations, allpairs_accelerations_plain,
        allpairs_accelerations_wide, allpairs_potential,
        allpairs_potential_plain, source_splits, targets_per_thread)
    from nbodysim_tpu_torch.kernels.collide import (
        allpairs_collision_deltas, collision_deltas_plain, rect_pair_deltas,
        rect_pair_deltas_plain)
    from nbodysim_tpu_torch.kernels import m2l2 as km2
    from nbodysim_tpu_torch.kernels import m2l3 as km3
    from nbodysim_tpu_torch.kernels.collide_block import (
        block_collision_deltas, block_collision_deltas_plain,
        block_collision_walks, k6_needed_pairs)
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
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if cuobjdump.exists():
        for line in sass_report(lib_path, cuobjdump):
            say("build", f"SASS {line}")
    else:
        say("build", "SASS: not measured (no cuobjdump beside nvcc)")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def uniform(shape, lo, hi, g=gen):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    def own_generator(seed):
        """A generator for one main-path input alone, so that the checks
        drawn from `gen` before it cannot change what the main path runs."""
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def occupied_grid(rows, width, slots, r, dim, mode):
        """A near-field bucket grid filled the force path's way (halo
        included): a count per cell, the slots below it filled, the slots
        above empty. 'occupied': counts uniform in 0..K, one cell in 8 with
        a massless particle in its last occupied slot (a heavy body the
        tree zeroed); 'full': every slot of every cell; 'coincident':
        'occupied' with slot 1 put onto slot 0 wherever a cell holds
        both."""
        cells = (rows + 2 * r,) + (width,) * (dim - 1)
        shape = cells + (slots,)
        if mode == "full":
            counts = torch.full(cells, slots, dtype=torch.int32, device=dev)
        else:
            counts = torch.randint(0, slots + 1, cells, generator=gen,
                                   device=dev, dtype=torch.int32)
        occ = torch.arange(slots, device=dev) < counts[..., None]
        pos = [torch.where(occ, uniform(shape, -5.0, 5.0), 0.0)
               for _ in range(dim)]
        m = torch.where(occ, uniform(shape, 0.1, 2.0), 0.0)
        if mode != "full":
            pick = (torch.rand(cells, generator=gen, device=dev) < 0.125) & (
                counts > 0)
            last = (counts.long() - 1).clamp_min(0)[..., None]
            m = torch.where(torch.zeros(shape, dtype=torch.bool, device=dev)
                            .scatter_(-1, last, pick[..., None]), 0.0, m)
        if mode == "coincident":
            for p in pos:
                p[..., 1] = torch.where(counts >= 2, p[..., 0], p[..., 1])
        return (*pos, m), counts

    def random_counts(grid):
        """Random slot masks: every slot counts as occupied."""
        return torch.full(grid[0].shape[:-1], grid[0].shape[-1],
                          dtype=torch.int32, device=dev)

    def near_case(phase, name, grid, counts, eps_sq, rows, r):
        """K3 (2D grid) or K7 (3D) against its plain version: the slots
        below each count within 1e-5 * max|a|, exactly 0 from it up."""
        dim = len(grid) - 1
        kname = "K3" if dim == 2 else "K7"
        kernel, plain = ((bucket_stencil, bucket_stencil_plain) if dim == 2
                         else (bucket_stencil3, bucket_stencil3_plain))
        got = kernel(*grid, counts=counts, rr=r, eps_sq=eps_sq,
                     center_rows=rows)
        ref = plain(*grid, r, eps_sq, rows)
        torch.cuda.synchronize()
        occ = (torch.arange(grid[0].shape[-1], device=dev)
               < counts[r:r + rows, ..., None])
        require(all(bool(torch.isfinite(a).all()) for a in got),
                f"{kname} {name}: non-finite")
        err = max(float((a[occ] - b[occ]).abs().max())
                  for a, b in zip(got, ref))
        scale = max(float(b[occ].abs().max()) for b in ref)
        zeros = not any(bool(a[~occ].any()) for a in got)
        ok = err <= 1e-5 * scale and zeros
        say(phase, f"{kname} {name}: max_abs_err={err:.3e} over "
            f"{int(occ.sum())} occupied slots, max|a|={scale:.3e} "
            f"tol={1e-5 * scale:.3e}, {int((~occ).sum())} slots past the "
            f"counts {'all 0' if zeros else 'NOT 0'} {'ok' if ok else 'FAIL'}")
        require(ok, f"{kname} {name} disagrees with its plain version")
        return err

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
        k1_case("one target <- one source", uniform((1, 3), -10.0, 10.0),
                None, 1.0, src_pos=uniform((1, 3), -10.0, 10.0),
                src_mass=uniform((1,), 0.1, 10.0)),
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
        hit_ref = rv.abs().sum(-1) + rp.abs().sum(-1) > 0
        n_hit = int(hit_ref.sum())
        same_hits = torch.equal(hit_ref, dv.abs().sum(-1) + dp.abs().sum(-1)
                                > 0)
        ok = err_p <= tol and err_v <= tol and drift <= p_tol and same_hits
        say("K2", f"{name}: particles hit={n_hit} (same set: {same_hits}) "
            f"err_pos={err_p:.3e} "
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
    mass = uniform((4097,), 0.5, 2.0)
    radius = mass.pow(1 / 3) * 1.5
    mass[::7] = 0.0
    k2_errs.append(k2_case(
        "3D cloud N=4097 (ragged tiles, every 7th mass 0)",
        uniform((4097, 3), -24.0, 24.0), uniform((4097, 3), -5.0, 5.0), mass,
        radius))
    k2_errs.append(k2_case("2D disc N=25000", disc.pos, disc.vel, disc.mass,
                           disc.radius))

    # -- 5. main path --------------------------------------------------------
    sim = Simulation(SimConfig(n=25_000), scene="uniform_disc")
    require(sim.state.pos.device.type == "cuda",
            f"Simulation without a device built on {sim.state.pos.device}")
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
    allpairs_potential.launches = 0
    d = sim.diagnostics()
    energies = [float(d.kinetic), float(d.potential), float(d.total_energy)]
    say("main", f"diagnostics: KE={energies[0]:.6e} PE={energies[1]:.6e} "
        f"E={energies[2]:.6e} |p|={float(d.momentum.abs().max()):.6e}")
    require(all(map(math.isfinite, energies)), "main path: non-finite energies")
    pot_launches = allpairs_potential.launches
    require(pot_launches == 1,
            f"diagnostics() launched the potential kernel {pot_launches} "
            f"times, expected once")
    # The potential kernel (the HUD's) on the evolved state against the
    # plain version in float64 and in float32 on the card: every term is
    # positive, so 4e-6 relative (tests/test_torch_cuda.py's bound).
    eps_hud = sim.config.eps_sq
    pot = float(allpairs_potential(st.pos, st.mass, eps_sq=eps_hud))
    pot64 = float(allpairs_potential_plain(st.pos.double(), st.mass.double(),
                                           eps_sq=eps_hud))
    pot32 = float(allpairs_potential_plain(st.pos, st.mass, eps_sq=eps_hud))
    pot_err = abs(pot - pot64) / abs(pot64)
    say("main", f"potential kernel N=25000 after 205 steps: {pot:.9e}, "
        f"float64 plain {pot64:.9e} (rel {pot_err:.3e}), float32 plain "
        f"{pot32:.9e} (rel {abs(pot32 - pot64) / abs(pot64):.3e}); "
        f"{pot_launches} launch a diagnostics() call")
    require(pot_err <= 4e-6, f"potential kernel off by {pot_err:.3e}")
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
    # The step's device work: operations and busy time over 20 profiled
    # steps (kernel and copy rows of torch.profiler, intervals merged),
    # against the unprofiled step time of run(200).
    step_ops, step_busy_ms = device_profile(lambda: sim.run(20), 20)
    step_idle = 1.0 - step_busy_ms * steps_per_s / 1e3
    say("main", f"N=25k step: {step_ops:.2f} device operations a step, "
        f"device busy {step_busy_ms:.4f} ms a step (torch.profiler over 20 "
        f"steps) against {1e3 / steps_per_s:.4f} ms a step unprofiled: the "
        f"device idles {100 * step_idle:.1f}%")

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
    times[("K2", "evolved")] = (time_ms(k2(st), 20), time_ms(k2_plain(st), 2))
    say("timings", f"K2 disc N=25000 after 205 steps: kernel "
        f"{times[('K2', 'evolved')][0]:.4f} ms, plain "
        f"{times[('K2', 'evolved')][1]:.4f} ms")
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

    # The potential kernel at the HUD's N: one rsqrt and 8 flops a pair
    # (2 sub, r^2 in a mul and an FMA, + eps, the sum's FMA), the MUFU pipe
    # bounds it.
    n25 = 25_000.0
    pot_bound = bound(4.0 * n25 * 3, 8.0 * n25 * n25, n25 * n25)
    pot_ms = time_ms(lambda: allpairs_potential(disc.pos, disc.mass,
                                                eps_sq=1.0), 20)
    pot_plain_ms = time_ms(lambda: allpairs_potential_plain(
        disc.pos, disc.mass, eps_sq=1.0), 3)
    say("timings", f"potential disc N=25000: kernel {pot_ms:.4f} ms "
        f"({n25 * n25 / pot_ms * 1e3:.4e} pairs/s), "
        f"{100 * pot_bound[0] / pot_ms:.1f}% of its bound "
        f"{pot_bound[0]:.4f} ms ({pot_bound[1]}); plain {pot_plain_ms:.4f} "
        f"ms")

    # bench.py:232's input for the force headline and the tree code.
    square_gen = own_generator(6)
    upos = uniform((1 << 20, 2), -30000.0, 30000.0, square_gen)
    umass = uniform((1 << 20,), 0.1, 10.0, square_gen)
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

    def m2l2_per_eval(cfg, n):
        """The 2D M2L kernel's launches in one tree eval under `cfg`: the
        levels 2..L, the deep chain's levels L+1..D and its tiles' k
        sub-levels, one launch each."""
        lv = bh._resolve_levels(cfg, n)
        dp = bh._resolve_deep_levels(cfg, lv)
        k = bh._resolve_tile_params(cfg, dp, bh._resolve_radius(cfg))[0]
        return (lv - 1) + max(dp - lv, 0) + k

    m2l2_rows = {}
    m2l2_tol = {"F": 1e-5, "J": 1e-5, "H": 2e-5}      # the card tests' bounds
    m2l2_classes = {"F": (0, 1), "J": (2, 3, 4), "H": (5, 6, 7, 8)}

    def m2l2_level(phase, label, grids, corner, size, eps_sq, rad, v):
        """The 2D M2L kernel at level v of an eval's pyramid, as the eval
        passes it (the pyramid's channel views as one strided tensor):
        against its plain version (each term class within `m2l2_tol` of the
        class's max |value|), timed, bounded by its useful multiply-adds
        (r^2 x the V-list's sources x 42) and its bytes (6 channels in, 9
        terms out), beside the plain route (cuDNN in full f32) as the
        library's time."""
        r = 1 << v
        args = (bh._channel_stack(grids[v]), corner, size, r, eps_sq, rad)
        kw = dict(row0=0, rows=r, x0=0)
        got = km2.m2l2(*args, **kw)
        ref = km2.m2l2_plain(*args, **kw)
        errs = {}
        for cls, ts in m2l2_classes.items():
            scale = max(float(ref[t].abs().max()) for t in ts)
            errs[cls] = max(float((got[t] - ref[t]).abs().max())
                            for t in ts) / scale
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        del got, ref
        ms = time_ms(lambda: km2.m2l2(*args, **kw), 5)
        lib_ms = time_ms(lambda: km2.m2l2_plain(*args, **kw), 2)
        sources = len(bh._m2l_conv_taps(rad, rad, 2)[0]) // 4
        fma = float(r) ** 2 * sources * 42
        bnd = bound(4.0 * r ** 2 * (6 + 9), 2.0 * fma)
        ok = finite and all(errs[c] <= m2l2_tol[c] for c in errs)
        say(phase, f"M2L kernel, {label} level {v} ({r}^2, R={rad}, "
            f"{sources} sources a target): term error of its class's max "
            + ", ".join(f"{c} {e:.3e} (tol {m2l2_tol[c]:g})"
                        for c, e in errs.items())
            + f"; kernel {ms:.4f} ms, {fma / ms / 1e9:.4e} useful FMA/s, "
            f"{100 * bnd[0] / ms:.1f}% of its bound {bnd[0]:.4f} ms "
            f"({bnd[1]}); plain route (cuDNN, full f32) {lib_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"M2L kernel at {r}^2 ({label}) disagrees with its "
                f"plain version: {errs}")
        m2l2_rows[(label, v)] = (max(errs.values()), ms, lib_ms, bnd)

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
    k3_counts = buckets.counts
    stages["K3 near field"] = time_ms(lambda: bucket_stencil(
        *buckets.grid, counts=k3_counts, rr=rr, eps_sq=eps,
        center_rows=res), 20)
    nax, nay = bucket_stencil(*buckets.grid, counts=k3_counts, rr=rr,
                              eps_sq=eps, center_rows=res)
    stages["bucket gather"] = time_ms(
        lambda: bh._bucket_gather(buckets, (nax, nay), res, cap), 10)
    acc_s = bh._bucket_gather(buckets, (nax, nay), res, cap)
    overflow = int(buckets.overflow)
    stages[f"residual (overflow {overflow})"] = time_ms(
        lambda: bh._overflow_residual(buckets, acc_s, eps, rr), 3)
    staged = sum(stages.values())
    # The uniform input may leave no cell over the cap (overflow 0, no
    # residual pass); the small tier's cost with the first sorted body
    # past its cell's cap (the residual takes the slices near it):
    residual_small_ms = time_ms(
        lambda: bh._overflow_residual(one_over(buckets), acc_s, eps, rr), 3)
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
        f"{tree_ms:.4f}; the residual's small tier (1024-wide) with one "
        f"body past the cap takes {residual_small_ms:.4f} ms")
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
    rows, busy_ms = device_profile(
        lambda: [tree(True)() for _ in range(3)], 3)
    if rows:
        say("timings", f"tree eval device busy {busy_ms:.4f} ms per eval "
            f"(torch.profiler, {3 * rows:.0f} device rows over 3 evals): "
            f"{100 * busy_ms / tree_ms:.1f}% of the unprofiled "
            f"{tree_ms:.4f} ms, so the device idles "
            f"{100 * (1 - busy_ms / tree_ms):.1f}%")
    else:
        say("timings", "tree eval device busy: not measured (the profiler "
            "recorded no device rows)")

    # K3, K4 and K1 at the eval's shapes: kernel, plain, bound. The pairs
    # from the grid's occupancy (the bucket counts).
    k3_pairs, k3_issued, k3_written = near_pairs(k3_counts, res, rr, cap)
    k3_full = float(res * res * cap * cap * (2 * rr + 1) ** 2)
    # Bytes: the occupied slots' x, y, m and the counts read once (the
    # kernel stages only those), both outputs written whole (the zeros past
    # the counts too).
    k3_bytes = 4.0 * (3 * float(k3_counts.sum()) + k3_counts.numel()
                      + 2 * res * res * cap)
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
    say("timings", f"K3 N=1M grid: {k3_pairs:.4e} occupied pairs needed "
        f"(the bound's work; what the kernel's active lanes evaluate), "
        f"{k3_issued:.4e} lane-pairs issued with each warp's idle lanes "
        f"({k3_issued / k3_pairs:.3f}x; a model estimate from the counts "
        f"and the library's tile, not measured), {k3_written:.4e} for every "
        f"target slot x occupied sources (a thread-a-slot kernel's work), "
        f"{k3_full:.4e} in the full K x K stencil; K3 "
        f"{k3_pairs / stages['K3 near field'] * 1e3:.4e} needed pairs/s")
    for name, (ms, plain_ms, bnd, by) in tree_k.items():
        say("timings", f"{name} at the tree's shape: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    o_k = targets_per_thread(opos.shape[0], dev)
    say("timings", f"K1 outliers without the source split: {k1_unsplit:.4f} "
        f"ms (split into {source_splits(opos.shape[0], n1m, dev, 32 * o_k)} "
        f"chunks at {o_k} targets a thread: "
        f"{tree_k['K1 outliers'][0]:.4f} ms)")

    # -- 7. tree -------------------------------------------------------------
    def random_grid(rows, width, slots, r):
        shape = (rows + 2 * r, width, slots)
        m = uniform(shape, 0.0, 2.0)
        m = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.4,
                        m, 0.0)
        return uniform(shape, -5.0, 5.0), uniform(shape, -5.0, 5.0), m

    def k3_case(name, grid, eps_sq, rows, r, counts=None):
        if counts is None:
            counts = random_counts(grid)
        return near_case("tree", name, grid, counts, eps_sq, rows, r)

    k3_errs = [
        k3_case("random 40%-filled 12x32x8, rr=2", random_grid(12, 32, 8, 2),
                1.0, 12, 2),
        k3_case("random 40%-filled 512x512x16, rr=2",
                random_grid(512, 512, 16, 2), 1.0, 512, 2),
        k3_case("random 13x37x16, rr=1, eps=0", random_grid(13, 37, 16, 1),
                0.0, 13, 1),
    ]
    for rows_, width, slots, r, eps_sq, mode in (
            (12, 37, 16, 0, 1.0, "occupied"), (64, 50, 16, 2, 1.0, "occupied"),
            (20, 29, 7, 4, 1.0, "occupied"), (16, 40, 16, 2, 1.0, "full"),
            (9, 23, 5, 4, 1.0, "full"), (16, 33, 16, 2, 0.0, "coincident")):
        grid, counts = occupied_grid(rows_, width, slots, r, 2, mode)
        k3_errs.append(k3_case(
            f"{mode} {rows_}x{width}x{slots}, rr={r}, eps^2={eps_sq}", grid,
            eps_sq, rows_, r, counts))
    k3_errs.append(k3_case(f"the N=1M tree grid {res}x{res}x{cap}, rr={rr}",
                           buckets.grid, eps, res, rr, k3_counts))

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
        f"atomics vary the pyramid's last bits; the M2L kernel runs on "
        f"both routes, and m2l2_level holds it to its plain version) "
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
    others = (allpairs_collision_deltas, rect_pair_deltas,
              block_collision_deltas, bucket_stencil3)
    for c in (allpairs_accelerations, allpairs_accelerations_wide,
              bucket_stencil, km2.m2l2) + others:
        c.launches = 0
    start.record()
    tsim.run(20)
    end.record()
    torch.cuda.synchronize()
    tree_launches = {"K1": allpairs_accelerations.launches,
                     "K3": bucket_stencil.launches,
                     "K4": allpairs_accelerations_wide.launches,
                     "M2": km2.m2l2.launches,
                     "other": sum(c.launches for c in others)}
    tree_steps_per_s = 20 / (start.elapsed_time(end) / 1e3)
    say("tree", f"launches during run(20) at N={n1m}: {tree_launches}; "
        f"{tree_steps_per_s:.3f} steps/s (CUDA events, after 2 warm-up "
        f"steps)")
    tree_m2 = 20 * m2l2_per_eval(tsim.config, n1m)
    require(tree_launches == {"K1": 20, "K3": 20, "K4": 20, "M2": tree_m2,
                              "other": 0},
            f"tree kernel launches {tree_launches}, expected K1, K3 and K4 "
            f"20 each and the M2L kernel {tree_m2}")
    st = tsim.state
    for name in ("pos", "vel", "acc"):
        require(bool(torch.isfinite(getattr(st, name)).all()),
                f"tree path: non-finite {name}")
    ke = float(kinetic_energy(st))
    pe = float(potential_energy(st.pos, st.mass, eps, gc, block_size=8192))
    say("tree", f"frame {tsim.frame}: KE={ke:.6e} PE={pe:.6e}")
    require(math.isfinite(ke) and math.isfinite(pe),
            "tree path: non-finite energies")

    # The flagship disc from N = 131,072 overflows its buckets past the
    # residual's cap: 'auto' switches the deep-overflow chain on.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim131 = Simulation(SimConfig(n=131_072), scene="uniform_disc")
    c131 = sim131.config
    over131 = bh.bh_near_overflow(sim131.state.pos, sim131.state.mass, c131)
    tiles131 = bh._resolve_tile_params(
        c131, bh._resolve_deep_levels(c131, bh._resolve_levels(c131, 131_072)),
        bh._resolve_radius(c131))
    sim131.run(2)
    torch.cuda.synchronize()
    ok131 = (c131.force_backend == "bh" and c131.bh_deep_levels == -1
             and tiles131[0] > 0
             and any("deep-overflow" in str(w.message) for w in caught)
             and bool(torch.isfinite(sim131.state.pos).all()))
    say("tree", f"uniform_disc N=131072 under auto (bucket overflow "
        f"{over131}): force_backend {c131.force_backend}, bh_deep_levels "
        f"{c131.bh_deep_levels}, tiles (k, t, T) {tiles131}, collisions "
        f"{c131.collision_broad_phase}; 2 steps, state finite "
        f"{'ok' if ok131 else 'FAIL'}")
    require(ok131, "uniform_disc N=131072 under auto did not resolve to the "
            "deep chain with tiles (with its warning) and run")
    del sim131

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

    def k6_bound(planes, s_, pairs):
        """K6's bound: the planes, keys and windows read once and the deltas
        written once (bytes), or 7 flops a pair through its masks."""
        dim_, n_tot_ = s_.keys.shape
        return bound(4.0 * (n_tot_ * (2 * dim_ + 3) + n_tot_ * dim_
                            + 2 * n_tot_ * dim_ + 2 * s_.w_lo.numel()),
                     7.0 * pairs)

    def k6_report(name, planes, s_, ms):
        """K6's time against its bound, and what its counting launch
        measures: the rows its threads walk (the lane-pairs issued) against
        the pairs the masks pass, those read directly, unstaged, the same
        with idle lanes counted to their warp's longest walk, the rows
        staged, the pairs that overlap, and
        its CTAs' SM cycles split between finding the runs and walking them.
        Returns the bound."""
        needed = k6_needed_pairs(planes, s_.keys)
        bnd = k6_bound(planes, s_, needed)
        w = block_collision_walks(planes, s_.keys, s_.w_lo, s_.w_hi,
                                  t_blk=s_.t_blk, impulse=1.5)
        cyc = w["cycles_runs"] + w["cycles_walk"]
        say("collide", f"K6 {name}: kernel {ms:.4f} ms, bound {bnd[0]:.4f} "
            f"ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound; "
            f"{needed:.4e} pairs through its masks, {w['walked']:.4e} rows "
            f"walked ({w['walked'] / max(needed, 1.0):.3f}x, measured; "
            f"{w['direct']:.4e} of them read directly by warps with short "
            f"runs), {w['warp_slots']:.4e} lane slots with idle lanes "
            f"({w['warp_slots'] / max(w['walked'], 1):.3f}x the walked), "
            f"{w['staged']:.4e} rows staged, {w['overlapping']:.4e} pairs "
            f"overlapping (resolved); CTA cycles "
            f"{100 * w['cycles_runs'] / max(cyc, 1):.1f}% finding runs, "
            f"{100 * w['cycles_walk'] / max(cyc, 1):.1f}% walking them")
        return bnd

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
    # Three launches, one at a time, with nvidia-smi sampling the card.
    clocks = subprocess.Popen(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    time.sleep(0.5)
    k1_merger_runs = []
    for _ in range(3):
        a_m, ms = timed(lambda: allpairs_accelerations(
            merger.pos, merger.mass, eps_sq=mcfg.eps_sq,
            g_const=mcfg.g_const))
        k1_merger_runs.append(ms)
    k1_merger_ms = sum(k1_merger_runs) / 3
    clocks.terminate()
    samples = sorted(tuple(map(float, ln.split(","))) for ln in
                     clocks.communicate()[0].splitlines()
                     if ln.count(",") == 1)
    say("collide", "SM clock and power during three 1M x 1M launches "
        f"({', '.join(f'{t:.4f}' for t in k1_merger_runs)} ms; nvidia-smi "
        f"every 50 ms, {len(samples)} samples): " + (
            f"{samples[0][0]:.0f}-{samples[-1][0]:.0f} MHz, median "
            f"{samples[len(samples) // 2][0]:.0f} MHz, up to "
            f"{max(w for _, w in samples):.1f} W" if samples else
            "not measured"))
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
        f"(mean of three launches), 4096 rows against the plain version "
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
        # Their bound: the residual's own inputs (as `_residual_corrections`
        # builds them), the pairs both launches' masks pass (a symmetric
        # count, so the 4M side is the chunked one), 8 columns a row in and
        # 4 out for each launch's targets.
        fs4 = bp4.fields_s
        keep4 = bp4.ok_p | bp4.big_s
        oi4 = torch.argsort(keep4.to(torch.int32),
                            stable=True)[:coll._OVERFLOW_CAP]
        o4 = (fs4[0][oi4], fs4[1][oi4],
              torch.where(~keep4[oi4], fs4[2][oi4], 0.0), fs4[3][oi4],
              fs4[4][oi4])
        cover4 = fs4[:2] + (torch.where(bp4.ok_p, fs4[2], 0.0),) + fs4[3:]
        res4_pairs = (k5_needed_pairs(fs4, o4, 1)
                      + k5_needed_pairs(cover4, o4, 1))
        rows4 = fs4[0].shape[0] + o4[0].shape[0]
        res4_bound = bound(4.0 * 20 * rows4, 7.0 * res4_pairs)
        say("collide", f"residual K5 at N={n4}, [{fs4[0].shape[0]} x "
            f"{o4[0].shape[0]}] and [{o4[0].shape[0]} x {fs4[0].shape[0]}]: "
            f"{res4_pairs:.4e} pairs through their masks of "
            f"{2.0 * fs4[0].shape[0] * o4[0].shape[0]:.4e} tested, bound "
            f"{res4_bound[0]:.4f} ms ({res4_bound[1]}) for both")
        del fs4, keep4, oi4, o4, cover4
    else:
        residual_launches = 0
    stages4["scatter back"] = time_ms(scatter_back, 10)
    say("collide", f"merger N={n4}: one block pass {pass4_ms:.4f} ms "
        f"through the kernels (CUDA events, 5 passes after 2)")
    for name, ms in stages4.items():
        say("collide", f"  stage {name}: {ms:.4f} ms "
            f"({100 * ms / pass4_ms:.1f}% of the pass)")
    k6_report(f"N={n4} pass", bp4.planes, s4, stages4["K6"])
    del s4, bp4, dp4, dv4, inv4
    # One force evaluation of the N = 4M merger state under config 5's
    # forces: the tree with the deep-overflow chain and tiles.
    cfg4d = SimConfig(n=n4, force_backend="bh", bh_deep_levels=-1)
    km2.m2l2.launches = 0
    a4, deep4_first_ms = timed(lambda: bh.bh_accelerations(
        merger4.pos, merger4.mass, cfg4d))
    m2_4m = km2.m2l2.launches
    require(bool(torch.isfinite(a4).all()), "N=4M deep eval: non-finite")
    del a4
    deep4_ms = time_ms(lambda: bh.bh_accelerations(
        merger4.pos, merger4.mass, cfg4d), 3)
    lv4 = bh._resolve_levels(cfg4d, n4)
    dp4_ = bh._resolve_deep_levels(cfg4d, lv4)
    say("collide", f"merger N={n4}, config 5's forces (bh, bh_deep_levels="
        f"-1; levels {lv4}, deep {dp4_}, tiles "
        f"{bh._resolve_tile_params(cfg4d, dp4_, bh._resolve_radius(cfg4d))}"
        f", bucket overflow "
        f"{bh.bh_near_overflow(merger4.pos, merger4.mass, cfg4d)}): one "
        f"eval {deep4_ms:.4f} ms (CUDA events, 3 evals after 1; the first "
        f"took {deep4_first_ms:.4f} ms); M2L kernel launches in one eval "
        f"{m2_4m}")
    require(m2_4m == m2l2_per_eval(cfg4d, n4) == 14,
            f"N=4M deep eval launched the M2L kernel {m2_4m} times, expected "
            f"14: levels 2-{lv4}, deep {lv4 + 1}-{dp4_}, 3 tile sub-levels")
    # The M2L kernel at the eval's two finest levels (the deep chain's
    # 4096^2 and 2048^2 on the synthesized pyramid).
    ext4 = bh._extract_heavy_outliers(merger4.pos, merger4.mass)
    grids4, corner4, size4, _, _ = bh._build_pyramid(
        ext4["bulk_pos"], ext4["tree_mass"], dp4_, synth_quad=True)
    for v in (dp4_, dp4_ - 1):
        m2l2_level("collide", "N=4M merger", grids4, corner4, size4,
                   cfg4d.eps_sq, bh._resolve_radius(cfg4d), v)
    del ext4, grids4
    del merger4
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
    for c in counted + (km2.m2l2,):
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
                       "K6": block_collision_deltas.launches,
                       "M2": km2.m2l2.launches}
    merger_steps_per_s = 3 / (start.elapsed_time(end) / 1e3)
    say("collide", f"launches during run(3) of the N={n_m} merger: "
        f"{merger_launches}; {merger_steps_per_s:.4f} steps/s (CUDA events, "
        f"after 1 warm-up step; {len(caught)} warnings at init)")
    require(merger_launches["K1"] == 3 and merger_launches["K6"] == 3
            and merger_launches["K5"] >= 6 and merger_launches["K5"] % 2 == 0
            and merger_launches["K2"] == merger_launches["K3"]
            == merger_launches["K4"] == merger_launches["M2"] == 0,
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
    del msim, mst

    # The same merger under config 5's forces (scripts/profile_collide4m.py:
    # force_backend "bh", bh_deep_levels=-1): the tree with the deep chain.
    m5cfg = mcfg.replace(force_backend="bh", bh_deep_levels=-1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m5sim = Simulation(m5cfg, scene="galaxy_merger", device="cuda")
    require(m5sim.config.force_backend == "bh"
            and m5sim.config.bh_deep_levels == -1,
            f"config 5 merger resolved to {m5sim.config.force_backend}, "
            f"bh_deep_levels {m5sim.config.bh_deep_levels}")
    m5sim.run(1)  # warm-up
    torch.cuda.synchronize()
    for c in counted + (km2.m2l2,):
        c.launches = 0
    start.record()
    m5sim.run(3)
    end.record()
    torch.cuda.synchronize()
    m5_launches = {"K1": allpairs_accelerations.launches,
                   "K2": allpairs_collision_deltas.launches,
                   "K3": bucket_stencil.launches,
                   "K4": allpairs_accelerations_wide.launches,
                   "K5": rect_pair_deltas.launches,
                   "K6": block_collision_deltas.launches,
                   "M2": km2.m2l2.launches}
    m5_m2 = m2l2_per_eval(m5sim.config, n_m)
    m5_steps_per_s = 3 / (start.elapsed_time(end) / 1e3)
    say("collide", f"launches during run(3) of the N={n_m} merger under "
        f"config 5's forces: {m5_launches}; {m5_steps_per_s:.4f} steps/s "
        f"(CUDA events, after 1 warm-up step) against "
        f"{merger_steps_per_s:.4f} with exact K1 forces; bucket overflow "
        f"{bh.bh_near_overflow(m5sim.state.pos, m5sim.state.mass, m5cfg)}; "
        f"{len(caught)} warnings at init")
    require(m5_launches["K1"] == m5_launches["K3"] == m5_launches["K4"] == 3
            and m5_launches["K6"] == 3 and m5_launches["K2"] == 0
            and m5_launches["M2"] == 3 * m5_m2,
            f"config 5 merger launches {m5_launches}: expected K1, K3, K4 "
            f"and K6 once per step, the M2L kernel {m5_m2} per step")
    for name in ("pos", "vel", "acc"):
        require(bool(torch.isfinite(getattr(m5sim.state, name)).all()),
                f"config 5 merger path: non-finite {name}")
    del m5sim

    # Kernel and plain times at the main path's shapes (the N=1M merger).
    k6_args = (mbp.planes, ms_.keys, ms_.w_lo, ms_.w_hi)
    k6_ms = time_ms(lambda: block_collision_deltas(
        *k6_args, t_blk=ms_.t_blk, impulse=1.5), 20)
    k6_plain_ms = plain_ms[k6_merger_name]
    say("collide", f"K6 merger N={n_m}: plain {k6_plain_ms:.4f} ms")
    k6_bnd = k6_report(f"merger N={n_m}", mbp.planes, ms_, k6_ms)

    # K6 in 3D at full size: the galaxy merger with dim=3 at N = 1M, one
    # block pass under 'auto' (the block pass at the default cell floor).
    cfg3m = SimConfig(n=n_m, dim=3, dt=0.05, integrator="leapfrog_kdk",
                      force_backend="cuda")
    merger3 = init_scene("galaxy_merger", cfg3m, device=dev)
    cfg3m = coll.resolve_collision_phase_for_state(merger3, cfg3m)
    require(coll._broad_phase(merger3, cfg3m) == "block",
            f"3D merger collisions resolved to "
            f"{coll._broad_phase(merger3, cfg3m)}")
    k6_3d_name = f"3D merger N={n_m}"
    k6_3d_err, over3m = block_case(k6_3d_name, merger3, cfg3m)
    for c in counted:
        c.launches = 0
    coll.resolve_collisions(merger3, cfg3m)
    torch.cuda.synchronize()
    pass3m_launches = {"K5": rect_pair_deltas.launches,
                       "K6": block_collision_deltas.launches,
                       "other": sum(c.launches for c in counted[:4])}
    say("collide", f"launches during one pass of the {k6_3d_name} under "
        f"auto: {pass3m_launches} (block overflow {over3m})")
    require(pass3m_launches["K6"] == 1 and pass3m_launches["other"] == 0,
            f"3D merger pass launches {pass3m_launches}: expected K6 once")
    s3m = coll._block_structure(merger3.pos, merger3.radius, cfg3m)
    p3m = coll._block_planes(merger3, s3m).planes
    k6_3d_ms = time_ms(lambda: block_collision_deltas(
        p3m, s3m.keys, s3m.w_lo, s3m.w_hi, t_blk=s3m.t_blk, impulse=1.5), 5)
    pass3m_ms = time_ms(lambda: coll.resolve_collisions(merger3, cfg3m), 2)
    say("collide", f"K6 {k6_3d_name}: plain {plain_ms[k6_3d_name]:.4f} ms; "
        f"{int(s3m.ok_blk.sum())} of {s3m.ok_blk.numel()} blocks covered; "
        f"one pass {pass3m_ms:.4f} ms")
    k6_3d_bnd = k6_report(k6_3d_name, p3m, s3m, k6_3d_ms)
    del merger3, s3m, p3m

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

    def random_grid3(rows, width, slots, r, fill):
        shape = (rows + 2 * r, width, width, slots)
        m = uniform(shape, 0.0, 2.0)
        m = torch.where(torch.rand(shape, generator=gen, device=dev) < fill,
                        m, 0.0)
        return tuple(uniform(shape, -5.0, 5.0) for _ in range(3)) + (m,)

    def k7_case(name, grid, eps_sq, rows, r, counts=None):
        if counts is None:
            counts = random_counts(grid)
        return near_case("tree3d", name, grid, counts, eps_sq, rows, r)

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
    for rows_, width, slots, r, eps_sq, mode in (
            (8, 13, 16, 1, 1.0, "occupied"), (6, 11, 16, 2, 1.0, "occupied"),
            (5, 9, 10, 3, 1.0, "occupied"), (4, 7, 16, 4, 1.0, "occupied"),
            (12, 12, 16, 1, 1.0, "full"), (4, 6, 16, 4, 1.0, "full"),
            (9, 10, 16, 1, 0.0, "coincident")):
        grid, counts = occupied_grid(rows_, width, slots, r, 3, mode)
        k7_errs.append(k7_case(
            f"{mode} {rows_}x{width}x{width} x {slots}, rr={r}, "
            f"eps^2={eps_sq}", grid, eps_sq, rows_, r, counts))

    # The JAX package's 3D headline input (diagnostics/profiling.py:99-101).
    n3 = 1 << 20
    cfg3 = SimConfig(n=n3, dim=3, enable_collisions=False)
    cube_gen = own_generator(9)
    pos3 = uniform((n3, 3), -30000.0, 30000.0, cube_gen)
    mass3 = uniform((n3,), 0.1, 10.0, cube_gen)
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
    k7_counts = b3.counts
    k7_errs.append(k7_case(
        f"the N=1M cube's grid {res3}^3 x {cap}, rr={rr3}", b3.grid, eps,
        res3, rr3, k7_counts))

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
        *b3.grid, counts=k7_counts, rr=rr3, eps_sq=eps, center_rows=res3),
        20)
    nacc3 = bucket_stencil3(*b3.grid, counts=k7_counts, rr=rr3, eps_sq=eps,
                            center_rows=res3)
    stages3["bucket gather"] = time_ms(
        lambda: bh._bucket_gather(b3, nacc3, res3, cap), 10)
    acc_s3 = bh._bucket_gather(b3, nacc3, res3, cap)
    stages3[f"residual (overflow {int(b3.overflow)})"] = time_ms(
        lambda: bh._overflow_residual(b3, acc_s3, eps, rr3), 3)
    residual3_small_ms = time_ms(
        lambda: bh._overflow_residual(one_over(b3), acc_s3, eps, rr3), 3)
    say("timings", f"octree eval N={n3} uniform (L={levels3}, R={radius3}): "
        f"{tree3_ms:.4f} ms through the kernels "
        f"({n3 * n3 / tree3_ms * 1e3:.4e} pairs-equivalent/s, N^2/t), "
        f"{tree3_plain_ms:.4f} ms through the plain versions (one eval)")
    for name, ms in stages3.items():
        say("timings", f"  octree stage {name}: {ms:.4f} ms "
            f"({100 * ms / tree3_ms:.1f}% of the eval)")
    say("timings", f"  stages sum to {sum(stages3.values()):.4f} ms against "
        f"the eval's {tree3_ms:.4f}; the residual's small tier with one "
        f"body past the cap takes {residual3_small_ms:.4f} ms")
    rows3, busy3_ms = device_profile(
        lambda: [bh3.bh3_accelerations(pos3, mass3, cfg3) for _ in range(3)],
        3)
    if rows3:
        say("timings", f"octree eval device busy {busy3_ms:.4f} ms per eval "
            f"(torch.profiler, {3 * rows3:.0f} device rows over 3 evals): "
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

    k7_pairs, k7_issued, k7_evaluated = near_pairs(k7_counts, res3, rr3,
                                                   cap)
    k7_bytes = 4.0 * (4 * float(k7_counts.sum()) + k7_counts.numel()
                      + 3 * res3 ** 3 * cap)
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
    say("timings", f"K7 N=1M grid: {k7_pairs:.4e} occupied pairs needed "
        f"(the bound's work; what the kernel's active lanes evaluate), "
        f"{k7_issued:.4e} lane-pairs issued with each warp's idle lanes "
        f"({k7_issued / k7_pairs:.3f}x; a model estimate from the counts "
        f"and the library's tile, not measured), {k7_evaluated:.4e} for "
        f"every target slot x occupied sources (a thread-a-slot kernel's "
        f"work), "
        f"{float(res3 ** 3 * cap * cap * (2 * rr3 + 1) ** 3):.4e} in the "
        f"full K x K stencil; K7 "
        f"{k7_pairs / stages3['K7 near field'] * 1e3:.4e} needed pairs/s")
    for name, (ms, plain_ms_, bnd, by) in tree3_k.items():
        say("timings", f"{name} at the octree's shape: kernel {ms:.4f} ms, "
            f"plain {plain_ms_:.4f} ms, bound {bnd:.4f} ms ({by})")
    del b3, nacc3, acc_s3, local3, terms3, grids3, k7_counts

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

    # A Plummer sphere too clustered for the buckets: 'auto' turns the 3D
    # deep-overflow chain on.
    pcfg = SimConfig(n=131_072, dim=3)
    plum = init_scene("plummer", pcfg, device=dev, virialize=False)
    over_pl = bh3.bh3_near_overflow(plum.pos, plum.mass, pcfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        psim131 = Simulation(pcfg, state=plum)
    c131 = psim131.config
    lv131 = bh3._resolve_levels3(c131, pcfg.n)
    dp131 = bh3._resolve_deep_levels3(c131, lv131)
    tiles131 = bh3._resolve_tile_params3(c131, dp131,
                                         bh3._resolve_radius3(c131))
    say("tree3d", f"plummer N=131072 dim=3 (overflow {over_pl}) under auto: "
        f"force_backend {c131.force_backend}, bh_deep_levels "
        f"{c131.bh_deep_levels} (levels {lv131}, deep {dp131}), tiles "
        f"(k, t, T) = {tiles131}, bh_nf_sparse {c131.bh_nf_sparse}, "
        f"collisions {c131.collision_broad_phase}")
    require((c131.force_backend, c131.bh_deep_levels, tiles131,
             c131.bh_nf_sparse) == ("bh", -1, (3, 8, 8), 0)
            and any("deep-overflow" in str(w.message) for w in caught),
            "the N=131072 Plummer sphere did not resolve to the 3D deep "
            "chain with tiles and the dense near field")
    psim131.run(2)
    torch.cuda.synchronize()
    for name in ("pos", "vel", "acc"):
        require(bool(torch.isfinite(getattr(psim131.state, name)).all()),
                f"3D deep path N=131072: non-finite {name}")
    say("tree3d", f"plummer N=131072: 2 steps, frame {psim131.frame}, state "
        f"finite")
    del psim131, plum
    say("tree3d", f"phase 9 took {time.perf_counter() - t_phase9:.1f} s")

    # -- 10. deep -------------------------------------------------------------
    # The flagship disc at N = 1M, the default config under 'auto': the 2D
    # tree with the deep-overflow chain and its tiles, collisions on.
    t_phase10 = time.perf_counter()
    n_d = 1 << 20
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dsim = Simulation(SimConfig(n=n_d), scene="uniform_disc")
    dcfg = dsim.config
    lv_d = bh._resolve_levels(dcfg, n_d)
    deep_d = bh._resolve_deep_levels(dcfg, lv_d)
    rad_d = bh._resolve_radius(dcfg)
    tk_d, tt_d, tc_d = bh._resolve_tile_params(dcfg, deep_d, rad_d)
    dpos, dmass = dsim.state.pos, dsim.state.mass
    over_d = bh.bh_near_overflow(dpos, dmass, dcfg)
    say("deep", f"uniform_disc N={n_d}, SimConfig() under auto: "
        f"force_backend {dcfg.force_backend}, bh_deep_levels "
        f"{dcfg.bh_deep_levels} (levels {lv_d}, deep {deep_d}, R {rad_d}), "
        f"tiles (k, t, T) = {(tk_d, tt_d, tc_d)}, collisions "
        f"{dcfg.collision_broad_phase}; bucket overflow {over_d} "
        f"({100 * over_d / n_d:.2f}% of N); {len(caught)} warnings at init")
    require(dcfg.force_backend == "bh" and dcfg.bh_deep_levels == -1
            and deep_d > lv_d and tk_d > 0
            and any("deep-overflow" in str(w.message) for w in caught),
            "the N=1M disc did not resolve to the deep chain with tiles")

    # The eval's intermediates, each stage timed alone on its own inputs
    # (as `_bh_accelerations` and `_deep_chain` compute them).
    rr_d, res_d, dcap_ = rad_d - 1, 1 << lv_d, bh.NEAR_CAP
    ext_d = bh._extract_heavy_outliers(dpos, dmass)
    out_d = ext_d["out_i"]
    opos_d = dpos[out_d]
    k1_src_d = torch.where(ext_d["is_heavy"], 0.0, dmass)
    k4_src_d = torch.where(ext_d["out_sel"] & ~ext_d["is_heavy"][out_d],
                           dmass[out_d], 0.0)
    bulk_d, tm_d = ext_d["bulk_pos"], ext_d["tree_mass"]
    grids_d, corner_d, size_d, cif_d, _ = bh._build_pyramid(
        bulk_d, tm_d, deep_d, synth_quad=True)
    ci_d = cif_d >> (deep_d - lv_d)
    flat_d = ci_d[:, 0] * res_d + ci_d[:, 1]
    flatnf_d = bh._outlier_flat_ids(flat_d, ext_d["is_out"], res_d * res_d)
    terms_d = {lv: bh._m2l_level(grids_d[lv], corner_d, size_d, eps, rad_d)
               for lv in range(2, deep_d + 1)}

    def l2l_d(top=deep_d):
        local = terms_d[2]
        for lv in range(3, top + 1):
            up = bh._l2l_upsample(local, size_d / (1 << lv))
            local = tuple(u + t for u, t in zip(up, terms_d[lv]))
        return local

    lbucket_d, ldeep_d = l2l_d(lv_d), l2l_d()
    bk_d = bh._bucket_grid(dpos, tm_d, ci_d, flatnf_d, res_d, dcap_, rr_d)
    b_par_d = bh._deep_targets(flatnf_d, flat_d, ext_d["is_out"], res_d,
                               dcap_, rad_d)
    pay_d = bh._moment_payload(dpos, tm_d)
    wring_d = tuple(torch.nn.functional.pad(g, (rr_d,) * 4)
                    for g in grids_d[deep_d])
    lagg_d = bh._fold_aggregate_ring(ldeep_d, wring_d, corner_d, size_d,
                                     1 << deep_d, eps, rad_d, 0, 1 << deep_d)
    g3p_d = torch.nn.functional.pad(torch.stack(grids_d[deep_d][:3], -1),
                                    (0, 0, 1, 1, 1, 1))
    tid_d, ts_d, orig_d = bh._tile_select(cif_d, b_par_d, deep_d, tt_d,
                                          tc_d, rad_d)
    cand_d = (ts_d[tid_d] < tc_d) & b_par_d
    need_d = b_par_d & ~cand_d
    n_bpar, n_ref, n_need = (int(b_par_d.sum()), int(cand_d.sum()),
                             int(need_d.sum()))
    sd_d, _ = bh._compact_indices(need_d, bh._deep_rows_cap(n_d))
    sd_d = torch.clamp(sd_d, max=n_d - 1)

    def deep_rows_d():
        far = bh._l2p_eval(lagg_d, cif_d[sd_d], dpos[sd_d], corner_d, size_d,
                           deep_d)
        near = bh._deep_near_aggregates(dpos[sd_d], pay_d[sd_d, :3], g3p_d,
                                        cif_d[sd_d], eps,
                                        size_d / (1 << deep_d), rr=1)
        return far, near

    src_d = bh._tile_src_mask(cif_d, ts_d, deep_d, rad_d, tt_d, tc_d)
    s_cap_d = bh._scatter_cap(n_d)
    n_src = int(src_d.sum())
    compact_src = n_src <= s_cap_d < n_d
    ss_d, _ = bh._compact_indices(src_d, s_cap_d)
    valid_s = ss_d < n_d
    ss_d = torch.clamp(ss_d, max=n_d - 1)
    sc_args = ((torch.where(valid_s[:, None], pay_d[ss_d], 0.0),
                bulk_d[ss_d], cif_d[ss_d]) if compact_src
               else (pay_d, bulk_d, cif_d))
    sc_kw = {"src_mask": valid_s} if compact_src else {}
    geo_d = (corner_d, size_d, deep_d, rad_d, tk_d, tt_d, tc_d)
    m_rows = sc_args[0].shape[0]
    cands = bh._tile_candidates(sc_args[2], ts_d, tt_d, tc_d, rad_d,
                                (1 << deep_d) // tt_d)
    on_edge = cands[1][0] | cands[2][0] | cands[3][0]
    if compact_src:
        on_edge = on_edge & valid_s
    n_edge, halo_cap = int(on_edge.sum()), bh._halo_cap(m_rows)
    g3k_d = bh._tile_scatter(*sc_args, ts_d, orig_d, *geo_d, **sc_kw)
    span = torch.arange(tt_d + 2 * rad_d, device=dev)
    locdp = torch.nn.functional.pad(torch.stack(ldeep_d, -1),
                                    (0, 0, rad_d, rad_d, rad_d, rad_d))
    lw_d = locdp[(orig_d[:, 0, None] + rad_d + span)[:, :, None],
                 (orig_d[:, 1, None] + rad_d + span)[:, None, :]]
    chain_d = bh._tile_chain(lw_d, g3k_d, orig_d, corner_d, size_d, deep_d,
                             rad_d, eps, tk_d, tt_d, tc_d)
    ra_d, _ = bh._compact_indices(cand_d, bh._refined_cap(n_d))
    ra_d = torch.clamp(ra_d, max=n_d - 1)

    def apply_d():
        return bh._tile_apply(dpos[ra_d], pay_d[ra_d], bulk_d[ra_d],
                              cif_d[ra_d], b_par_d[ra_d], chain_d, g3k_d,
                              ts_d, orig_d, corner_d, size_d, deep_d, rad_d,
                              eps, tk_d, tt_d, tc_d)

    say("deep", f"deep-path targets {n_bpar} ({100 * n_bpar / n_d:.2f}% of "
        f"N), refined by the tiles {n_ref} ({100 * n_ref / n_d:.2f}%), deep "
        f"rows {n_need} (cap {bh._deep_rows_cap(n_d)}), tile sources "
        f"{n_src} (cap {s_cap_d}: {'compacted' if compact_src else 'all rows'}"
        f"), halo sources on an edge {n_edge} against the halo cap "
        f"{halo_cap} of {m_rows} rows ({max(0, n_edge - halo_cap)} dropped)")
    require(n_bpar > 0 and n_ref > 0, "the deep chain selected no target")

    nacc_d = bucket_stencil(*bk_d.grid, counts=bk_d.counts, rr=rr_d,
                            eps_sq=eps, center_rows=res_d)
    eval_d = lambda: bh.bh_accelerations(dpos, dmass, dcfg)  # noqa: E731
    deval_ms = time_ms(eval_d, 5, warmup=2)
    dstages = {
        "couplings: extraction": time_ms(
            lambda: bh._extract_heavy_outliers(dpos, dmass), 5),
        "couplings: heavy": time_ms(lambda: bh.heavy_coupling(
            dpos, ext_d["h_pos"], ext_d["h_mass"], eps, gc), 5),
        "couplings: K1 outliers <- all": time_ms(
            lambda: allpairs_accelerations(
                opos_d, None, eps_sq=eps, g_const=gc, src_pos=dpos,
                src_mass=k1_src_d), 10),
        "couplings: K4 bulk <- outliers": time_ms(
            lambda: allpairs_accelerations_wide(
                dpos, opos_d, k4_src_d, eps_sq=eps, g_const=gc), 10),
        f"pyramid (synthesized, to level {deep_d})": time_ms(
            lambda: bh._build_pyramid(bulk_d, tm_d, deep_d,
                                      synth_quad=True), 5),
        f"M2L levels 2-{deep_d}": sum(time_ms(
            lambda: bh._m2l_level(grids_d[lv], corner_d, size_d, eps, rad_d),
            3) for lv in range(2, deep_d + 1)),
        f"L2L to level {deep_d}": time_ms(l2l_d, 3),
        "L2P (bucket level)": time_ms(lambda: bh._l2p_eval(
            lbucket_d, ci_d, dpos, corner_d, size_d, lv_d), 5),
        "bucket gather": time_ms(lambda: bh._bucket_gather(
            bk_d, nacc_d, res_d, dcap_), 5),
        "sort and bucket scatter": time_ms(lambda: bh._bucket_grid(
            dpos, tm_d, ci_d, flatnf_d, res_d, dcap_, rr_d), 5),
        "K3 near field": time_ms(lambda: bucket_stencil(
            *bk_d.grid, counts=bk_d.counts, rr=rr_d, eps_sq=eps,
            center_rows=res_d), 20),
        "deep targets": time_ms(lambda: bh._deep_targets(
            flatnf_d, flat_d, ext_d["is_out"], res_d, dcap_, rad_d), 5),
        "ring fold": time_ms(lambda: bh._fold_aggregate_ring(
            ldeep_d, wring_d, corner_d, size_d, 1 << deep_d, eps, rad_d, 0,
            1 << deep_d), 3),
        "deep rows (L2P + 3x3 aggregates)": time_ms(deep_rows_d, 5),
        "tile select": time_ms(lambda: bh._tile_select(
            cif_d, b_par_d, deep_d, tt_d, tc_d, rad_d), 5),
        "tile scatter": time_ms(lambda: bh._tile_scatter(
            *sc_args, ts_d, orig_d, *geo_d, **sc_kw), 5),
        "tile chain": time_ms(lambda: bh._tile_chain(
            lw_d, g3k_d, orig_d, corner_d, size_d, deep_d, rad_d, eps, tk_d,
            tt_d, tc_d), 3),
        "tile apply": time_ms(apply_d, 5),
    }
    say("deep", f"eval N={n_d} disc: {deval_ms:.4f} ms through the kernels "
        f"(CUDA events, 5 evals after 2)")
    for name, ms in dstages.items():
        say("deep", f"  stage {name}: {ms:.4f} ms "
            f"({100 * ms / deval_ms:.1f}% of the eval)")
    say("deep", f"  stages sum to {sum(dstages.values()):.4f} ms against "
        f"the eval's {deval_ms:.4f}")
    drows, dbusy_ms = device_profile(lambda: [eval_d() for _ in range(3)], 3)
    if drows:
        say("deep", f"eval device busy {dbusy_ms:.4f} ms per eval "
            f"(torch.profiler, {3 * drows:.0f} device rows over 3 evals): "
            f"the device idles {100 * (1 - dbusy_ms / deval_ms):.1f}% of "
            f"the unprofiled {deval_ms:.4f} ms")
    else:
        say("deep", "eval device busy: not measured (the profiler recorded "
            "no device rows)")

    # Through the kernels against the plain route (the M2L kernel runs on
    # both; m2l2_level below holds it to its plain version). index_add_'s
    # atomics vary the pyramid's last bits from run to run, and the
    # synthesized quadrupoles amplify them in the tile chain; with
    # deterministic algorithms on, index_add_ sums in a fixed order, so both
    # routes see the same pyramid and differ only by K1, K3 and K4.
    a_dk = eval_d()
    a_dp, dplain_ms = timed(lambda: bh.bh_accelerations(
        dpos, dmass, dcfg, use_kernels=False))
    noise = float((eval_d() - a_dk).abs().max())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            a_dk_det = eval_d()
            a_dp_det = bh.bh_accelerations(dpos, dmass, dcfg,
                                           use_kernels=False)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    derr = float((a_dk_det - a_dp_det).abs().max())
    dscale = float(a_dp_det.abs().max())
    ok = (bool(torch.isfinite(a_dk).all()) and bool(torch.isfinite(a_dp).all())
          and derr <= 1e-5 * dscale)
    say("deep", f"eval kernels vs plain route (deterministic index_add_): "
        f"max_abs_err={derr:.3e} max|a|={dscale:.3e} tol={1e-5 * dscale:.3e} "
        f"{'ok' if ok else 'FAIL'}; without it, two evals through the "
        f"kernels differ by {noise:.3e} and the routes by "
        f"{float((a_dk - a_dp).abs().max()):.3e}; the plain route took "
        f"{dplain_ms:.4f} ms")
    require(ok, "deep eval through the kernels disagrees with the plain "
            "route")
    del a_dk_det, a_dp_det, a_dp
    rows_d = torch.randperm(n_d, generator=gen, device=dev)[:4096]
    exact_d = allpairs_accelerations(dpos[rows_d], None, eps_sq=eps,
                                     g_const=gc, src_pos=dpos,
                                     src_mass=dmass)
    rel_d = ((a_dk[rows_d] - exact_d).norm(dim=1)
             / (exact_d.norm(dim=1) + 1e-12))
    on_path = b_par_d[rows_d]
    off = rel_d[~on_path]
    med_off = float(off.median())
    on_rel = rel_d[on_path].sort().values
    amax_on = float(a_dk[rows_d][on_path].norm(dim=1).max()) if len(
        on_rel) else 0.0
    emax = float(exact_d.norm(dim=1).max())
    ok = med_off < 2e-2 and amax_on < 10.0 * emax
    say("deep", f"vs exact K1 on 4096 rows: {int((~on_path).sum())} rows "
        f"off the deep path, median relative error {med_off:.4e} (bound "
        f"< 2e-2); {len(on_rel)} deep-path rows, median "
        + (f"{float(on_rel[len(on_rel) // 2]):.4e}, 99th percentile "
           f"{float(on_rel[int(0.99 * (len(on_rel) - 1))]):.4e}"
           if len(on_rel) else "none")
        + f", max|a| {amax_on:.4e} against the exact {emax:.4e} (bound < "
        f"10x) {'ok' if ok else 'FAIL'}")
    require(ok, "deep eval too far from the exact forces")
    del a_dk, exact_d
    # The M2L kernel at the eval's two finest levels (the deep chain's
    # 2048^2 and 1024^2 on the synthesized pyramid).
    for v in (deep_d, deep_d - 1):
        m2l2_level("deep", "N=1M disc", grids_d, corner_d, size_d, eps,
                   rad_d, v)

    # The main path: 1 warm-up step, then run(5).
    dsim.run(1)
    torch.cuda.synchronize()
    for c in counted + (bucket_stencil3, km2.m2l2):
        c.launches = 0
    start.record()
    dsim.run(5)
    end.record()
    torch.cuda.synchronize()
    d_launches = {"K1": allpairs_accelerations.launches,
                  "K2": allpairs_collision_deltas.launches,
                  "K3": bucket_stencil.launches,
                  "K4": allpairs_accelerations_wide.launches,
                  "K5": rect_pair_deltas.launches,
                  "K6": block_collision_deltas.launches,
                  "K7": bucket_stencil3.launches,
                  "M2": km2.m2l2.launches}
    d_steps_per_s = 5 / (start.elapsed_time(end) / 1e3)
    say("deep", f"launches during run(5) of the N={n_d} disc: {d_launches}; "
        f"{d_steps_per_s:.4f} steps/s (CUDA events, after 1 warm-up step)")
    require(d_launches["K1"] == d_launches["K3"] == d_launches["K4"] == 5
            and d_launches["K7"] == 0
            and d_launches["M2"] == 5 * m2l2_per_eval(dcfg, n_d) == 5 * 13,
            f"disc kernel launches {d_launches}: expected K1, K3 and K4 "
            f"once per step, the M2L kernel 13 times a step (levels "
            f"2-{lv_d}, deep {lv_d + 1}-{deep_d}, {tk_d} tile sub-levels)")
    require(dsim.frame == 6, f"frame {dsim.frame}, expected 6")
    for name in ("pos", "vel", "acc"):
        require(bool(torch.isfinite(getattr(dsim.state, name)).all()),
                f"disc deep path: non-finite {name}")

    # K1, K3 and K4 at the deep path's shapes: against the plain versions,
    # timed, bounded.
    k1_deep_err = rect_case(
        f"K1 deep chain outliers <- all [{opos_d.shape[0]} x {n_d}]",
        lambda t, sp, sm: allpairs_accelerations(
            t, None, eps_sq=eps, g_const=gc, src_pos=sp, src_mass=sm),
        opos_d, dpos, k1_src_d)
    k4_deep_err = rect_case(
        f"K4 deep chain bulk <- outliers [{n_d} x {opos_d.shape[0]}]",
        lambda t, sp, sm: allpairs_accelerations_wide(
            t, sp, sm, eps_sq=eps, g_const=gc), dpos, opos_d, k4_src_d)
    k3_deep_err = near_case("deep", f"the N=1M disc's grid {res_d}x{res_d}x"
                            f"{dcap_}, rr={rr_d}", bk_d.grid, bk_d.counts,
                            eps, res_d, rr_d)
    k3d_pairs, k3d_issued, _ = near_pairs(bk_d.counts, res_d, rr_d, dcap_)
    k3d_bytes = 4.0 * (3 * float(bk_d.counts.sum()) + bk_d.counts.numel()
                       + 2 * res_d * res_d * dcap_)
    nout_d = opos_d.shape[0]
    deep_k = {
        "K1": (dstages["couplings: K1 outliers <- all"], time_ms(
            lambda: allpairs_accelerations_plain(
                opos_d, None, eps_sq=eps, g_const=gc, src_pos=dpos,
                src_mass=k1_src_d), 2),
               *pair_bound(float(n_d) * nout_d,
                           4.0 * (3 * n_d + 4 * nout_d))),
        "K3": (dstages["K3 near field"], time_ms(
            lambda: bucket_stencil_plain(*bk_d.grid, rr_d, eps, res_d), 2),
               *pair_bound(k3d_pairs, k3d_bytes)),
        "K4": (dstages["couplings: K4 bulk <- outliers"], time_ms(
            lambda: allpairs_accelerations_plain(
                dpos, None, eps_sq=eps, g_const=gc, src_pos=opos_d,
                src_mass=k4_src_d), 2),
               *pair_bound(float(n_d) * nout_d,
                           4.0 * (2 * n_d * 2 + 3 * nout_d))),
    }
    say("deep", f"K3 on the disc's grid: {k3d_pairs:.4e} occupied pairs "
        f"needed, {k3d_issued:.4e} lane-pairs issued (a model estimate)")
    for name, (ms, plain_ms_, bnd, by) in deep_k.items():
        say("deep", f"{name} at the deep path's shape: kernel {ms:.4f} ms, "
            f"plain {plain_ms_:.4f} ms, bound {bnd:.4f} ms ({by})")
    disc1m = (dsim.state, dcfg)   # phase 12 renders it
    del dsim, bk_d, nacc_d, grids_d, terms_d, lbucket_d, ldeep_d, lagg_d
    del chain_d
    say("deep", f"phase 10 took {time.perf_counter() - t_phase10:.1f} s")

    # -- 11. deep3d -----------------------------------------------------------
    # Clustered 3D scenes at N = 1M under 'auto': the 3D deep-overflow chain
    # with its tiles; the dense near field (K7) on the Plummer sphere and the
    # clustered blob, the sparse near field on the 3D galaxy merger.
    t_phase11 = time.perf_counter()
    n_p = 1 << 20
    m2l3_rows = {}

    def m2l3_level(label, g10, corner, size, rad, v):
        """The M2L kernel at level v of the eval's pyramid: against its
        plain version (each term within 1e-5 of its max |value|), timed,
        bounded by its useful multiply-adds (r^3 x the V-list's sources x
        130) and its bytes (10 channels in, 19 terms out), beside the plain
        route (cuDNN in full f32) as the library's time."""
        r = 1 << v
        args = (bh3._channel_stack3(g10), corner, size, r, eps, rad)
        kw = dict(row0=0, rows=r, x0=0)
        got = km3.m2l3(*args, **kw)
        ref = km3.m2l3_plain(*args, **kw)
        worst = max(float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(got, ref))
        del got, ref
        ms = time_ms(lambda: km3.m2l3(*args, **kw), 5)
        lib_ms = time_ms(lambda: km3.m2l3_plain(*args, **kw), 2)
        sources = len(bh._m2l_conv_taps(rad, rad, 3)[0]) // 8
        fma = float(r) ** 3 * sources * 130
        bnd = bound(4.0 * r ** 3 * (10 + 19), 2.0 * fma)
        say("deep3d", f"M2L kernel, {label} level {v} ({r}^3, R={rad}): "
            f"worst term error {worst:.3e} of its max (tol 1e-5); kernel "
            f"{ms:.4f} ms, {fma / ms / 1e9:.4e} useful FMA/s, "
            f"{100 * bnd[0] / ms:.1f}% of its bound {bnd[0]:.4f} ms "
            f"({bnd[1]}); plain route (cuDNN, full f32) {lib_ms:.4f} ms")
        require(worst <= 1e-5, f"M2L kernel at {r}^3 disagrees with its "
                f"plain version: {worst:.3e}")
        return worst, ms, lib_ms, bnd

    def deep3_scene(label, sim, sparse):
        """Resolution, shares, one eval timed whole and by stage (device busy
        ms, idle share, peak memory), the kernels' route against the plain
        one and against exact K1 forces. Returns the eval's intermediates
        that the kernel checks use."""
        cfg = sim.config
        pos, mass = sim.state.pos, sim.state.mass
        lv = bh3._resolve_levels3(cfg, n_p)
        dp = bh3._resolve_deep_levels3(cfg, lv)
        rad = bh3._resolve_radius3(cfg)
        tk, tt, tc = bh3._resolve_tile_params3(cfg, dp, rad)
        over = bh3.bh3_near_overflow(pos, mass, cfg)
        tier = bh3.bh3_bucket_tier_count(pos, mass, cfg)
        say("deep3d", f"{label} N={n_p} under auto: force_backend "
            f"{cfg.force_backend}, bh_deep_levels {cfg.bh_deep_levels} "
            f"(levels {lv}, deep {dp}, R {rad}), tiles (k, t, T) = "
            f"{(tk, tt, tc)}, bh_nf_sparse {cfg.bh_nf_sparse}, collisions "
            f"{cfg.collision_broad_phase}; bucket overflow {over} "
            f"({100 * over / n_p:.2f}% of N), bucket-tier targets {tier}")
        require(cfg.force_backend == "bh" and cfg.bh_deep_levels == -1
                and (lv, dp, rad, (tk, tt, tc)) == (6, 8, 2, (3, 8, 8))
                and cfg.bh_nf_sparse == int(sparse),
                f"{label} did not resolve to the deep chain (levels 6, deep "
                f"8, tiles (3, 8, 8), bh_nf_sparse {int(sparse)})")
        eval_ = lambda: bh3.bh3_accelerations(pos, mass, cfg)  # noqa: E731
        eval_()
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eval_()
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        ev_ms = time_ms(eval_, 3, warmup=0)
        rows_, busy = device_profile(lambda: [eval_() for _ in range(2)], 2)
        say("deep3d", f"{label} eval: {ev_ms:.4f} ms through the kernels "
            f"(CUDA events, 3 evals after 2); peak memory of one eval "
            f"{peak_gb:.3f} GB above the {base_mem / 1e9:.3f} GB held; "
            + (f"device busy {busy:.4f} ms per eval (torch.profiler, "
               f"{2 * rows_:.0f} device rows over 2 evals): the device idles "
               f"{100 * (1 - busy / ev_ms):.1f}%" if rows_ else
               "device busy: not measured (no device rows)"))

        # The eval's intermediates, each stage timed alone on its own inputs
        # (as `_bh3_accelerations` and `_deep_chain3` compute them).
        rr_, res_ = rad - 1, 1 << lv
        ext = bh._extract_heavy_outliers(pos, mass)
        oi = ext["out_i"]
        opos_ = pos[oi]
        k1_src = torch.where(ext["is_heavy"], 0.0, mass)
        k4_src = torch.where(ext["out_sel"] & ~ext["is_heavy"][oi], mass[oi],
                             0.0)
        bulk, tm = ext["bulk_pos"], ext["tree_mass"]
        grids, corner, size, ci_f, _ = bh3._build_pyramid3(
            bulk, tm, dp, synth_quad=True)
        ci = ci_f >> (dp - lv)
        flat = (ci[:, 0] * res_ + ci[:, 1]) * res_ + ci[:, 2]
        flat_nf = bh._outlier_flat_ids(flat, ext["is_out"], res_ ** 3)
        terms = {v: bh3._m2l_level3(grids[v], corner, size, eps, rad)
                 for v in range(2, dp + 1)}

        def l2l(top):
            local = terms[2]
            for v in range(3, top + 1):
                up = bh3._l2l_upsample3(local, size / (1 << v))
                local = tuple(u + t for u, t in zip(up, terms[v]))
            return local

        lbucket, ldeep = l2l(lv), l2l(dp)
        b_par, hot = bh3._deep_targets3(flat_nf, flat, ext["is_out"], res_,
                                        cap, rad)
        is_out = ext["is_out"]
        sparse_args = (pos, bulk, tm, ci, flat, hot, b_par, is_out, eps, gc,
                       rad)
        n_cand = int((~b_par & ~is_out).sum())
        n_src_nf = int((~hot[flat]).sum())
        bk = None
        if sparse:
            _, b_par = bh3._sparse_near_field3(*sparse_args)
        else:
            bk = bh._bucket_grid(pos, tm, ci, flat_nf, res_, cap, rr_)
        pay = bh3._moment_payload3(pos, tm)
        g4p = torch.nn.functional.pad(torch.stack(grids[dp][:4], -1),
                                      (0, 0) + (1,) * 6)
        tid, ts, orig = bh3._tile_select3(ci_f, b_par, dp, tt, tc, rad)
        cand = (ts[tid] < tc) & b_par
        need = b_par & ~cand
        n_bpar, n_ref, n_need = (int(b_par.sum()), int(cand.sum()),
                                 int(need.sum()))
        sd, _ = bh._compact_indices(need, bh3._deep_rows_cap3(n_p))
        sd = torch.clamp(sd, max=n_p - 1)

        def deep_rows():
            far = bh3._l2p_eval3(ldeep, ci_f[sd], pos[sd], corner, size, dp)
            near = bh3._deep_near_aggregates3(pos[sd], pay[sd, :4], g4p,
                                              ci_f[sd], eps, size / (1 << dp),
                                              rr=1)
            return far, near

        src = bh3._tile_src_mask3(ci_f, ts, dp, rad, tt, tc)
        s_cap = bh3._scatter_cap3(n_p)
        n_src = int(src.sum())
        compact = n_src <= s_cap < n_p
        ss, _ = bh._compact_indices(src, s_cap)
        valid_s = ss < n_p
        ss = torch.clamp(ss, max=n_p - 1)
        sc_args = ((torch.where(valid_s[:, None], pay[ss], 0.0), bulk[ss],
                    ci_f[ss]) if compact else (pay, bulk, ci_f))
        sc_kw = {"src_mask": valid_s} if compact else {}
        geo = (corner, size, dp, rad, tk, tt, tc)
        m_rows = sc_args[0].shape[0]
        cands = bh3._tile_candidates3(sc_args[2], ts, tt, tc, rad,
                                      (1 << dp) // tt)
        on_edge = cands[1][0]
        for ok_, _ in cands[2:]:
            on_edge = on_edge | ok_
        if compact:
            on_edge = on_edge & valid_s
        n_edge, halo = int(on_edge.sum()), bh._halo_cap(m_rows)
        g4k = bh3._tile_scatter3(*sc_args, ts, orig, *geo, **sc_kw)
        lw = bh3._tile_windows3(ldeep, orig, tt, rad)
        chain = bh3._tile_chain3(lw, g4k, orig, corner, size, dp, rad, eps,
                                 tk, tt, tc)
        ra, _ = bh._compact_indices(cand, bh3._refined_cap3(n_p))
        ra = torch.clamp(ra, max=n_p - 1)

        def apply_():
            return bh3._tile_apply3(pos[ra], pay[ra], bulk[ra], ci_f[ra],
                                    b_par[ra], chain, g4k, ts, orig, corner,
                                    size, dp, rad, eps, tk, tt, tc)

        say("deep3d", f"{label}: deep-path targets {n_bpar} "
            f"({100 * n_bpar / n_p:.2f}% of N), refined by the tiles {n_ref} "
            f"({100 * n_ref / n_p:.2f}%), deep rows {n_need} (cap "
            f"{bh3._deep_rows_cap3(n_p)}), tile sources {n_src} (cap {s_cap}: "
            f"{'compacted' if compact else 'all rows'}), halo sources on an "
            f"edge {n_edge} against the halo cap {halo} of {m_rows} rows "
            f"({max(0, n_edge - halo)} dropped)"
            + (f"; sparse near field: {min(n_cand, bh3._nf_sparse_cap(n_p))} "
               f"valid target rows of {n_cand} bucket-tier targets (cap "
               f"{bh3._nf_sparse_cap(n_p)}), {n_src_nf} non-hot-cell "
               f"sources (cap {bh3._nf_sparse_src_cap(n_p)})"
               if sparse else ""))
        require(n_bpar > 0 and n_ref > 0, f"{label}: the deep chain selected "
                f"no target")
        stages = {
            "couplings: extraction": time_ms(
                lambda: bh._extract_heavy_outliers(pos, mass), 3),
            "couplings: heavy": time_ms(lambda: bh.heavy_coupling(
                pos, ext["h_pos"], ext["h_mass"], eps, gc), 3),
            "couplings: K1 outliers <- all": time_ms(
                lambda: allpairs_accelerations(
                    opos_, None, eps_sq=eps, g_const=gc, src_pos=pos,
                    src_mass=k1_src), 5),
            "couplings: K4 bulk <- outliers": time_ms(
                lambda: allpairs_accelerations_wide(
                    pos, opos_, k4_src, eps_sq=eps, g_const=gc), 5),
            f"pyramid (synthesized, to level {dp})": time_ms(
                lambda: bh3._build_pyramid3(bulk, tm, dp, synth_quad=True),
                2),
        }
        for v in range(2, dp + 1):
            stages[f"M2L level {v} ({1 << v}^3)"] = time_ms(
                lambda: bh3._m2l_level3(grids[v], corner, size, eps, rad), 2)
        stages.update({
            f"L2L to level {dp}": time_ms(lambda: l2l(dp), 2),
            "L2P (bucket level)": time_ms(lambda: bh3._l2p_eval3(
                lbucket, ci, pos, corner, size, lv), 3),
            "deep targets": time_ms(lambda: bh3._deep_targets3(
                flat_nf, flat, is_out, res_, cap, rad), 3),
        })
        if sparse:
            stages["sparse near field"] = time_ms(
                lambda: bh3._sparse_near_field3(*sparse_args), 3)
        else:
            nacc = bucket_stencil3(*bk.grid, counts=bk.counts, rr=rr_,
                                   eps_sq=eps, center_rows=res_)
            stages.update({
                "sort and bucket scatter": time_ms(lambda: bh._bucket_grid(
                    pos, tm, ci, flat_nf, res_, cap, rr_), 3),
                "K7 near field": time_ms(lambda: bucket_stencil3(
                    *bk.grid, counts=bk.counts, rr=rr_, eps_sq=eps,
                    center_rows=res_), 10),
                "bucket gather": time_ms(
                    lambda: bh._bucket_gather(bk, nacc, res_, cap), 3),
            })
        stages.update({
            "deep rows (L2P + 27 aggregates)": time_ms(deep_rows, 2),
            "tile select": time_ms(lambda: bh3._tile_select3(
                ci_f, b_par, dp, tt, tc, rad), 3),
            "tile windows": time_ms(lambda: bh3._tile_windows3(
                ldeep, orig, tt, rad), 3),
            "tile scatter": time_ms(lambda: bh3._tile_scatter3(
                *sc_args, ts, orig, *geo, **sc_kw), 3),
            "tile chain": time_ms(lambda: bh3._tile_chain3(
                lw, g4k, orig, corner, size, dp, rad, eps, tk, tt, tc), 2),
            "tile apply": time_ms(apply_, 2),
        })
        for name, ms in stages.items():
            say("deep3d", f"  {label} stage {name}: {ms:.4f} ms "
                f"({100 * ms / ev_ms:.1f}% of the eval)")
        say("deep3d", f"  {label} stages sum to {sum(stages.values()):.4f} ms "
            f"against the eval's {ev_ms:.4f}")
        if not sparse:
            for v in (dp, dp - 1):
                m2l3_rows[v] = m2l3_level(label, grids[v], corner, size,
                                          rad, v)
        if not sparse:
            # Not on this path: the sparse near field on these inputs, the
            # plain cell-masked pairwise pass at its 16384-target cap.
            n_tgt_nf = min(n_cand, bh3._nf_sparse_cap(n_p))
            n_src_used = (n_src_nf if n_src_nf <= bh3._nf_sparse_src_cap(n_p)
                          else n_p)
            nf_ms = time_ms(lambda: bh3._sparse_near_field3(*sparse_args),
                            1)
            say("deep3d", f"  {label}: the sparse near field (not on this "
                f"path) on its {n_tgt_nf} target rows x {n_src_used} "
                f"sources: {nf_ms:.4f} ms")

        # Through the kernels against the plain route, index_add_
        # deterministic (as in phase 10).
        a_k = eval_()
        a_p, plain_ms_ = timed(lambda: bh3.bh3_accelerations(
            pos, mass, cfg, use_kernels=False))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                a_kd = eval_()
                a_pd = bh3.bh3_accelerations(pos, mass, cfg,
                                             use_kernels=False)
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        err = float((a_kd - a_pd).abs().max())
        scale = float(a_pd.abs().max())
        ok = (bool(torch.isfinite(a_k).all())
              and bool(torch.isfinite(a_p).all()) and err <= 1e-5 * scale)
        say("deep3d", f"{label} eval kernels vs plain route (deterministic "
            f"index_add_): max_abs_err={err:.3e} max|a|={scale:.3e} "
            f"tol={1e-5 * scale:.3e} {'ok' if ok else 'FAIL'}; without it the "
            f"routes differ by {float((a_k - a_p).abs().max()):.3e}; the "
            f"plain route took {plain_ms_:.4f} ms")
        require(ok, f"{label} deep eval through the kernels disagrees with "
                f"the plain route")
        del a_kd, a_pd, a_p
        rows = torch.randperm(n_p, generator=gen, device=dev)[:4096]
        exact = allpairs_accelerations(pos[rows], None, eps_sq=eps,
                                       g_const=gc, src_pos=pos,
                                       src_mass=mass)
        rel = ((a_k[rows] - exact).norm(dim=1)
               / (exact.norm(dim=1) + 1e-12))
        on = b_par[rows]
        off = rel[~on].sort().values
        on_rel = rel[on].sort().values
        med_off = float(off[len(off) // 2]) if len(off) else 0.0
        amax_on = float(a_k[rows][on].norm(dim=1).max()) if len(
            on_rel) else 0.0
        emax = float(exact.norm(dim=1).max())
        ok = med_off < 3e-2 and amax_on < 10.0 * emax
        say("deep3d", f"{label} vs exact K1 on 4096 rows: {len(off)} rows off "
            f"the deep path, median relative error "
            + (f"{med_off:.4e}" if len(off) else "none")
            + f" (bound < 3e-2); {len(on_rel)} deep-path rows, median "
            + (f"{float(on_rel[len(on_rel) // 2]):.4e}, 99th percentile "
               f"{float(on_rel[int(0.99 * (len(on_rel) - 1))]):.4e}"
               if len(on_rel) else "none")
            + f", max|a| {amax_on:.4e} against the exact {emax:.4e} (bound "
            f"< 10x) {'ok' if ok else 'FAIL'}")
        require(ok, f"{label} deep eval too far from the exact forces")
        # K1, K4 and K7 at the deep path's shapes: against the plain
        # versions, timed, bounded.
        nout = opos_.shape[0]
        errs = {
            "K1": rect_case(
                f"K1 3D deep chain ({label}) outliers <- all "
                f"[{nout} x {n_p}]",
                lambda t, sp, sm: allpairs_accelerations(
                    t, None, eps_sq=eps, g_const=gc, src_pos=sp,
                    src_mass=sm), opos_, pos, k1_src),
            "K4": rect_case(
                f"K4 3D deep chain ({label}) bulk <- outliers "
                f"[{n_p} x {nout}]",
                lambda t, sp, sm: allpairs_accelerations_wide(
                    t, sp, sm, eps_sq=eps, g_const=gc), pos, opos_, k4_src),
        }
        kern = {
            "K1": (stages["couplings: K1 outliers <- all"], time_ms(
                lambda: allpairs_accelerations_plain(
                    opos_, None, eps_sq=eps, g_const=gc, src_pos=pos,
                    src_mass=k1_src), 2),
                   *pair_bound3(float(n_p) * nout,
                                4.0 * (4 * n_p + 6 * nout))),
            "K4": (stages["couplings: K4 bulk <- outliers"], time_ms(
                lambda: allpairs_accelerations_plain(
                    pos, None, eps_sq=eps, g_const=gc, src_pos=opos_,
                    src_mass=k4_src), 2),
                   *pair_bound3(float(n_p) * nout,
                                4.0 * (6 * n_p + 4 * nout))),
        }
        if not sparse:
            errs["K7"] = near_case(
                "deep3d", f"the N=1M {label}'s grid {res_}^3 x {cap}, "
                f"rr={rr_}", bk.grid, bk.counts, eps, res_, rr_)
            pairs, issued, _ = near_pairs(bk.counts, res_, rr_, cap)
            nbytes = 4.0 * (4 * float(bk.counts.sum()) + bk.counts.numel()
                            + 3 * res_ ** 3 * cap)
            kern["K7"] = (stages["K7 near field"], time_ms(
                lambda: bucket_stencil3_plain(*bk.grid, rr_, eps, res_), 2),
                *pair_bound3(pairs, nbytes))
            say("deep3d", f"K7 on the {label}'s grid: {pairs:.4e} occupied "
                f"pairs needed, {issued:.4e} lane-pairs issued (a model "
                f"estimate)")
        for name, (ms, plain_ms_, bnd, by) in kern.items():
            say("deep3d", f"{name} at the 3D deep path's shape ({label}): "
                f"kernel {ms:.4f} ms, plain {plain_ms_:.4f} ms, bound "
                f"{bnd:.4f} ms ({by})")
        del a_k, exact, terms, lbucket, chain, g4k, grids, bk
        return errs, kern

    def deep3_run(label, sim, k7_per_step, m2l_per_step):
        sim.run(1)
        torch.cuda.synchronize()
        for c in counted + (bucket_stencil3, km3.m2l3):
            c.launches = 0
        start.record()
        sim.run(3)
        end.record()
        torch.cuda.synchronize()
        got = {"K1": allpairs_accelerations.launches,
               "K4": allpairs_accelerations_wide.launches,
               "K7": bucket_stencil3.launches,
               "K5": rect_pair_deltas.launches,
               "K6": block_collision_deltas.launches,
               "M2L": km3.m2l3.launches}
        sps = 3 / (start.elapsed_time(end) / 1e3)
        say("deep3d", f"launches during run(3) of the {label}: {got}; "
            f"{sps:.4f} steps/s (CUDA events, after 1 warm-up step)")
        require(got["K1"] == got["K4"] == 3 and got["K7"] == 3 * k7_per_step
                and got["M2L"] == 3 * m2l_per_step,
                f"{label} kernel launches {got}: expected K1 and K4 once per "
                f"step, K7 {k7_per_step} and the M2L kernel {m2l_per_step} "
                f"per step")
        require(sim.frame == 4, f"frame {sim.frame}, expected 4")
        for name in ("pos", "vel", "acc"):
            require(bool(torch.isfinite(getattr(sim.state, name)).all()),
                    f"{label} deep path: non-finite {name}")
        return got

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        psim = Simulation(SimConfig(n=n_p, dim=3), scene="plummer",
                          virialize=False)
    require(any("deep-overflow" in str(w.message) for w in caught),
            "the N=1M Plummer sphere resolved without the deep-overflow "
            "warning")
    pl_errs, deep3_k = deep3_scene("Plummer sphere", psim, sparse=False)
    # M2L levels a step: 2-6, deep 7-8, the tiles' 3 sub-levels.
    pl_launches = deep3_run("Plummer sphere", psim, 1, 10)
    del psim

    # The 3D galaxy merger: the sparse near field, no K7.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        msim3 = Simulation(SimConfig(n=n_p, dim=3), scene="galaxy_merger")
    require(any("deep-overflow" in str(w.message) for w in caught),
            "the N=1M 3D merger resolved without the deep-overflow warning")
    deep3_scene("3D merger", msim3, sparse=True)
    deep3_run("3D merger", msim3, 0, 10)
    del msim3

    # The clustered blob (scripts/bench3d_clustered.py's input), one eval:
    # the clustered N=1M blob workload of ROADMAP's "Workloads to record".
    from nbodysim_tpu_torch.scenes.blob import clustered_blob

    bpos, bmass = clustered_blob(n_p, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        bcfg = resolve_config_for_state(bpos, bmass, SimConfig(n=n_p, dim=3))
    blv = bh3._resolve_levels3(bcfg, n_p)
    bdp = bh3._resolve_deep_levels3(bcfg, blv)
    btiles = bh3._resolve_tile_params3(bcfg, bdp, bh3._resolve_radius3(bcfg))
    require((bcfg.force_backend, bcfg.bh_deep_levels, bcfg.bh_nf_sparse,
             bdp, btiles) == ("bh", -1, 0, 8, (3, 8, 8)),
            f"the blob resolved to {bcfg.force_backend}, deep "
            f"{bcfg.bh_deep_levels}, sparse {bcfg.bh_nf_sparse}")
    blob_eval = lambda: bh3.bh3_accelerations(bpos, bmass, bcfg)  # noqa
    blob_eval()
    blob_ms = time_ms(blob_eval, 3, warmup=1)
    a_b = blob_eval()
    rows_b = torch.randperm(n_p, generator=gen, device=dev)[:4096]
    exact_b = allpairs_accelerations(bpos[rows_b], None, eps_sq=eps,
                                     g_const=gc, src_pos=bpos, src_mass=bmass)
    rel_b = ((a_b[rows_b] - exact_b).norm(dim=1)
             / (exact_b.norm(dim=1) + 1e-12)).sort().values
    require(bool(torch.isfinite(a_b).all()), "blob eval: non-finite")
    say("deep3d", f"clustered blob N={n_p} (sigma 40 in +-30000) under auto: "
        f"deep {bdp}, tiles {btiles}, bucket overflow "
        f"{bh3.bh3_near_overflow(bpos, bmass, bcfg)}, bucket-tier targets "
        f"{bh3.bh3_bucket_tier_count(bpos, bmass, bcfg)}; one eval "
        f"{blob_ms:.4f} ms (CUDA events, 3 evals after 2); vs exact K1 on "
        f"4096 rows: median relative error {float(rel_b[2048]):.4e}, 99th "
        f"percentile {float(rel_b[4055]):.4e}")
    del a_b, bpos, bmass
    say("deep3d", f"phase 11 took {time.perf_counter() - t_phase11:.1f} s")

    # -- 12. surface ----------------------------------------------------------
    # The product surface through the entry points a user calls: the CLI,
    # checkpoints and resume, the hash broad phase, the renderer and
    # render_rollout, the bench and its presets, the drift gate, a trace.
    import contextlib
    import io

    from nbodysim_tpu_torch import bench as tbench
    from nbodysim_tpu_torch import cli
    from nbodysim_tpu_torch.diagnostics.profiling import trace
    from nbodysim_tpu_torch.render.splat import RenderConfig, render_frame
    from nbodysim_tpu_torch.render.video import (
        AsyncFrameWriter, render_rollout)

    t_phase12 = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "smoke12"
    if work.exists():
        import shutil
        shutil.rmtree(work)
    work.mkdir(parents=True)

    def captured(fn, *args):
        """Run fn(*args), echo its standard output with a phase tag, and
        return the output's lines."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(*args)
        lines = buf.getvalue().splitlines()
        for line in lines:
            say("surface", f"| {line}")
        return lines

    info = captured(cli.main, ["info"])
    require(any(line == f"name: {torch.cuda.get_device_name(0)}"
                for line in info), "cli info did not name the card")

    # cli run at N=25k: 200 steps uninterrupted, then resumed from step 100.
    run_args = ["run", "--scene", "uniform_disc", "--n", "25000",
                "--log-every", "50", "--checkpoint-every", "100"]
    for c in (allpairs_accelerations, allpairs_collision_deltas):
        c.launches = 0
    t0 = time.perf_counter()
    hud = captured(cli.main, run_args + [
        "--steps", "200", "--checkpoint-dir", str(work / "a")])
    cli_s = time.perf_counter() - t0
    cli_launches = {"K1": allpairs_accelerations.launches,
                    "K2": allpairs_collision_deltas.launches}
    hud_sps = float(hud[-2 if "checkpoint" in hud[-1] else -1]
                    .split("|")[-1].split()[0])
    require(cli_launches == {"K1": 200, "K2": 200},
            f"cli run launches {cli_launches}, expected 200 each")
    captured(cli.main, run_args + [
        "--steps", "200", "--checkpoint-dir", str(work / "b"),
        "--resume", str(work / "a" / "ckpt_0000100.npz")])
    import numpy as np
    with np.load(work / "a" / "ckpt_0000200.npz") as za, \
            np.load(work / "b" / "ckpt_0000200.npz") as zb:
        differ = [k for k in ("pos", "vel", "acc", "mass", "radius", "frame")
                  if not np.array_equal(za[k], zb[k])]
    say("surface", f"cli run N=25k, 200 steps: HUD {hud_sps:.1f} steps/s "
        f"(from the start, warm-up, diagnostics every 50 steps and "
        f"checkpoints included; {cli_s:.2f} s wall) against "
        f"Simulation.run's {steps_per_s:.1f} steps/s in phase 5; launches "
        f"{cli_launches}; resumed from step 100, ckpt_0000200 "
        f"{'equals the uninterrupted run bit for bit' if not differ else 'differs in ' + str(differ)}")
    require(not differ, f"the resumed run's checkpoint differs in {differ}")

    # The hash pass, explicit, on the N=1M mergers (2D and 3D): every K5
    # launch of one pass through the kernels, recorded with its operands;
    # the same pass through the plain versions, its calls timed.
    def hash_case(dim):
        st = init_scene("galaxy_merger", SimConfig(n=1 << 20, dim=dim))
        g = own_generator(120 + dim)
        st = st.replace(vel=st.vel + uniform(st.vel.shape, -5.0, 5.0, g))
        cfg = SimConfig(n=1 << 20, dim=dim, collision_broad_phase="hash")
        hg = coll._hash_grid(st.pos, st.radius, cfg)
        over = int((~hg.in_win & ~hg.big_s).sum())
        n_big = int(hg.bigs.big_sel.sum())
        calls = {"cuda": [], "torch": []}
        real = {"cuda": coll.rect_pair_deltas,
                "torch": coll.rect_pair_deltas_plain}

        def recorder(route):
            def call(tgt, src, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = real[route](tgt, src, **kw)
                torch.cuda.synchronize()
                calls[route].append((tgt, src, kw, out,
                                     1e3 * (time.perf_counter() - t)))
                return out
            return call

        coll.rect_pair_deltas = recorder("cuda")
        coll.rect_pair_deltas_plain = recorder("torch")
        try:
            rect_pair_deltas.launches = 0
            out = coll.resolve_collisions(st, cfg)
            torch.cuda.synchronize()
            k5_launched = rect_pair_deltas.launches
            ref = coll.resolve_collisions(
                st, cfg.replace(collision_backend="torch"))
            torch.cuda.synchronize()
        finally:
            coll.rect_pair_deltas = real["cuda"]
            coll.rect_pair_deltas_plain = real["torch"]
        vmax = max(float(ref.vel.abs().max()), 10.0)
        err = max(float((out.pos - ref.pos).abs().max()),
                  float((out.vel - ref.vel).abs().max()))
        p0 = (st.mass[:, None] * st.vel).sum(0)
        p1 = (st.mass[:, None] * out.vel).sum(0)
        mom = float((p1 - p0).abs().max()) / float(
            (st.mass[:, None] * st.vel.abs()).sum())
        pass_ms = time_ms(lambda: coll.resolve_collisions(st, cfg), 5, 2)
        require(len(calls["cuda"]) == len(calls["torch"]) == k5_launched
                == (4 if over else 2),
                f"hash pass {dim}D: K5 launches {k5_launched}, recorded "
                f"{len(calls['cuda'])} / {len(calls['torch'])}")
        require(err <= 1e-5 * vmax and mom <= 1e-5,
                f"hash pass {dim}D: kernels vs plain {err:.3e} (tol "
                f"{1e-5 * vmax:.3e}), momentum {mom:.3e}")
        k5 = {"ms": 0.0, "plain_ms": 0.0, "bound": 0.0, "err": 0.0,
              "bytes": 0.0, "ops": 0.0, "shapes": []}
        for (tgt, src, kw, got, _), (_, _, _, want, p_ms) in zip(
                calls["cuda"], calls["torch"]):
            rows_t, rows_s = tgt[0].shape[0], src[0].shape[0]
            k5["ms"] += time_ms(lambda: real["cuda"](tgt, src, **kw), 10)
            k5["plain_ms"] += p_ms
            k5["err"] = max(k5["err"], *(float((a - b).abs().max())
                                         for a, b in zip(got, want)))
            big, small = (tgt, src) if rows_t >= rows_s else (src, tgt)
            needed = k5_needed_pairs(big, small, kw["max_cheb"])
            cols = 2 * dim + 2 + (0 if kw["max_cheb"] is None else dim)
            k5["bytes"] += 4.0 * (cols * (rows_t + rows_s) + 2 * dim * rows_t)
            k5["ops"] += 7.0 * needed
            k5["shapes"].append(f"{rows_t}x{rows_s}")
        k5["bound"] = bound(k5["bytes"], k5["ops"])
        say("surface", f"hash pass, {dim}D merger N=1M (cell 600, window "
            f"16): overflow {over}, big bodies {n_big}; pass "
            f"{pass_ms:.2f} ms (CUDA events, 5 after 2); kernels vs plain "
            f"route {err:.3e} (tol {1e-5 * vmax:.3e}), momentum {mom:.3e} "
            f"of sum m|v|; K5 {k5_launched} launches "
            f"({', '.join(k5['shapes'])}): {k5['ms']:.4f} ms, plain "
            f"{k5['plain_ms']:.2f} ms, bound {k5['bound'][0]:.4f} ms "
            f"({k5['bound'][1]}), max err {k5['err']:.3e}")
        return k5_launched, k5, err, vmax

    hash_k5 = {dim: hash_case(dim) for dim in (2, 3)}

    # render_frame at 1200 x 900 on phase 10's N=1M disc (SimConfig() under
    # auto), in its three modes, on the card and against the CPU.
    rstate, rcfg = disc1m
    half_span = float(rstate.pos.abs().max())
    render_ms = {}
    for mode, kw in (("normal", {}),
                     ("performance", {"performance_mode": True}),
                     ("overlays", {"show_quadtree": True,
                                   "show_connections": True})):
        rc = RenderConfig(width=1200, height=900, scale=450.0 / half_span,
                          **kw)
        frame = render_frame(rstate, rc)
        cpu_frame = render_frame(rstate.to("cpu"), rc)
        off = (frame.cpu().int() - cpu_frame.int()).abs().amax(-1)
        flips = int((off > 1).sum())
        render_ms[mode] = time_ms(lambda: render_frame(rstate, rc), 5, 2)
        say("surface", f"render_frame 1200x900, N=1M disc, {mode}: "
            f"{render_ms[mode]:.3f} ms (CUDA events, 5 after 2); against "
            f"the CPU's frame: {int((off > 0).sum())} pixels differ, "
            f"{flips} by more than 1 (tol {int(0.001 * off.numel())})")
        require(frame.dtype == torch.uint8 and int(frame.max()) > 0
                and flips <= 0.001 * off.numel(),
                f"render_frame {mode}: {flips} pixels off by more than 1")
    rc = RenderConfig(width=1200, height=900, scale=450.0 / half_span)
    from nbodysim_tpu_torch.render.overlays import (
        connections_overlay, quadtree_overlay)
    base = render_frame(rstate, rc)
    quad_ms, conn_ms = (
        time_ms(lambda: fn(base, rstate, rc.scale, rc.center), 5, 2)
        for fn in (quadtree_overlay, connections_overlay))
    say("surface", f"overlays alone on that frame: quadtree {quad_ms:.3f} "
        f"ms, connections (cluster mode) {conn_ms:.3f} ms")
    sink = []
    writer = AsyncFrameWriter(lambda i, f: sink.append((i, f.shape)))
    for c in (allpairs_accelerations, allpairs_accelerations_wide,
              bucket_stencil, km2.m2l2):
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, f in enumerate(render_rollout(rstate, rcfg, 10, 1,
                                             rc)):
            writer.submit(i, f)
    writer.close()
    fps = 10 / (time.perf_counter() - t0)
    ro_launches = {"K1": allpairs_accelerations.launches,
                   "K4": allpairs_accelerations_wide.launches,
                   "K3": bucket_stencil.launches,
                   "M2": km2.m2l2.launches}
    ro_m2 = m2l2_per_eval(rcfg, rstate.pos.shape[0])
    say("surface", f"render_rollout N=1M disc, 10 frames of 1 step "
        f"(AsyncFrameWriter, numpy sink): {fps:.3f} frames/s (host clock, "
        f"probes and priming included); launches {ro_launches}")
    require(sink == [(i, (900, 1200, 3)) for i in range(10)]
            and ro_launches["K1"] >= 9
            and ro_launches["M2"] == ro_m2 * ro_launches["K3"],
            f"render_rollout frames {sink[:2]}..., launches {ro_launches}")

    # The bench: the default run, then BASELINE configs 1, 2 and 5.
    bench_lines = {}
    for argv in ([], ["--config", "1"], ["--config", "2"],
                 ["--config", "5"]):
        t0 = time.perf_counter()
        lines = captured(tbench.main, argv)
        rows = [json.loads(x) for x in lines]
        require(rows[0]["device"] == torch.cuda.get_device_name(0)
                and all(r["value"] is not None and math.isfinite(r["value"])
                        for r in rows[1:]),
                f"bench {argv} printed {rows}")
        for r in rows[1:]:
            bench_lines[r["metric"]] = r["value"]
        say("surface", f"bench {' '.join(argv) or '(default)'}: "
            f"{time.perf_counter() - t0:.1f} s")
    drift = tbench.drift_gate(dev)
    say("surface", f"drift gate (Plummer N=4096, leapfrog, dt 0.5, "
        f"softening 10, 10,000 steps in chunks of 500, K1): worst |dE/E| "
        f"{drift['value']:.3e} against 1e-4")
    require(drift["passed"], f"drift gate: worst |dE/E| {drift['value']:.3e}"
            f" > 1e-4")

    # A trace of 3 steps of the N=25k main path.
    tsim = Simulation(SimConfig(n=25_000), scene="uniform_disc")
    tsim.run(1)
    with trace(str(work / "trace")):
        tsim.run(3)
    tfiles = list((work / "trace").glob("trace_*.json"))
    events = json.loads(tfiles[0].read_text())["traceEvents"] if tfiles \
        else []
    kernels_traced = sum(1 for e in events if e.get("cat") == "kernel")
    say("surface", f"profiling.trace around 3 steps: {len(tfiles)} file(s), "
        f"{len(events)} events, {kernels_traced} device kernel events")
    require(tfiles and kernels_traced >= 6,
            f"trace wrote {tfiles}, {kernels_traced} kernel events")
    say("surface", f"phase 12 took {time.perf_counter() - t_phase12:.1f} s")


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
        entry("K1 allpairs_accelerations (N=1M merger, 1M x 1M; plain_ms "
              "for 4096 of the rows)", allpairs_cu,
              "nbodysim_tpu/kernels/allpairs.py:56", merger_launches["K1"],
              k1_merger_err, k1_merger_ms, k1_rows_plain_ms,
              pair_bound(float(n_m) * n_m, 4.0 * n_m * (3 + 2))),
        entry("potential allpairs_potential (N=25k HUD; launches: one "
              "diagnostics() call)", allpairs_cu,
              "none (the port adds it; nbodysim_tpu/physics/forces.py:158 "
              "sums the potential in plain XLA)", pot_launches, pot_err,
              pot_ms, pot_plain_ms, pot_bound),
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
        entry("K6 block_collision_deltas (3D merger N=1M under auto; "
              "launches: one pass)",
              "nbodysim_tpu_torch/csrc/collide_block.cu",
              "nbodysim_tpu/kernels/collide_block.py:47",
              pass3m_launches["K6"], k6_3d_err, k6_3d_ms,
              plain_ms[k6_3d_name], k6_3d_bnd),
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
        entry(f"K1 allpairs_accelerations (deep chain, N=1M disc: "
              f"{nout_d} outliers <- 1M)", allpairs_cu,
              "nbodysim_tpu/kernels/allpairs.py:56", d_launches["K1"],
              k1_deep_err, *deep_k["K1"][:2], deep_k["K1"][2:]),
        entry(f"K3 bucket_stencil (deep chain, N=1M disc: {res_d}^2 x "
              f"{dcap_}, rr={rr_d})", "nbodysim_tpu_torch/csrc/nearfield.cu",
              "nbodysim_tpu/kernels/nearfield.py:49", d_launches["K3"],
              k3_deep_err, *deep_k["K3"][:2], deep_k["K3"][2:]),
        entry(f"K4 allpairs_accelerations_wide (deep chain, N=1M disc: 1M x "
              f"{nout_d})", allpairs_cu,
              "nbodysim_tpu/kernels/allpairs.py:105", d_launches["K4"],
              k4_deep_err, *deep_k["K4"][:2], deep_k["K4"][2:]),
        entry(f"K1 allpairs_accelerations (3D deep chain, N=1M Plummer "
              f"sphere: 4096 outliers <- 1M, D=3)", allpairs_cu,
              "nbodysim_tpu/kernels/allpairs.py:56", pl_launches["K1"],
              pl_errs["K1"], *deep3_k["K1"][:2], deep3_k["K1"][2:]),
        entry(f"K4 allpairs_accelerations_wide (3D deep chain, N=1M Plummer "
              f"sphere: 1M x 4096, D=3)", allpairs_cu,
              "nbodysim_tpu/kernels/allpairs.py:105", pl_launches["K4"],
              pl_errs["K4"], *deep3_k["K4"][:2], deep3_k["K4"][2:]),
        entry(f"K7 bucket_stencil3 (3D deep chain, N=1M Plummer sphere: "
              f"64^3 x {cap}, rr=1)",
              "nbodysim_tpu_torch/csrc/nearfield3.cu",
              "nbodysim_tpu/kernels/nearfield.py:262", pl_launches["K7"],
              pl_errs["K7"], *deep3_k["K7"][:2], deep3_k["K7"][2:]),
    ]
    for v, (worst, ms, lib_ms, bnd) in sorted(m2l3_rows.items(),
                                               reverse=True):
        row = entry(
            f"M2L m2l3 (3D deep chain, N=1M Plummer sphere: level {v}, "
            f"{1 << v}^3; launches: all levels of 3 steps; plain_ms and "
            f"library_ms: the plain route, cuDNN in full f32)",
            "nbodysim_tpu_torch/csrc/m2l3.cu",
            "none (the port adds it; nbodysim_tpu/physics/barneshut3d.py:"
            "_m2l_conv3 leaves the M2L to XLA's conv_general_dilated)",
            pl_launches["M2L"], worst, ms, lib_ms, bnd)
        row["library_ms"] = lib_ms
        kernels.append(row)
    for (label, v), (worst, ms, lib_ms, bnd) in m2l2_rows.items():
        row = entry(
            f"M2 m2l2 (2D deep chain, {label}: level {v}, {1 << v}^2; "
            f"launches: "
            + ("all levels of one eval" if label == "N=4M merger"
               else "all levels of 5 steps")
            + "; max_abs_err: the worst term class's error over its max; "
            "plain_ms and library_ms: the plain route, cuDNN in full f32)",
            "nbodysim_tpu_torch/csrc/m2l2.cu",
            "none (the port adds it; nbodysim_tpu/physics/barneshut.py:"
            "_m2l_conv leaves the M2L to XLA's conv_general_dilated)",
            m2_4m if label == "N=4M merger" else d_launches["M2"], worst,
            ms, lib_ms, bnd)
        row["library_ms"] = lib_ms
        kernels.append(row)
    for dim, (k5_launched, k5, _, vmax) in hash_k5.items():
        kernels.append(entry(
            f"K5 rect_pair_deltas (hash pass, {dim}D N=1M merger, every "
            f"launch of one pass: {', '.join(k5['shapes'])}; ms, plain_ms "
            f"and bound summed over them)",
            "nbodysim_tpu_torch/csrc/collide.cu",
            "nbodysim_tpu/kernels/collide.py:250", k5_launched, k5["err"],
            k5["ms"], k5["plain_ms"], k5["bound"]))
    # -- 13. sharded ----------------------------------------------------------
    kernels.extend(sharded_phase(SimpleNamespace(
        dev=dev, time_ms=time_ms, bound=bound, pair_bound=pair_bound,
        near_case=near_case, entry=entry, upos=upos, umass=umass, tcfg=tcfg,
        disc_deep=disc1m, merger=merger,
        merger_cfg=mcfg.replace(collision_broad_phase="block",
                                collision_cell_size=0.0), ustate=ustate,
        ucfg=ucfg)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
