"""Command-line interface of the PyTorch/CUDA port (port of
`nbodysim_tpu.cli`), the headless analogue of the reference app's window
(main.cpp:637-958: keyboard controls, dt slider, HUD metrics panel):

  run     step a scene, print the HUD metrics panel every K steps,
          checkpoint every K steps, resume from a checkpoint; --control FILE
          polls a key=value file each chunk for live dt / pause / stop (the
          reference's runtime atomics, main.cpp:674-724, 889-893)
  render  headless render to a PNG frame sequence / mp4 / gif
  bench   the port's benchmark harness (nbodysim_tpu_torch/bench.py)
  info    the torch device, its name and the resolved config

    python -m nbodysim_tpu_torch.cli run --scene uniform_disc --steps 200

Everything runs on the card unless --device cpu is given; without a card,
--device cuda (the default) is an error, not a quiet CPU run. Compile-time
constants of the reference are SimConfig fields (--set key=value).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _device(args):
    from nbodysim_tpu_torch.core.state import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))


def _parse_config(args):
    from nbodysim_tpu_torch.config import SimConfig

    cfg = SimConfig()
    overrides = {}
    if args.n is not None:
        overrides["n"] = args.n
    if args.dt is not None:
        overrides["dt"] = args.dt
    if getattr(args, "integrator", None):
        overrides["integrator"] = args.integrator
    if getattr(args, "backend", None):
        overrides["force_backend"] = args.backend
    if args.seed is not None:
        overrides["seed"] = args.seed
    field_names = {f.name for f in dataclasses.fields(cfg)}
    for kv in args.set or []:
        k, sep, v = kv.partition("=")
        if not sep or k not in field_names:
            # Validate against the dataclass fields: hasattr would accept
            # properties such as eps_sq and fail later in replace().
            hint = " (did you mean 'softening'?)" if k == "eps_sq" else ""
            raise SystemExit(f"unknown config field in --set: {k!r}{hint}")
        current = getattr(cfg, k)
        if isinstance(current, bool):
            overrides[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            overrides[k] = int(v)
        elif isinstance(current, float):
            overrides[k] = float(v)
        else:
            overrides[k] = v
    return cfg.replace(**overrides)


def _add_common(p):
    p.add_argument("--scene", default="uniform_disc",
                   help="scene name (see nbodysim_tpu_torch.scenes.SCENES)")
    p.add_argument("--n", type=int, default=None, help="particle count")
    p.add_argument("--dt", type=float, default=None, help="timestep")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--integrator",
                   choices=["euler_symplectic", "leapfrog_kdk"], default=None)
    p.add_argument("--backend", choices=["auto", "cuda", "torch", "bh"],
                   default=None)
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="override any SimConfig field")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")


def read_control_file(path):
    """Parse a runtime-control file: one key=value per line (dt=<float>,
    pause=0/1, stop=0/1); '#' comments and blank lines ignored. Returns a
    dict (possibly empty). Missing/unreadable file -> empty dict."""
    out = {}
    if not path or not os.path.exists(path):
        return out
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return out
    for line in lines:
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        k, _, v = line.partition("=")
        k, v = k.strip(), v.strip()
        try:
            if k == "dt":
                out["dt"] = float(v)
            elif k in ("pause", "stop"):
                out[k] = v.lower() in ("1", "true", "yes", "on")
        except ValueError:
            continue
    return out


def _apply_control(sim, control, ctrl_mtime):
    """One poll of the control file: (stop?, new mtime). Applies a changed
    dt, clamped to the reference slider's [0.001, 0.1] (main.cpp:865-893),
    and blocks while pause is set."""
    from nbodysim_tpu_torch.api import DT_MAX, DT_MIN, clamp_dt

    directives = read_control_file(control)
    try:
        mtime = os.path.getmtime(control)
    except OSError:
        mtime = None
    if directives.get("stop"):
        return True, mtime
    if (mtime != ctrl_mtime and "dt" in directives
            and directives["dt"] != sim.config.dt):
        new_dt, clamped = clamp_dt(directives["dt"])
        if clamped:
            print(f"control: dt {directives['dt']} outside the reference "
                  f"slider range [{DT_MIN}, {DT_MAX}]; clamped to {new_dt}")
        if new_dt != sim.config.dt:
            sim.set_dt(new_dt)
            print(f"control: dt -> {sim.config.dt}")
    while directives.get("pause") and not directives.get("stop"):
        time.sleep(0.2)
        directives = read_control_file(control)
    return bool(directives.get("stop")), mtime


def _hud_line(sim, elapsed: float) -> str:
    """The HUD panel (reference main.cpp:919-944); the step rate carries
    the reference's FPS colors (main.cpp:847: >= 30 green, >= 15 orange,
    else red) when stdout is a terminal."""
    import torch

    d = sim.diagnostics()
    sps = sim.frame / max(elapsed, 1e-9)
    if sys.stdout.isatty():
        tint = ("\x1b[32m" if sps >= 30
                else "\x1b[33m" if sps >= 15 else "\x1b[31m")
        rate = f"{tint}{sps:8.1f} steps/s\x1b[0m"
    else:
        rate = f"{sps:8.1f} steps/s"
    return (f"frame {sim.frame:7d} | E {float(d.total_energy):+.6e} | "
            f"KE {float(d.kinetic):.4e} | PE {float(d.potential):.4e} | "
            f"|p| {float(torch.linalg.vector_norm(d.momentum)):.3e} | "
            f"Lz {float(d.angular_momentum.reshape(-1)[-1]):.4e} | {rate}")


def cmd_run(args):
    from nbodysim_tpu_torch.api import Simulation
    from nbodysim_tpu_torch.diagnostics.metrics import system_metrics
    from nbodysim_tpu_torch.io.checkpoint import (
        load_checkpoint, save_checkpoint)

    device = _device(args)
    config = _parse_config(args)
    if args.resume:
        state, saved_cfg = load_checkpoint(args.resume, device=device)
        if saved_cfg is not None:
            config = saved_cfg
        sim = Simulation(config, state=state, device=device)
        print(f"resumed from {args.resume} at frame {sim.frame}")
    else:
        sim = Simulation(config, scene=args.scene, device=device)

    total = args.steps
    chunk = max(1, min(args.log_every, total))
    t_start = time.perf_counter()
    last_ckpt_bucket = (sim.frame // args.checkpoint_every
                        if args.checkpoint_every else 0)
    ctrl_mtime = None
    while sim.frame < total:
        if args.control:
            stop, ctrl_mtime = _apply_control(sim, args.control, ctrl_mtime)
            if stop:
                print(f"control: stop at frame {sim.frame}")
                break
        sim.run(min(chunk, total - sim.frame))
        # Re-check the residual capacities as the scene evolves and, where
        # a cap trips on an 'auto' config, adopt the re-resolution (deep
        # chain on / block pass) mid-run.
        when = f"frame {sim.frame}"
        if sim.check_capacity(when=when) and sim.re_resolve_auto(when=when):
            print(f"auto re-resolve at frame {sim.frame}: "
                  f"deep={sim.config.bh_deep_levels}, "
                  f"collisions={sim.config.collision_broad_phase}")
        print(_hud_line(sim, time.perf_counter() - t_start))
        if args.metrics:
            m = system_metrics(sim.state, config)
            print("  " + " | ".join(
                f"{k} {float(v):.4g}" for k, v in m.items()))
        # Fire whenever a checkpoint-every boundary was crossed this chunk
        # (the frame advances log_every at a time).
        if args.checkpoint_every:
            bucket = sim.frame // args.checkpoint_every
            if bucket > last_ckpt_bucket:
                last_ckpt_bucket = bucket
                path = (f"{args.checkpoint_dir or 'checkpoints'}/"
                        f"ckpt_{sim.frame:07d}.npz")
                save_checkpoint(path, sim.state, config)
                print(f"  checkpoint -> {path}")

    # A final checkpoint is written only when checkpointing was requested.
    if args.checkpoint_dir and not args.checkpoint_every:
        path = f"{args.checkpoint_dir}/ckpt_final.npz"
        save_checkpoint(path, sim.state, config)
        print(f"checkpoint -> {path}")


def cmd_render(args):
    from nbodysim_tpu_torch.render.splat import RenderConfig
    from nbodysim_tpu_torch.render.video import (
        AsyncFrameWriter, StreamingVideoWriter, render_rollout, save_png)
    from nbodysim_tpu_torch.scenes import init_scene

    device = _device(args)
    config = _parse_config(args)
    state = init_scene(args.scene, config, device=device)
    rc = RenderConfig(
        width=args.width, height=args.height, scale=args.scale,
        performance_mode=args.performance_mode,
        draw_black_hole=not args.no_black_hole,
        show_quadtree=args.show_quadtree,
        show_connections=args.show_connections,
    )
    # Encode on a helper thread so device stepping overlaps the encoder.
    is_video = args.out.endswith((".mp4", ".gif"))
    if is_video:
        video_sink = StreamingVideoWriter(args.out, fps=args.fps)
        writer = AsyncFrameWriter(video_sink)
    else:
        writer = AsyncFrameWriter(
            lambda i, f: save_png(f, f"{args.out}/frame_{i:05d}.png"))
    t0 = time.perf_counter()
    for i, frame in enumerate(render_rollout(
            state, config, args.frames, args.steps_per_frame, rc,
            device=device)):
        writer.submit(i, frame)
        if (i + 1) % 10 == 0:
            print(f"frame {i + 1}/{args.frames} "
                  f"({(i + 1) / (time.perf_counter() - t0):.2f} fps)")
    writer.close()
    if is_video:
        print(f"wrote {video_sink.finish()}")
    else:
        print(f"wrote {args.frames} PNGs to {args.out}/")


def cmd_bench(args):
    from nbodysim_tpu_torch import bench

    argv = ["--device", args.device]
    if args.full:
        argv.append("--full")
    if args.config is not None:
        argv += ["--config", str(args.config)]
    if args.drift_gate:
        argv.append("--drift-gate")
    bench.main(argv)


def cmd_info(args):
    import torch

    device = _device(args)
    config = _parse_config(args)
    from nbodysim_tpu_torch.diagnostics.profiling import device_name

    print("device:", device)
    print("name:", device_name(device))
    print(f"torch: {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.device_count()} CUDA device(s)")
    print("config:", json.dumps(
        {k: str(v) for k, v in vars(config).items()}, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="nbodysim-tpu-torch",
        description="N-body simulator, the PyTorch/CUDA port of nbodysim_tpu "
                    "(capabilities of 7IBBE77S/nbodysim)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a simulation headless")
    _add_common(p_run)
    p_run.add_argument("--steps", type=int, default=1000)
    p_run.add_argument("--log-every", type=int, default=100)
    p_run.add_argument("--metrics", action="store_true",
                       help="print the reference HUD metrics panel too")
    p_run.add_argument("--checkpoint-every", type=int, default=0)
    p_run.add_argument("--checkpoint-dir", default=None)
    p_run.add_argument("--resume", default=None, metavar="CKPT")
    p_run.add_argument("--control", default=None, metavar="FILE",
                       help="poll FILE each chunk for runtime control "
                            "(lines: dt=<float>, pause=0/1, stop=1)")
    p_run.set_defaults(fn=cmd_run)

    p_r = sub.add_parser("render", help="headless render to frames/video")
    _add_common(p_r)
    p_r.add_argument("--out", default="frames",
                     help="output dir for PNGs, or .mp4/.gif path")
    p_r.add_argument("--frames", type=int, default=60)
    p_r.add_argument("--steps-per-frame", type=int, default=10)
    p_r.add_argument("--width", type=int, default=1200)
    p_r.add_argument("--height", type=int, default=900)
    p_r.add_argument("--scale", type=float, default=0.005)
    p_r.add_argument("--fps", type=int, default=30)
    p_r.add_argument("--performance-mode", action="store_true")
    p_r.add_argument("--no-black-hole", action="store_true")
    p_r.add_argument("--show-quadtree", action="store_true",
                     help="quadtree wireframe overlay (reference Q toggle)")
    p_r.add_argument("--show-connections", action="store_true",
                     help="neighbor connection overlay (reference C toggle)")
    p_r.set_defaults(fn=cmd_render)

    p_b = sub.add_parser("bench", help="benchmark harness")
    p_b.add_argument("--full", action="store_true")
    p_b.add_argument("--config", type=int, default=None,
                     help="a BASELINE.json config preset (1-5)")
    p_b.add_argument("--drift-gate", action="store_true")
    p_b.add_argument("--device", default="cuda")
    p_b.set_defaults(fn=cmd_bench)

    p_i = sub.add_parser("info", help="device + resolved config")
    _add_common(p_i)
    p_i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
