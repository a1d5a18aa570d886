"""One run of one cell: set-up, the measured window, the traced layers,
the comparison with the plain reference, and the result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

Set-up is everything from the process's start to the window's start:
imports, CUDA, the kernel library (built into the checkout's build/ on
the first run there, loaded after), the scene made on the card from the
seed, the program's probes and priming, and one warm call of the traffic.
The window then runs the traffic's calls back to back (closed loop) and
closes at the first call that ends past `--seconds`. With `--trace 1` the
window profiles `trace_calls` of its calls at its middle, and after it the
benchmark times each layer that the cell's per-layer metrics read.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

import torch

from harness import check, faults, registry
from harness import reference as ref
from harness import render_ref
from harness.trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "nbodysim_tpu")


class Context:
    """What the readers and probes see: the cell, the program's objects,
    the resolved config, the spans the probes timed (ms) and the trace."""

    def __init__(self, cell):
        self.cell = cell
        self.sim = None          # nbodysim_tpu_torch.api.Simulation
        self.viewer = None       # nbodysim_tpu_torch.app.viewer.Viewer
        self.config = None       # the resolved SimConfig
        self.sim_state = None    # the window's last state
        self.spans: dict = {}
        self.trace: dict | None = None
        self.traced_steps = 0


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def sim_config(cell, seed: int, scale: dict | None = None):
    from nbodysim_tpu_torch.config import SimConfig

    fields = dict(cell.config["sim"])
    fields.update(cell.traffic.get("overrides", {}))
    fields.update(scale or {})
    return SimConfig(seed=seed, **fields)


def make_state(cell, seed: int, device, scale: dict | None = None) -> dict:
    params = dict(cell.config["scene_params"])
    params.update({k: v for k, v in (scale or {}).items() if k == "n"})
    return registry.scene(cell.config["scene"]).make(params, seed, device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _snapshot(st) -> dict:
    return {k: getattr(st, k) for k in ("pos", "vel", "acc", "mass",
                                        "radius")}


def build(ctx: Context, cfg, inputs: dict, device):
    """The program under test, from the benchmark's own inputs."""
    from nbodysim_tpu_torch.api import Simulation
    from nbodysim_tpu_torch.core.state import ParticleState

    state = ParticleState.create(inputs["pos"], inputs["vel"],
                                 inputs["mass"], inputs["radius"])
    tr = ctx.cell.traffic
    ctx.sim = Simulation(cfg, state=state, device=device)
    if tr["driver"] == "viewer":
        from nbodysim_tpu_torch.app import viewer
        from nbodysim_tpu_torch.render.splat import RenderConfig

        # The viewer is built around the benchmark's Simulation: its own
        # constructor would make and prime a scene that no frame uses.
        with faults.patched(viewer, "Simulation",
                            lambda *a, **k: ctx.sim):
            ctx.viewer = viewer.Viewer(
                cfg, ctx.cell.config["scene"],
                render_config=RenderConfig(**tr["render"]),
                steps_per_frame=tr["steps_per_call"], device=device)
    ctx.config = ctx.sim.config


def call(ctx: Context, device):
    """One call of the traffic; returns the viewer's (frame, hud) or None.
    Ends with the device synchronised."""
    if ctx.viewer is not None:
        img = ctx.viewer.frame()
        hud = ctx.viewer.hud_text()
        return img, hud
    ctx.sim.run(ctx.cell.traffic["steps_per_call"])
    _sync(device)
    return None


def window(ctx: Context, seconds: float, device, traced: bool):
    """The measured window. Returns (calls, seconds, per-call seconds,
    state before the last call, the last call's output)."""
    trace_calls = int(ctx.cell.traffic.get("trace_calls", 3))
    per_call, last = [], None
    tracer = None
    calls = 0
    t0 = time.perf_counter()
    while True:
        prev = ctx.sim.state
        if traced and tracer is None and time.perf_counter() - t0 >= \
                seconds / 2:
            tracer = Trace()
            tracer.__enter__()
            traced_from = calls
        c0 = time.perf_counter()
        last = call(ctx, device)
        c1 = time.perf_counter()
        per_call.append(c1 - c0)
        calls += 1
        if tracer is not None and ctx.trace is None and \
                calls - traced_from == trace_calls:
            tracer.__exit__(None, None, None)
            ctx.trace = tracer.reduce()
            ctx.traced_steps = trace_calls * ctx.cell.traffic[
                "steps_per_call"]
        if c1 - t0 >= seconds and (not traced or ctx.trace is not None):
            break
    return calls, time.perf_counter() - t0, per_call, prev, last


def probe_layers(ctx: Context, metrics: list):
    """Time each layer the cell's per-layer metrics read (`PROBES` of each
    reader), on the window's own state and resolved config."""
    wanted = []
    for m in metrics:
        for p in getattr(registry.metric(m["name"]), "PROBES", ()):
            if p not in wanted:
                wanted.append(p)
    for p in wanted:
        ms = registry.probe(p).measure(ctx)
        if ms is not None:
            ctx.spans[p] = ms


def percentile(values, q: float) -> float:
    """The q-th percentile (nearest rank) of all values."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def resolved(cfg, state) -> dict:
    """The resolved configuration the window ran on `state`, with the
    tree's levels and the collision pass that runs (`collision_pass`:
    dense, bucket, hash or block) where the program exposes its
    resolvers."""
    from nbodysim_tpu_torch.physics import collisions

    out = {k: getattr(cfg, k) for k in (
        "n", "integrator", "force_backend", "bh_levels", "bh_deep_levels",
        "bh_tile_levels", "bh_tile_size", "bh_tile_count", "bh_nf_sparse",
        "enable_collisions", "collision_broad_phase", "collision_cell_size")}
    out["collision_pass"] = (collisions._broad_phase(state, cfg)
                             if cfg.enable_collisions else None)
    if cfg.force_backend == "bh" and cfg.dim == 2:
        from nbodysim_tpu_torch.physics import barneshut as bh

        lv = bh._resolve_levels(cfg, cfg.n)
        deep = bh._resolve_deep_levels(cfg, lv)
        out.update(levels=lv, deep_levels=deep,
                   tiles=list(bh._resolve_tile_params(cfg, deep, lv)))
    return out


def _sim_dict(ctx: Context) -> dict:
    sim = dict(ctx.cell.config["sim"])
    sim.update(ctx.cell.traffic.get("overrides", {}))
    sim.update({k: getattr(ctx.config, k) for k in ("n", "dt")})
    return sim


def judge(ctx: Context, prev: dict, out: dict, last, seed: int) -> dict:
    """The numbers compared: the step gaps and, for the viewer, the
    framebuffer's (largest pixel difference) and the HUD energy's
    (relative to the reference's float64 energy of the same state)."""
    sim = _sim_dict(ctx)
    nums = check.gaps(prev, out, sim, ctx.cell.traffic["steps_per_call"],
                      seed)
    if last is not None:
        img, hud = last
        rc = ctx.cell.traffic["render"]
        want = render_ref.render(out["pos"], out["mass"], out["radius"],
                                 rc["width"], rc["height"], rc["scale"])
        got = torch.as_tensor(img).to(want.device)
        nums["frame_gap"] = float((got.int() - want.int()).abs().max())
        e_ref = ref.kinetic_energy(out["vel"], out["mass"]) + \
            ref.potential_energy(out["pos"], out["mass"],
                                 sim["softening"] ** 2, sim["g_const"])
        e_hud = float(hud.split("| E ")[1].split(" |")[0])
        nums["hud_energy_gap"] = abs(e_hud - e_ref) / abs(e_ref)
    return nums


def control_numbers(ctx: Context, prev: dict, after: dict, last,
                    seed: int) -> dict:
    """The numbers compared for the control: the reference computed in
    bfloat16 put in the program's place (its state, and for the viewer
    its frame and HUD energy, in bfloat16)."""
    sim = _sim_dict(ctx)
    steps = ctx.cell.traffic["steps_per_call"]
    out = dict(prev)
    out.update(check.control(prev, after, sim, steps, seed))
    ctl_last = None
    if last is not None:
        rc = ctx.cell.traffic["render"]
        bf = torch.bfloat16
        img = render_ref.render(out["pos"], out["mass"], out["radius"],
                                rc["width"], rc["height"], rc["scale"],
                                dtype=bf)
        e = ref.kinetic_energy(out["vel"], out["mass"], bf) + \
            ref.potential_energy(out["pos"], out["mass"],
                                 sim["softening"] ** 2, sim["g_const"],
                                 dtype=bf)
        ctl_last = (img.cpu().numpy(), f"x | E {e:.3e} | y")
    nums = judge(ctx, prev, out, ctl_last, seed)
    for k in ("pairs", "tainted"):
        nums.pop(k)
    return nums


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", scale: dict | None = None, fault=None,
             t_start: float | None = None, out=print, control=False,
             traffic: dict | None = None):
    """One run; returns the result dict (and prints its lines with `out`).
    `scale` and `traffic` (tests only) override configuration and
    traffic fields, such as n, for a CPU rehearsal; `fault` is a context
    manager planted under the program while it is built and run; `control`
    (calibration only) also reads the control's numbers into the info's
    "control"."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = registry.cell(workload)
    if traffic:
        cell = cell._replace(traffic={**cell.traffic, **traffic})
    ctx = Context(cell)
    cfg = sim_config(cell, seed, scale)
    with fault if fault is not None else contextlib.nullcontext():
        inputs = make_state(cell, seed, device, scale)
        build(ctx, cfg, inputs, device)
        w0 = time.perf_counter()
        call(ctx, device)
        warm_s = time.perf_counter() - w0
        _sync(device)
        setup_s = time.perf_counter() - t_start
        calls, win_s, per_call, prev_st, last = window(
            ctx, seconds, device, traced)
        out_st = ctx.sim_state = ctx.sim.state
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        if traced:
            probe_layers(ctx, cell.per_layer)
    steps = calls * cell.traffic["steps_per_call"]
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = registry.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"steps_per_s": steps / win_s, "setup_s": setup_s}
        if ctx.viewer is not None:
            e2e["frame_ms_p95"] = 1e3 * percentile(per_call, 95)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    info = {"workload": workload, "seed": seed, "steps": steps,
            "calls": calls, "window_s": win_s, "warm_call_s": warm_s,
            "memory_peak_bytes": peak,
            "resolved": resolved(ctx.config, out_st),
            "card": power_limit() if device.type == "cuda" else "cpu"}

    # The program's objects go before the reference runs; its states
    # before and after the last call are what is judged.
    prev, after = _snapshot(prev_st), _snapshot(out_st)
    ctx.sim = ctx.viewer = ctx.sim_state = None
    del prev_st, out_st
    if device.type == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    nums = judge(ctx, prev, after, last, seed)
    info["reference_s"] = time.perf_counter() - r0
    if control:
        info["control"] = control_numbers(ctx, prev, after, last, seed)
    for k in ("pairs", "tainted"):
        info[k] = nums.pop(k)
    info["numbers"] = nums
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in nums.items() if k in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and \
        len(checks) == len(cell.limits)
    result = {
        "correct": correct, "attempted": calls, "failed": 0 if correct else 1,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": peak},
    }
    if traced and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace["busy_s"]
        result["device"]["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    result["checks"] = checks
    out(json.dumps({"info": info}))
    return result, info


def main(argv=None, t_start: float | None = None) -> int:
    args = parse(argv)
    chips = registry.cell(args.workload).spec["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {have}", file=sys.stderr)
        return 2
    result, _ = run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
