"""Reads the program's own spans and counters
(`nbodysim_tpu_torch.diagnostics.profiling`) over the traffic's
`trace_calls` calls of the cell's own call (`harness.cli.call`), after the
window, from the window's last state, in two passes:

  (a) under `profiling.recording()` and no profiler: every span's host
      time, the layer spans' extents on the device's clock (a CUDA event at
      each edge of `step`, `forces`, `collisions`) and the counters;
  (b) under `torch.profiler` (CPU and CUDA), where each span is a host
      range beside the aten ops: the device operations launched inside each
      layer span (a device operation's correlation id names the runtime
      call that launched it, and that call's host time the span) and the
      union of their device intervals.

Returns a dict of numbers a step (each divided by the `step` spans of its
pass), or None where the program keeps no spans (no
`profiling.recording`) or ran no step. The device numbers are None on a
host without a card."""

import bisect

import torch

from harness import cli


def _per_step(value, steps):
    return None if value is None else value / steps


def _pass_a(ctx, device, calls, profiling):
    with profiling.recording() as rec:
        for _ in range(calls):
            cli.call(ctx, device)
    steps = len(rec.select("step"))
    if not steps:
        return None
    cnt = rec.counters
    needed = sum(v for k, v in cnt.items()
                 if k.startswith("tree.rows_needed."))
    computed = sum(v for k, v in cnt.items()
                   if k.startswith("tree.rows_computed."))
    step_ms = rec.host_ms("step") / steps
    wait_ms = rec.host_ms("host_read.", under="step") / steps
    return {
        "steps": steps,
        "step_host_ms": step_ms,
        "sync_wait_ms": wait_ms,
        "enqueue_ms": step_ms - wait_ms,
        "host_syncs_per_step": cnt["host_syncs"] / steps,
        "rows_needed": needed,
        "rows_computed": computed,
        "extent_ms": {L: _per_step(rec.device_ms(L), steps)
                      for L in profiling.LAYER_SPANS},
        "spans": {k: {"calls": v["calls"] / steps,
                      "host_ms": v["host_ms"] / steps}
                  for k, v in rec.summary().items()},
        "counters": dict(cnt),
    }


def _union_ms(intervals) -> float:
    total, cur_s, cur_t = 0.0, None, None
    for s, t in sorted(intervals):
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                total += cur_t - cur_s
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        total += cur_t - cur_s
    return total * 1e-3                      # the profiler's us -> ms


def _inside(ranges, t) -> bool:
    """Whether host time t lies in one of the sorted, disjoint ranges."""
    i = bisect.bisect_right(ranges[0], t) - 1
    return i >= 0 and t <= ranges[1][i]


def _pass_b(ctx, device, calls, layers):
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for _ in range(calls):
        cli.call(ctx, device)
    torch.cuda.synchronize()
    prof.stop()
    spans = {L: [] for L in layers}
    launch_at, device_ops = {}, []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if tr.end > tr.start:
                device_ops.append((e.id, tr.start, tr.end))
        elif e.name in spans:
            spans[e.name].append((tr.start, tr.end))
        elif e.name.startswith("cu"):     # a CUDA API call: cudaLaunchKernel
            launch_at[e.id] = tr.start
    steps = len(spans["step"])
    if not steps:
        return None
    busy = {}
    for layer, rs in spans.items():
        rs.sort()
        ranges = ([s for s, _ in rs], [t for _, t in rs])
        busy[layer] = _union_ms(
            (s, t) for cid, s, t in device_ops
            if cid in launch_at and _inside(ranges, launch_at[cid])) / steps
    return {"busy_ms": busy, "steps": steps,
            "device_ms": _union_ms((s, t) for _, s, t in device_ops) / steps}


def measure(ctx):
    from nbodysim_tpu_torch.diagnostics import profiling

    if not hasattr(profiling, "recording") or ctx.sim is None:
        return None
    device = ctx.sim.device
    calls = int(ctx.cell.traffic.get("trace_calls", 3))
    out = _pass_a(ctx, device, calls, profiling)
    if out is None:
        return None
    layers = profiling.LAYER_SPANS
    out["busy_ms"] = {L: None for L in layers}
    if device.type == "cuda":
        b = _pass_b(ctx, device, calls, layers)
        if b is not None:
            out["pass_b"] = b
            out["busy_ms"] = b["busy_ms"]
    return out
