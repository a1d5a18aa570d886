"""Device busy of each stage span of the tree (`tree.*`), a step: one
pass under `torch.profiler` (CPU and CUDA) over the traffic's
`trace_calls` calls of the cell's own call, after the window, as the
`program` probe's pass (b). Each device operation is joined to every
`tree.*` span whose host range holds the runtime call that launched it, so
an operation inside a nested span (`tree.m2l` inside `tree.downward`)
counts in both, and a span's busy time is the union of its operations'
device intervals, over the pass's `step` spans.

Returns {"busy_ms": {span: ms a step}, "steps"}, or None on a host without
a card, where the program keeps no spans, or where no step ran."""

import torch

from harness import cli, registry


def measure(ctx):
    from nbodysim_tpu_torch.diagnostics import profiling

    if not hasattr(profiling, "recording") or ctx.sim is None \
            or ctx.sim.device.type != "cuda":
        return None
    program = registry.probe("program")
    calls = int(ctx.cell.traffic.get("trace_calls", 3))
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for _ in range(calls):
        cli.call(ctx, ctx.sim.device)
    torch.cuda.synchronize()
    prof.stop()
    spans, launch_at, device_ops, steps = {}, {}, [], 0
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if tr.end > tr.start:
                device_ops.append((e.id, tr.start, tr.end))
        elif e.name == "step":
            steps += 1
        elif e.name.startswith("tree."):
            spans.setdefault(e.name, []).append((tr.start, tr.end))
        elif e.name.startswith("cu"):     # a CUDA API call: cudaLaunchKernel
            launch_at[e.id] = tr.start
    if not steps:
        return None
    busy = {}
    for name, rs in spans.items():
        rs.sort()
        ranges = ([s for s, _ in rs], [t for _, t in rs])
        busy[name] = program._union_ms(
            (s, t) for cid, s, t in device_ops
            if cid in launch_at
            and program._inside(ranges, launch_at[cid])) / steps
    return {"busy_ms": busy, "steps": steps}
