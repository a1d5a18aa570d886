"""device_idle_pct: the share of the traced span in which no operation
ran on the device, 100 * (1 - busy_s / window_s), from the profiler's
trace of `trace_calls` calls at the middle of the window."""

PROBES = ()


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
