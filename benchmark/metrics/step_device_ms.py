"""step_device_ms: the device's busy time in the traced span (the union
of its activity intervals) divided by the steps in that span."""

PROBES = ()


def read(ctx):
    t = ctx.trace
    if not t or t["busy_s"] <= 0 or not ctx.traced_steps:
        return None
    return 1e3 * t["busy_s"] / ctx.traced_steps
