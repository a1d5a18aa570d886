"""stencil_busy_ms: the union of the device intervals of the operations
launched inside the program's `collide.stencil` span (the bucket
collision pass's 9-shift stencil), a step: the `program` probe's pass (b),
which joins device work to each span of `profiling.LAYER_SPANS`. None
where the program keeps no such layer span, the span did not run, or the
host has no card."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    if p is None or "collide.stencil" not in p["spans"]:
        return None
    return p["busy_ms"].get("collide.stencil")
