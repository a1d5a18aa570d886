"""collision_busy_ms: the union of the device intervals of the operations
launched inside the program's `collisions` span, a step (the `program`
probe, pass b), where the resolved config runs a large-N broad phase (not
the dense pass)."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    cfg = ctx.config
    if p is None or not cfg.enable_collisions or \
            cfg.collision_broad_phase == "dense" or cfg.n <= 65_536:
        return None
    return p["busy_ms"]["collisions"]
