"""collision_pass_ms: mean ms of one resolve_collisions call (the
`collisions` probe) where the resolved config runs a large-N broad phase
(not the dense pass)."""

PROBES = ("collisions",)


def read(ctx):
    cfg = ctx.config
    if not cfg.enable_collisions or cfg.collision_broad_phase == "dense" \
            or cfg.n <= 65_536:
        return None
    return ctx.spans.get("collisions")
