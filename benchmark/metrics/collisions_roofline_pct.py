"""collisions_roofline_pct: 100 x the all-pairs overlap-test bound of the
cell's N (harness/roofline.py) over the mean ms of one resolve_collisions
call (the `collisions` probe)."""

from harness import roofline

PROBES = ("collisions",)


def read(ctx):
    ms = ctx.spans.get("collisions")
    if not ms:
        return None
    cfg = ctx.config
    return 100.0 * roofline.collisions_bound_s(cfg.n, cfg.dim) * 1e3 / ms
