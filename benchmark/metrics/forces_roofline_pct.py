"""forces_roofline_pct: 100 x the all-pairs gravity bound of the cell's N
(harness/roofline.py) over the mean ms of one compute_accelerations call
(the `forces` probe)."""

from harness import roofline

PROBES = ("forces",)


def read(ctx):
    ms = ctx.spans.get("forces")
    if not ms:
        return None
    cfg = ctx.config
    return 100.0 * roofline.forces_bound_s(cfg.n, cfg.dim) * 1e3 / ms
