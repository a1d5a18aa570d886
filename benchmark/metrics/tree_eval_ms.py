"""tree_eval_ms: mean ms of one compute_accelerations call (the `forces`
probe) where the resolved config runs the tree (force_backend "bh")."""

PROBES = ("forces",)


def read(ctx):
    if ctx.config.force_backend != "bh":
        return None
    return ctx.spans.get("forces")
