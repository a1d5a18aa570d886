"""tree_busy_ms: the union of the device intervals of the operations
launched inside the program's `forces` span, a step (the `program` probe,
pass b), where the resolved config runs the tree (force_backend "bh")."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    if p is None or ctx.config.force_backend != "bh":
        return None
    return p["busy_ms"]["forces"]
