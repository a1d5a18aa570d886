"""near_overflow_per_step: the bodies past the tree's near-field bucket
cap, a step, that its exact residual takes: the program's
`tree.near_overflow` counter (the count the residual's branch reads) over
the `step` spans of the `program` probe's pass (a). None where the
program keeps no such counter or the residual's branch did not run (the
deep chain replaces it)."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    if p is None or "tree.near_overflow" not in p["counters"]:
        return None
    return p["counters"]["tree.near_overflow"] / p["steps"]
