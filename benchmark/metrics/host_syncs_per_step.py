"""host_syncs_per_step: the program's `host_syncs` counter (its
`host_read` calls) over the `step` spans of the `program` probe's pass
(a)."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    return None if p is None else p["host_syncs_per_step"]
