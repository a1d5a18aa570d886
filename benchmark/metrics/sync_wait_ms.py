"""sync_wait_ms: host ms a step blocked in the program's `host_read.*`
spans inside `step`, the reads of device values it has to make (the
`program` probe, pass a)."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    return None if p is None else p["sync_wait_ms"]
