"""enqueue_ms: host ms a step inside the program's `step` span less the
time inside its `host_read.*` spans: the host's own work of enqueueing
the step (the `program` probe, pass a)."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    return None if p is None else p["enqueue_ms"]
