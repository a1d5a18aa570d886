"""render_ms: mean ms of the viewer's render_frame plus its copy to the
host (the `render` probe)."""

PROBES = ("render",)


def read(ctx):
    return ctx.spans.get("render")
