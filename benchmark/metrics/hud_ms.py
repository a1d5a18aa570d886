"""hud_ms: mean ms of Viewer.hud_text(), whose diagnostics sum the exact
potential (the `hud` probe)."""

PROBES = ("hud",)


def read(ctx):
    return ctx.spans.get("hud")
