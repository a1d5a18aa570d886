"""tree_idle_pct: 100 x (1 - tree_busy_ms / the `forces` span's extent
on the device's clock, a step): the share of the force layer's time on
the device in which none of its operations ran (the `program` probe:
busy from pass b, extent from pass a's CUDA events)."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    if p is None or ctx.config.force_backend != "bh":
        return None
    busy, extent = p["busy_ms"]["forces"], p["extent_ms"]["forces"]
    if busy is None or not extent:
        return None
    return 100.0 * (1.0 - busy / extent)
