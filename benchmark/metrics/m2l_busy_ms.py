"""m2l_busy_ms: the union of the device intervals of the operations
launched inside the program's `tree.m2l` spans (each M2L level of the
octree: the bucket levels, the deep levels and the tiles' sub-levels), a
step (the `stages` probe). None where the program has no such span."""

PROBES = ("stages",)


def read(ctx):
    p = ctx.spans.get("stages")
    return None if p is None else p["busy_ms"].get("tree.m2l")
