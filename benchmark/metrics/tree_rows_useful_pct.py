"""tree_rows_useful_pct: 100 x the rows the 2D tree's deep chain needed
over the rows it computed, summed over its three compacted passes (the
deep rows, the tile scatter's sources, the tile apply's refined rows):
the program's `tree.rows_needed.*` and `tree.rows_computed.*` counters in
the `program` probe's pass (a). None where no compaction ran."""

PROBES = ("program",)


def read(ctx):
    p = ctx.spans.get("program")
    if p is None or not p["rows_computed"]:
        return None
    return 100.0 * p["rows_needed"] / p["rows_computed"]
