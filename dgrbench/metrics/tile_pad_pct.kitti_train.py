"""Padding rows over the tile rows that the 6D inlier net's convs launched
in the traced steps, forward, input and kernel gradients together (the
program's counters, ``ops/sparse_conv.tile_counts``, with the frozen FCGF's
forward taken out by the driver). None where the program has no counters."""


def read(ctx):
    tiles = ctx.get("traced_work", {}).get("tiles")
    if ctx["kind"] != "train" or not tiles:
        return None
    rows = sum(r for r, _ in tiles.values())
    edges = sum(e for _, e in tiles.values())
    return 100.0 * (rows - edges) / rows if rows > 0 else None
