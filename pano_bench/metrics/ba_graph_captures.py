"""CUDA graphs the bundle adjustment's graph cache captured in a traced
window, a folder (`models.bundle.graph_captures`, its change over the
window). Set-up stitches every folder of the pool once, so a steady window
captures none; a capture in it is a shape the warm-up missed."""

UNIT = "captures/folder"
LAYER = "models/bundle graph cache"
MOVES = "stitch_p90_s"


def read(ctx):
    if not ctx.folders:
        return None
    return ctx.counters["ba_graph_captures"] / ctx.folders
