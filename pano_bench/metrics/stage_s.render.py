"""Seconds a folder spends in the pipeline's "gain" and "render" stage(s), from the stage
timer of each stitch in a traced window, summed and divided by folders."""

UNIT = "s"
LAYER = "models/gain, models/render, models/planar, ops/sampling, ops/blend, kernels/render"
MOVES = "stitch_s"


def read(ctx):
    return ctx.per_folder("gain", "render")
