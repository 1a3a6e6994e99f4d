"""Seconds a folder spends in the pipeline's "bundle_adjustment" and "bundle_adjustment_h" stage(s), from the stage
timer of each stitch in a traced window, summed and divided by folders."""

UNIT = "s"
LAYER = "models/bundle, models/bundle_h, kernels/ba"
MOVES = "stitch_s"


def read(ctx):
    return ctx.per_folder("bundle_adjustment", "bundle_adjustment_h")
