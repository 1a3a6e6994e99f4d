"""Seconds a folder spends in the pipeline's "features" stage(s), from the stage
timer of each stitch in a traced window, summed and divided by folders."""

UNIT = "s"
LAYER = "models/features -> ops/sift, kernels/sift_window"
MOVES = "stitch_s"


def read(ctx):
    return ctx.per_folder("features")
