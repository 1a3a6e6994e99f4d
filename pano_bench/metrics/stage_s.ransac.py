"""Seconds a folder spends in the pipeline's "ransac" stage(s), from the stage
timer of each stitch in a traced window, summed and divided by folders."""

UNIT = "s"
LAYER = "ops/ransac"
MOVES = "stitch_s"


def read(ctx):
    return ctx.per_folder("ransac")
