"""Seconds a folder spends in the pipeline's "matching" stage(s), from the stage
timer of each stitch in a traced window, summed and divided by folders."""

UNIT = "s"
LAYER = "ops/matching"
MOVES = "stitch_s"


def read(ctx):
    return ctx.per_folder("matching")
