"""Seconds a folder spends in the pipeline's "pairwise_rescue" and "second_pass" stage(s), from the stage
timer of each stitch in a traced window, summed and divided by folders."""

UNIT = "s"
LAYER = "models/pipeline recognition: pairwise_rescue, second_pass_*"
MOVES = "stitch_s"


def read(ctx):
    return ctx.per_folder("pairwise_rescue", "second_pass")
