"""Share of the candidate pairs that RANSAC accepted, over every
verification of the profiled stitches (first pass, rescue, second passes):
the program's counters `ransac.accepted` / `ransac.pairs`."""

from pano_bench import spans

UNIT = "%"
LAYER = "ops/ransac"
MOVES = "stitch_s"
install = spans.install


def read(ctx):
    pairs = spans.counter(ctx, "ransac.pairs")
    if not pairs:
        return None
    return 100.0 * spans.counter(ctx, "ransac.accepted") / pairs
