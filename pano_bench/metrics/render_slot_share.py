"""Share of the render's contributor slots that hold an image, over the
profiled stitches: the program's counters `render.slots_live` /
`render.slots` (each launched tile's C slots, `tile_contributors` sizing C
for every tile of a canvas from its densest). None where the program counts
no slots: the planar band render, or a program without the counters."""

from pano_bench import spans

UNIT = "%"
LAYER = "models/render tile_contributors, kernels/render"
MOVES = "stitch_s"
install = spans.install


def read(ctx):
    slots = spans.counter(ctx, "render.slots")
    if not slots:
        return None
    return 100.0 * spans.counter(ctx, "render.slots_live") / slots
