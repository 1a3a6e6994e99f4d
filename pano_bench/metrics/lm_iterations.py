"""Levenberg-Marquardt iterations a folder: the program's counter
`ba.lm_iterations` (each rotational phase's iterations, and the homography
loop's), summed over the profiled stitches and divided by them."""

from pano_bench import spans

UNIT = "iters/folder"
LAYER = "models/bundle, models/bundle_h, kernels/ba"
MOVES = "stitch_s"
install = spans.install


def read(ctx):
    n = spans.counter(ctx, "ba.lm_iterations")
    return None if n is None else n / len(spans.stitches(ctx))
