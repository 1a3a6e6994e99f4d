"""Seconds a folder in which the device was idle while the host was inside the
"features" stage: the program's spans (`pano_bench/spans.py`) against the
device's busy intervals in the trace, summed over the profiled stitches and
divided by them."""

from pano_bench import spans

UNIT = "s/folder"
LAYER = "models/features -> ops/sift, kernels/sift_window"
MOVES = "stitch_s"
install = spans.install


def read(ctx):
    return spans.idle_s(ctx, "features")
