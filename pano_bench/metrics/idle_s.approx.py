"""Seconds a folder in which the device was idle while the host was inside
a `matching.approx` span (`ops/matching.py`, one a call of the approximate
pooled matcher): the program's spans (`pano_bench/spans.py`) against the
device's busy intervals in the trace, summed over the profiled stitches
and divided by them. Silent where no stitch recorded such a span."""

from pano_bench import spans

UNIT = "s/folder"
LAYER = "ops/matching (approximate)"
MOVES = "stitch_s"
SPAN = "matching.approx"
install = spans.install


def read(ctx):
    kept = spans.stitches(ctx)
    if kept is None or ctx.trace is None:
        return None
    seg = ctx.trace.segments
    inside = [(a, b) for k in kept for n, a, b in k.spans if n == SPAN]
    if not inside:
        return None
    return sum(spans.idle_ns(seg, a, b) for a, b in inside) * 1e-9 / len(kept)
