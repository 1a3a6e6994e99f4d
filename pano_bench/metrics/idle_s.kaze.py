"""Seconds a folder in which the device was idle while the host was inside
a `kaze.scale_space` span (`ops/kaze.py`, one an image group): the
program's spans (`pano_bench/spans.py`) against the device's busy
intervals in the trace, summed over the profiled stitches and divided by
them. Silent where no stitch recorded such a span."""

from pano_bench import spans

UNIT = "s/folder"
LAYER = "ops/kaze"
MOVES = "stitch_s"
SPAN = "kaze.scale_space"
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
