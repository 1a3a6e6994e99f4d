"""Share of a traced window in which no kernel, copy or set ran on the
device: 100 (1 - union of the device's operation intervals / window), from
the profiler's trace."""

UNIT = "%"
LAYER = "device"
MOVES = "stitch_s"


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
