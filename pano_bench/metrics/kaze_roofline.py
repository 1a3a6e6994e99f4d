"""KAZE's nonlinear scale space's share of the least time its work needs:
the bound of each call of `ops.kaze.nonlinear_scale_space` in a traced
window (`work_kaze`, counted from the call's (G, H, W) shape and sigma
list: the larger of its float32 operations at the peak outside the tensor
cores and its bytes at the memory bandwidth), summed, over the device time
between a CUDA event recorded on the current stream before each call and
one after it, summed. No implementation beats that bound. Silent where no
call ran on a card, or on a card not in `work.PEAKS`."""

from pano_bench import work, work_kaze

UNIT = "%"
LAYER = "ops/kaze"
MOVES = "stitch_s"


def install(store):
    """Record each call's shape, sigma list and the events around it (read
    after the window). Returns the undo."""
    import torch

    from autopanostitch_tpu_torch.ops import kaze as mod

    calls = store.setdefault("kaze_calls", [])
    fn = mod.nonlinear_scale_space

    def recorded(img, sigmas, *args, **kwargs):
        if img.device.type != "cuda":
            return fn(img, sigmas, *args, **kwargs)
        stream = torch.cuda.current_stream(img.device)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        out = fn(img, sigmas, *args, **kwargs)
        e1.record(stream)
        calls.append((tuple(img.shape), [float(s) for s in sigmas], e0, e1))
        return out

    mod.nonlinear_scale_space = recorded

    def undo():
        mod.nonlinear_scale_space = fn

    return undo


def read(ctx):
    calls = ctx.store.get("kaze_calls")
    flop_s = work.peak(ctx.device_kind, "fp32_flop_s")
    byte_s = work.peak(ctx.device_kind, "hbm_byte_s")
    if not calls or flop_s is None or byte_s is None:
        return None
    bound = t = 0.0
    for shape, sigmas, e0, e1 in calls:
        e1.synchronize()
        t += e0.elapsed_time(e1) / 1e3
        bound += work_kaze.scale_space_bound_s(shape, sigmas, flop_s, byte_s)
    if t <= 0:
        return None
    return 100.0 * bound / t
