"""The approximate pooled matcher's share of the least time its work needs:
the bound of each call of `ops.matching._approximate_knn` in a traced
window (`work_approx`, counted from the call's mask, image ids, width and
k, read after the window: the larger of its flops at the TF32 tensor-core
peak and its bytes at the memory bandwidth), summed, over the device time
between a CUDA event recorded on the current stream before each call and
one after it, summed. No float32-accurate implementation beats that bound.
Silent where no call ran on a card, where a call's `compute_dtype` was not
float32, or on a card not in `work.PEAKS`."""

from pano_bench import work, work_approx

UNIT = "%"
LAYER = "ops/matching (approximate)"
MOVES = "stitch_s"


def install(store):
    """Record each call's mask, ids, width, k and dtype and the events
    around it (read after the window). Returns the undo."""
    import torch

    from autopanostitch_tpu_torch.ops import matching as mod

    calls = store.setdefault("approx_calls", [])
    fn = mod._approximate_knn

    def recorded(desc, mask, image_id, k, block, compute_dtype):
        if desc.device.type != "cuda":
            return fn(desc, mask, image_id, k, block, compute_dtype)
        stream = torch.cuda.current_stream(desc.device)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        out = fn(desc, mask, image_id, k, block, compute_dtype)
        e1.record(stream)
        calls.append((mask, image_id, int(desc.shape[1]), int(k), compute_dtype, e0, e1))
        return out

    mod._approximate_knn = recorded

    def undo():
        mod._approximate_knn = fn

    return undo


def read(ctx):
    calls = ctx.store.get("approx_calls")
    flop_s = work.peak(ctx.device_kind, "tf32_flop_s")
    byte_s = work.peak(ctx.device_kind, "hbm_byte_s")
    if not calls or flop_s is None or byte_s is None:
        return None
    if any(c[4] != "float32" for c in calls):
        return None
    bound = t = 0.0
    for mask, ids, D, k, _, e0, e1 in calls:
        e1.synchronize()
        t += e0.elapsed_time(e1) / 1e3
        bound += work_approx.bound_s(mask.cpu().numpy(), ids.cpu().numpy(), D, k, flop_s, byte_s)
    if t <= 0:
        return None
    return 100.0 * bound / t
