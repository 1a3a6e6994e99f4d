"""Kernel B1's share of the least time its work needs: the flops its
launches in a traced window needed (`work.pooled_flops`,
`work.pair_flops`, counted from each launch's inputs) at the TF32 tensor-core
peak, over the device time of B1's kernels in the trace, found by name.
No float32-accurate implementation beats that bound, whatever it runs
(the port's runs 3xTF32). Silent where B1 ran its bf16 instance, which has
another peak, or did not run."""

from pano_bench import devtrace, work

UNIT = "%"
LAYER = "kernels/knn (B1)"
MOVES = "stitch_s"
NAMES = {"knn_kernel", "knn_pairs_kernel", "knn_bf16_kernel", "knn_pairs_bf16_kernel",
         "row_norms", "row_prep_bf16", "refine"}


def install(store):
    """Record each launch's inputs (references to the id and mask tensors,
    read after the window). Returns the undo."""
    from autopanostitch_tpu_torch.kernels import knn as mod

    calls = store.setdefault("knn_calls", [])
    pooled, pairs = mod._knn_cuda, mod._knn_pairs_cuda

    def pooled_rec(desc_q, qid, desc_t, tid, k, self_idx, compute_dtype):
        calls.append(("pooled", qid, tid, desc_q.shape[1], compute_dtype))
        return pooled(desc_q, qid, desc_t, tid, k, self_idx, compute_dtype)

    def pairs_rec(desc, valid, pair_list, k, compute_dtype):
        calls.append(("pairs", valid, pair_list, desc.shape[2], compute_dtype))
        return pairs(desc, valid, pair_list, k, compute_dtype)

    mod._knn_cuda, mod._knn_pairs_cuda = pooled_rec, pairs_rec

    def undo():
        mod._knn_cuda, mod._knn_pairs_cuda = pooled, pairs

    return undo


def read(ctx):
    calls = ctx.store.get("knn_calls")
    peak = work.peak(ctx.device_kind, "tf32_flop_s")
    if not calls or ctx.trace is None or peak is None:
        return None
    if any(c[4] != "float32" for c in calls):
        return None
    flops = 0.0
    for kind, a, b, D, _ in calls:
        count = work.pooled_flops if kind == "pooled" else work.pair_flops
        flops += count(a.cpu().numpy(), b.cpu().numpy(), D)
    t = ctx.trace.device_seconds(lambda name: devtrace.kernel_id(name) in NAMES)
    if t <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (peak * t)
