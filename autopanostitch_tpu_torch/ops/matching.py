"""Descriptor matching (port of `ops/matching.py`).

- Pooled global matching: `global_knn` IS kernel B1 (`kernels/knn.py`) in
  its pooled mode, the exact k-NN with same-image and invalid rows masked;
  the ratio test runs on the device; the pair bookkeeping (`knn_votes`,
  `global_matches_to_pairs`) is host numpy, copied from the reference.
- Pairwise matching: `two_nn`, `match_pair`, `match_pair_list` and
  `match_all_pairs` run on B1's pair-list mode (`knn.knn_pairs`): a pair
  list is one launch per memory-bounded chunk, and the ratio test, mutual
  check and compaction are batched over the pairs on the device.

- The approximate pooled method (`global_knn(method="approximate")`):
  plain PyTorch on the card, as the reference's is XLA and not a kernel:
  per query block a 32-d random-projection sketch ranks every target, the
  8k best go through exact expansion-form distances, and the k nearest of
  those are kept. It records the span `matching.approx` (beneath the
  pipeline's `matching.knn`) with `matching.approx.project` (desc @ G,
  once a call) and, for each query block, `matching.approx.rank` (the
  sketch distances, the masks, the sort) and `matching.approx.rerank` (the
  gather, the exact distances, the top-k), and adds to the counters
  `matching.approx_blocks`, `matching.approx_rows` (query rows),
  `matching.approx_candidates` (rows x min(8k, F)) and
  `matching.approx_sorted_keys` (the keys the blocks' sorts take, b x F a
  block of b rows), all counted from shapes on the host
  (`utils/trace.py`).

Every distance's cross term q.t runs in `compute_dtype` ("float32" or
"bfloat16", the reference's `cfg.tpu.compute_dtype`), with float32 norms
and sums.

Binary ({0,1}) descriptors of the corner detectors run the same kernel:
their squared L2 IS the Hamming distance. `binary=True` switches the ratio
test to raw distances and the threshold to percent mismatched bits, as the
reference does. On {0,1} every bf16 product is exact and every sum an
integer, so B1 runs them on its bf16 instance under either compute dtype
(one product a k-step where 3xTF32 takes three, and no refinement), with
results identical to the float32 ones.
"""

from __future__ import annotations

import numpy as np
import torch

from autopanostitch_tpu_torch.kernels.knn import check_compute_dtype, knn, knn_pairs, operand
from autopanostitch_tpu_torch.ops.sift import top_k_stable
from autopanostitch_tpu_torch.utils import threefry, trace

_BIG = np.float32(1e18)
_PAIR_CHUNK_BYTES = 1 << 30  # bound of `match_pair_list`'s working set per chunk
# per pair and descriptor slot: the 2-NN both ways (32 B) and the
# temporaries of `_match_from_nn` (distances, long indices, the sort)
_PAIR_BYTES_PER_SLOT = 128
METHODS = ("exhaustive", "approximate")
SKETCH_SEED = 12345  # the reference's PRNGKey of the sketch matrix
SKETCH_DIM = 32


def check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"matching method {method!r} is not one of {METHODS}")


def _kernel_dtype(compute_dtype: str, binary: bool) -> str:
    """The operand type B1 runs: bf16 for binary descriptors (exact there,
    see the module doc), else `compute_dtype`."""
    return "bfloat16" if binary else compute_dtype


def sketch_matrix(D: int, device) -> torch.Tensor:
    """The approximate matcher's (D, 32) projection, the reference's
    `jax.random.normal(PRNGKey(12345), (D, 32)) / sqrt(32)` (drawn by
    `utils.threefry`)."""
    G = threefry.normal(SKETCH_SEED, (D, SKETCH_DIM)) / np.sqrt(np.float32(SKETCH_DIM))
    return torch.as_tensor(G.astype(np.float32), device=device)


def _sqdist(a, b, compute_dtype: str):
    """`pairwise_sqdist` of the reference: max(|a|^2 + |b|^2 - 2 a.b, 0),
    norms in float32, the cross term in `compute_dtype`."""
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    ab = operand(a, compute_dtype) @ operand(b, compute_dtype).T
    return torch.clamp(na[:, None] + nb[None, :] - 2.0 * ab, min=0.0)


def _approximate_knn(desc, mask, image_id, k: int, block: int, compute_dtype: str):
    """The reference's approximate pooled kNN (`global_knn`, D > 32): per
    query block, squared distances in the 32-d sketch `desc @ G` with the
    same masks, the min(8k, F) best candidates (ties -> lower index), their
    expansion-form distances (candidates masked in the sketch stay at
    1e18), and the k nearest of those."""
    F, D = desc.shape
    big = float(_BIG)
    n_cand = min(8 * k, F)
    with trace.span("matching.approx"):
        trace.count("matching.approx_blocks", -(-F // block))
        trace.count("matching.approx_rows", F)
        trace.count("matching.approx_candidates", F * n_cand)
        with trace.span("matching.approx.project"):
            desc_s = desc @ sketch_matrix(D, desc.device)  # (F, 32)
        idx_out, d_out = [], []
        for s in range(0, F, block):
            q, qs = desc[s : s + block], desc_s[s : s + block]
            with trace.span("matching.approx.rank"):
                trace.count("matching.approx_sorted_keys", q.shape[0] * F)
                bad = ((image_id[s : s + block, None] == image_id[None, :]) | ~mask[None, :]
                       | ~mask[s : s + block, None])
                d_s = torch.where(bad, big, _sqdist(qs, desc_s, compute_dtype))
                cand = top_k_stable(-d_s, n_cand)[1]  # (b, C)
            with trace.span("matching.approx.rerank"):
                dc = desc[cand]  # (b, C, D)
                qn = torch.sum(q * q, dim=-1)
                tn = torch.sum(dc * dc, dim=-1)
                qt = torch.bmm(operand(dc, compute_dtype),
                               operand(q, compute_dtype)[:, :, None])[..., 0]
                d_ex = torch.clamp(qn[:, None] + tn - 2.0 * qt, min=0.0)
                d_ex = torch.where(torch.gather(d_s, 1, cand) >= big, big, d_ex)
                vals, ii = top_k_stable(-d_ex, k)
                idx_out.append(torch.gather(cand, 1, ii).to(torch.int32))
                d_out.append(-vals)
        return torch.cat(idx_out), torch.cat(d_out)


def global_knn(desc, mask, image_id, k: int = 4, method: str = "exhaustive",
               compute_dtype: str = "float32", block: int = 1024, binary: bool = False):
    """Pooled self-kNN over all images' descriptors, same-image and invalid
    rows excluded before the top-k. desc (F, D), mask (F,), image_id (F,).
    `method` "exhaustive" (kernel B1) or "approximate" (a 32-d sketch's
    8k candidates re-ranked exactly, D > 32; narrower descriptors run the
    exhaustive path, as in the reference), `block` the approximate path's
    query rows a step (the reference's `cfg.tpu.match_block`), `binary`
    for {0,1} descriptors (see the module doc). Returns nn_idx (F, k)
    int32, nn_dist (F, k) float32 ascending (masked -> 1e18)."""
    check_method(method)
    check_compute_dtype(compute_dtype)
    d = desc.float().contiguous()
    if method == "approximate" and d.shape[1] > SKETCH_DIM:
        return _approximate_knn(d, mask, image_id, k, block, compute_dtype)
    ids = torch.where(mask, image_id.to(torch.int32), torch.full_like(image_id, -2, dtype=torch.int32))
    ids = ids.contiguous()
    return knn(d, ids, d, ids, k, compute_dtype=_kernel_dtype(compute_dtype, binary))


def global_ratio_test(nn_idx, nn_dist, ratio: float = 0.6, binary: bool = False):
    """Lowe ratio on the two best cross-image neighbours: d1 < r^2 d2 on
    squared distances, or d1 < r d2 on the raw Hamming distances of binary
    descriptors. Returns (best (F,), accepted (F,))."""
    d1 = nn_dist[:, 0]
    d2 = nn_dist[:, 1]
    r = ratio if binary else ratio * ratio
    return nn_idx[:, 0], (d1 < r * d2) & (d1 < float(_BIG))


def global_match_stack(desc, mask, k: int = 4, method: str = "exhaustive",
                       ratio: float = 0.6, binary: bool = False,
                       compute_dtype: str = "float32", block: int = 1024):
    """Pool (N, K, D) descriptors, kNN, ratio test. Returns
    (nn_idx (F, k), nn_dist (F, k), best (F,), accepted (F,)), F = N * K."""
    N, K, D = desc.shape
    image_id = torch.arange(N, dtype=torch.int32, device=desc.device).repeat_interleave(K)
    nn_idx, nn_dist = global_knn(desc.reshape(N * K, D), mask.reshape(N * K), image_id,
                                 k=k, method=method, compute_dtype=compute_dtype, block=block,
                                 binary=binary)
    best, accepted = global_ratio_test(nn_idx, nn_dist, ratio=ratio, binary=binary)
    return nn_idx, nn_dist, best, accepted


def _pair_stack(desc_a, mask_a, desc_b, mask_b):
    """Two descriptor sets as a (2, K, D) slot stack, the shorter padded
    with invalid slots (they sort after every real slot, valid or not)."""
    K = max(desc_a.shape[0], desc_b.shape[0])

    def pad(d, m):
        extra = K - d.shape[0]
        return (torch.nn.functional.pad(d.float(), (0, 0, 0, extra)),
                torch.nn.functional.pad(m, (0, extra)))

    (da, ma), (db, mb) = pad(desc_a, mask_a), pad(desc_b, mask_b)
    return torch.stack([da, db]), torch.stack([ma, mb])


def two_nn(desc_q, mask_q, desc_t, mask_t, compute_dtype: str = "float32"):
    """Exact 2-nearest-neighbour in SSD space (the cross term in
    `compute_dtype`). Returns (idx1 (Mq,), d1, d2): best target index and
    the best and second squared distances. Only invalid targets are masked
    in the search; invalid queries keep their true idx1 and get d1 = d2 =
    1e18 (`two_nn` of the reference)."""
    desc, valid = _pair_stack(desc_q, mask_q, desc_t, mask_t)
    pairs = torch.tensor([[0, 1]], dtype=torch.int32, device=desc.device)
    idx, dist = knn_pairs(desc.contiguous(), valid, pairs, 2, compute_dtype=compute_dtype)
    Mq = desc_q.shape[0]
    idx, dist = idx[0, 0, :Mq], dist[0, 0, :Mq]
    big = torch.full_like(dist[:, 0], float(_BIG))
    return (idx[:, 0], torch.where(mask_q, dist[:, 0], big),
            torch.where(mask_q, dist[:, 1], big))


def _threshold_cut(threshold: float, binary: bool, D: int) -> float:
    """The distance cut: the SSD threshold itself, or (threshold / 100) D
    mismatched bits for binary descriptors, in float32 as the reference
    computes it (a true division)."""
    if not binary:
        return threshold
    t = torch.tensor(threshold, dtype=torch.float32)
    return float(t / torch.tensor(100.0) * D)


def _match_from_nn(idx, dist, mask_a, ratio: float, max_matches: int, threshold: float,
                   rule: str = "float"):
    """Ratio test, threshold, mutual check and compaction of a batch of
    pairs from their 2-NN both ways: idx/dist (P, 2, K, 2) as `knn_pairs`
    gives them (side 0 = a -> b, side 1 = b -> a), mask_a (P, Ka) the valid
    slots of image a (Ka <= K: side 0 is read for a's Ka queries);
    `threshold` is the cut of `_threshold_cut`. The ratio test by `rule`:
    "float" d1 < r^2 d2, "binary" d1 <= r d2 (`match_pair` on binary
    descriptors), "hamming" d1 < r d2 (`hamming.match_pair_hamming`).
    Returns (idx (P, M, 2) int32, m (P, M) bool, n (P,) int32), the
    reference's `match_pair` per pair."""
    Ka = mask_a.shape[1]
    big = float(_BIG)
    ia2b = idx[:, 0, :Ka, 0].long()
    d1 = torch.where(mask_a, dist[:, 0, :Ka, 0], torch.full_like(dist[:, 0, :Ka, 0], big))
    d2 = torch.where(mask_a, dist[:, 0, :Ka, 1], torch.full_like(dist[:, 0, :Ka, 1], big))
    ib2a = idx[:, 1, :, 0].long()
    # the reference takes the ratio as a float32 (a traced scalar in its
    # jit): squared against squared distances, linear against the raw
    # Hamming distances of binary descriptors
    r = torch.tensor(ratio, dtype=torch.float32, device=dist.device)
    if rule == "float":
        pass_ratio = d1 < (r * r) * d2
    elif rule == "binary":
        pass_ratio = d1 <= r * d2
    else:
        pass_ratio = d1 < r * d2
    mutual = torch.gather(ib2a, 1, ia2b) == torch.arange(Ka, device=idx.device)[None]
    ok = pass_ratio & (d1 <= threshold) & mutual & mask_a & (d1 < big)
    # compact to the front by ascending distance; the sort is STABLE, so the
    # rows that fail (all at BIG) keep index order, as jnp.argsort does
    order = torch.sort(torch.where(ok, d1, torch.full_like(d1, big)), dim=1, stable=True)[1]
    take = min(max_matches, Ka)
    sel = order[:, :take]
    out = torch.stack([sel, torch.gather(ia2b, 1, sel)], -1).to(torch.int32)
    m = torch.gather(ok, 1, sel)
    if take < max_matches:
        out = torch.nn.functional.pad(out, (0, 0, 0, max_matches - take))
        m = torch.nn.functional.pad(m, (0, max_matches - take))
    out = torch.where(m[..., None], out, torch.zeros_like(out))
    return out, m, ok.sum(1).to(torch.int32)


def match_pair(desc_a, mask_a, desc_b, mask_b, ratio: float = 0.6, max_matches: int = 512,
               threshold: float = float("inf"), binary: bool = False,
               compute_dtype: str = "float32"):
    """Match two descriptor sets: 2-NN both ways, Lowe ratio (d1 < r^2 d2
    on squared distances; binary: d1 <= r d2 on Hamming distances),
    threshold (SSD; binary: percent of the bits), mutual nearest check,
    compaction by ascending distance. Returns (idx (max_matches, 2) int32
    [ia, ib] padded 0, m (max_matches,) bool, n () int32)."""
    desc, valid = _pair_stack(desc_a, mask_a, desc_b, mask_b)
    pairs = torch.tensor([[0, 1]], dtype=torch.int32, device=desc.device)
    idx, dist = knn_pairs(desc.contiguous(), valid, pairs, 2,
                          compute_dtype=_kernel_dtype(compute_dtype, binary))
    out, m, n = _match_from_nn(idx, dist, mask_a[None], ratio, max_matches,
                               _threshold_cut(threshold, binary, desc.shape[-1]),
                               "binary" if binary else "float")
    return out[0], m[0], n[0]


def match_pair_list(desc, mask, pairs, ratio: float = 0.6, max_matches: int = 512,
                    threshold: float = float("inf"), binary: bool = False,
                    compute_dtype: str = "float32"):
    """Pairwise matching of an explicit (P, 2) image pair list. desc (N, K,
    D), mask (N, K), pairs (P, 2) int on the same device. The pairs go to
    kernel B1 in chunks whose working set stays near `_PAIR_CHUNK_BYTES`
    (one launch up to ~4000 pairs of 2048 slots; the reference's 16-pair
    `lax.scan` chunks were TPU memory shaping). Returns (idx (P,
    max_matches, 2), m (P, max_matches), counts (P,)) aligned with the
    pair list."""
    pairs = torch.as_tensor(pairs, dtype=torch.int32, device=desc.device).contiguous()
    if pairs.shape[0] == 0:
        return (torch.zeros((0, max_matches, 2), dtype=torch.int32, device=desc.device),
                torch.zeros((0, max_matches), dtype=torch.bool, device=desc.device),
                torch.zeros((0,), dtype=torch.int32, device=desc.device))
    desc = desc.float().contiguous()
    cut = _threshold_cut(threshold, binary, desc.shape[-1])
    chunk = max(1, _PAIR_CHUNK_BYTES // (_PAIR_BYTES_PER_SLOT * desc.shape[1]))
    outs = []
    for s in range(0, pairs.shape[0], chunk):
        cp = pairs[s : s + chunk]
        idx, dist = knn_pairs(desc, mask, cp, 2, compute_dtype=_kernel_dtype(compute_dtype, binary))
        outs.append(_match_from_nn(idx, dist, mask[cp[:, 0].long()], ratio, max_matches, cut,
                                   "binary" if binary else "float"))
    return tuple(torch.cat(x) for x in zip(*outs))


def match_all_pairs(desc, mask, ratio: float = 0.6, max_matches: int = 512,
                    threshold: float = float("inf"), binary: bool = False,
                    compute_dtype: str = "float32"):
    """Pairwise matching over every (i < j) image pair. Returns (pairs (P, 2)
    int32 numpy, idx (P, M, 2), m (P, M), counts (P,)), P = N(N-1)/2 in
    lexicographic order."""
    N = desc.shape[0]
    iu, ju = np.triu_indices(N, 1)
    pairs = np.stack([iu, ju], -1).astype(np.int32)
    idx, m, n = match_pair_list(desc, mask, pairs, ratio=ratio, max_matches=max_matches,
                                threshold=threshold, binary=binary, compute_dtype=compute_dtype)
    return pairs, idx, m, n


# ---------------------------------------------------------------------------
# Host bookkeeping (numpy, copied from the reference)
# ---------------------------------------------------------------------------

def knn_votes(nn_idx: np.ndarray, nn_dist: np.ndarray, image_id: np.ndarray,
              n_images: int) -> np.ndarray:
    """(N, N) symmetric cross-image kNN vote counts before the ratio test."""
    nn_idx = np.asarray(nn_idx)
    nn_dist = np.asarray(nn_dist)
    image_id = np.asarray(image_id)
    valid = nn_dist < 1e17
    ti = image_id[nn_idx]
    qi = np.broadcast_to(image_id[:, None], ti.shape)
    votes = np.zeros((n_images, n_images), np.int64)
    np.add.at(votes, (qi[valid], ti[valid]), 1)
    votes = votes + votes.T
    np.fill_diagonal(votes, 0)
    return votes.astype(np.int32)


def global_matches_to_pairs(best, accepted, image_id, local_idx, n_images: int,
                            max_matches: int):
    """Assemble accepted global matches into per-pair fixed-capacity lists.
    Returns (pairs (P, 2), pair_idx (P, M, 2), pair_mask (P, M), counts (N, N))."""
    best = np.asarray(best)
    accepted = np.asarray(accepted).astype(bool)
    image_id = np.asarray(image_id)
    local_idx = np.asarray(local_idx)

    q = np.nonzero(accepted)[0]
    t = best[q]
    qi, ti = image_id[q], image_id[t]
    ql, tl = local_idx[q], local_idx[t]
    swap = qi > ti
    i_img = np.where(swap, ti, qi)
    j_img = np.where(swap, qi, ti)
    i_loc = np.where(swap, tl, ql)
    j_loc = np.where(swap, ql, tl)
    keep = i_img != j_img
    i_img, j_img, i_loc, j_loc = i_img[keep], j_img[keep], i_loc[keep], j_loc[keep]

    key = i_img.astype(np.int64) * n_images + j_img
    pair_and_feats = np.unique(np.stack([key, i_loc, j_loc], axis=1), axis=0)
    key, i_loc, j_loc = pair_and_feats.T

    uniq_keys, start_idx, counts = np.unique(key, return_index=True, return_counts=True)
    P = len(uniq_keys)
    pairs = np.stack([uniq_keys // n_images, uniq_keys % n_images], axis=1).astype(np.int32)
    pair_idx = np.zeros((P, max_matches, 2), np.int32)
    pair_mask = np.zeros((P, max_matches), bool)
    counts_full = np.zeros((n_images, n_images), np.int32)
    for p in range(P):
        s = start_idx[p]
        c = min(int(counts[p]), max_matches)
        pair_idx[p, :c, 0] = i_loc[s : s + c]
        pair_idx[p, :c, 1] = j_loc[s : s + c]
        pair_mask[p, :c] = True
        i, j = pairs[p]
        counts_full[i, j] = counts_full[j, i] = int(counts[p])
    return pairs, pair_idx, pair_mask, counts_full
