"""Batched RANSAC / MSAC verification of candidate pairs (port of
`ops/ransac.py`: the five transformation models, both scoring methods and
the adaptive two-phase budget).

All pairs and all hypotheses of a sub-batch run as one batched tensor
program: minimal sets by Gumbel top-k under the validity mask, the model's
minimal solver, symmetric transfer error over every match, best-by-score
(inlier count for RANSAC, truncated squared loss for MLESAC), then an IRLS
weighted refit that is kept only if it loses no inliers.

Random streams: the Gumbel noise comes from an explicit torch.Generator.
It cannot reproduce the reference's threefry keys, so `ransac_fit` also
takes precomputed minimal-set indices (the tests inject the reference's).
Torch cannot continue a threefry stream either: the adaptive budget's
second phase draws afresh from the generator for the continued pairs only
(with injected sets it takes the sets after the first sub-batch).
"""

from __future__ import annotations

import math
from itertools import combinations

import numpy as np
import torch

from autopanostitch_tpu_torch.ops import geometry as geo
from autopanostitch_tpu_torch.utils import trace

# (minimal-case fitter, weighted refit fitter, minimal point count)
_MODEL_FITTERS = {
    "projective": (geo.fit_homography_4pt, geo.fit_homography_dlt, 4),
    "affine": (geo.fit_affine, geo.fit_affine, 3),
    "similarity": (geo.fit_similarity, geo.fit_similarity, 2),
    "rigid": (geo.fit_rigid, geo.fit_rigid, 2),
    "translation": (geo.fit_translation, geo.fit_translation, 1),
}
_DESIGN_INLIER_RATIO = 0.3
_IRLS_ITERS = 3
_MAX_ELEMS = 1 << 26  # bounds the (pairs, hypotheses, matches) error tensor


def model_min_pts(model: str) -> int:
    """Minimal correspondences of the model."""
    return _MODEL_FITTERS[model][2]


def num_trials(confidence: float, model: str, max_iter: int) -> int:
    """ceil(log(1-p) / log(1-w^s)) at the design inlier ratio, capped at
    max_iter and rounded up to a multiple of 64 only within the cap."""
    s = model_min_pts(model)
    if confidence >= 100.0:
        n_conf = max_iter
    else:
        n_conf = math.ceil(
            math.log(max(1.0 - confidence / 100.0, 1e-12))
            / math.log(1.0 - _DESIGN_INLIER_RATIO**s)
        )
    total = max(1, min(int(max_iter), int(n_conf)))
    rounded = ((total + 63) // 64) * 64
    return rounded if rounded <= max_iter else total


def num_trials_observed(confidence: float, model: str, w, max_iter: int):
    """The same formula at each pair's observed inlier ratio w (host numpy):
    how many hypotheses a pair needs, capped at max_iter."""
    s = model_min_pts(model)
    if confidence >= 100.0:
        return np.full(np.shape(w), max_iter, np.int64)
    w = np.clip(np.asarray(w, np.float64), 0.0, 0.9999)
    denom = np.log1p(-np.minimum(w**s, 1 - 1e-12))
    num = np.log(max(1.0 - confidence / 100.0, 1e-12))
    with np.errstate(divide="ignore"):
        needed = np.where(denom < 0, np.ceil(num / denom), np.inf)
    return np.minimum(needed, max_iter).astype(np.int64)


def sample_minimal_sets(mask, batch: int, min_pts: int, generator: torch.Generator):
    """(P, batch, min_pts) indices drawn without replacement from each
    pair's valid rows: Gumbel noise + log(mask), then top-k."""
    P, M = mask.shape
    u = torch.rand((P, batch, M), generator=generator, device=mask.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-30)))
    logp = torch.where(mask, 0.0, float("-inf"))
    return torch.topk(g + logp[:, None, :], min_pts, dim=-1).indices


def draw_minimal_sets(pair_mask, model: str = "projective", batch: int = 512,
                      total: int | None = None, generator: torch.Generator | None = None,
                      device=None):
    """The minimal sets of a fixed budget (no `adaptive_first`), drawn from
    `generator` per memory-bounded group of pairs, per sub-batch: what
    `verify_pairs` verifies with. Any slice of them verifies its pairs as
    the whole call does, whatever the split
    (`parallel.sharded.sharded_verify_pairs`). pair_mask (P, M) numpy;
    returns (P, nsub, sub, min_pts) int64 on `device`."""
    min_pts = model_min_pts(model)
    msk = torch.as_tensor(np.asarray(pair_mask, bool), device=device)
    P, M = msk.shape
    total = batch if total is None else total
    sub = min(batch, total)
    nsub = max(1, -(-total // sub))
    step = max(1, _MAX_ELEMS // (sub * M))
    groups = [torch.zeros((0, nsub, sub, min_pts), dtype=torch.long, device=msk.device)]
    for s in range(0, P, step):
        groups.append(torch.stack([sample_minimal_sets(msk[s : s + step], sub, min_pts, generator)
                                   for _ in range(nsub)], 1))
    return torch.cat(groups)


def _minimal_set_degenerate(pts, tol: float = 1.0):
    """(..., p, 2) -> (...) bool: coincident (p == 2) or nearly collinear
    (some point within `tol` px of the line through two others)."""
    p = pts.shape[-2]
    if p <= 1:
        return torch.zeros(pts.shape[:-2], dtype=torch.bool, device=pts.device)
    if p == 2:
        return torch.linalg.vector_norm(pts[..., 0, :] - pts[..., 1, :], dim=-1) < tol
    degen = torch.zeros(pts.shape[:-2], dtype=torch.bool, device=pts.device)
    for a, b, c in combinations(range(p), 3):
        v1 = pts[..., b, :] - pts[..., a, :]
        v2 = pts[..., c, :] - pts[..., a, :]
        area = (v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0]).abs()
        base = torch.linalg.vector_norm(v1, dim=-1)
        degen = degen | (area < tol * torch.clamp(base, min=1e-6))
    return degen


def _score(err, mask, threshold: float, method: str):
    """(cost, inliers, n_inliers) of (..., B, M) errors; mask (..., 1, M)."""
    inl = (err < threshold) & mask
    n_inl = inl.sum(-1)
    if method == "ransac":
        cost = -n_inl.float()
    else:  # msac / mlesac: truncated squared loss
        e2 = torch.clamp(err * err, max=threshold * threshold)
        cost = torch.where(mask, e2, torch.zeros_like(e2)).sum(-1)
    return cost, inl, n_inl


def ransac_fit(src, dst, mask, threshold: float = 5.5, model: str = "projective",
               method: str = "ransac", batch: int = 512,
               total: int | None = None, generator: torch.Generator | None = None,
               minimal_sets=None, init=None):
    """Robust model src -> dst for P pairs at once.

    src/dst (P, M, 2), mask (P, M). The budget `total` runs in sub-batches
    of min(batch, total) hypotheses with a running best. `minimal_sets`
    (P, nsub, sub, p) replaces the generator's draws (and sets the
    sub-batches). `init` = (cost (P,), H (P, 3, 3), inliers (P, M)) starts
    from an earlier phase's pre-refit best. Returns dict of H (P, 3, 3),
    inliers (P, M), num_inliers, num_putative, success, and that pre-refit
    best as raw_cost, raw_H, raw_inliers."""
    fit_min, fit_refit, min_pts = _MODEL_FITTERS[model]
    P, M, _ = src.shape
    dev = src.device
    n_valid = mask.sum(-1)
    if total is None:
        total = batch
    if minimal_sets is not None:
        nsub, sub = minimal_sets.shape[1:3]
    else:
        nsub = max(1, (total + batch - 1) // batch)
        sub = min(batch, total)
    m1 = mask[:, None, :]
    src1, dst1 = src[:, None], dst[:, None]

    if init is None:
        c_best = torch.full((P,), float("inf"), device=dev)
        H0 = torch.eye(3, device=dev).expand(P, 3, 3).clone()
        inl0 = torch.zeros((P, M), dtype=torch.bool, device=dev)
    else:
        c_best, H0, inl0 = (x.to(dev) for x in init)
    n_best = (inl0 & mask).sum(-1)
    ones = torch.ones((P, sub, min_pts), dtype=src.dtype, device=dev)
    for c in range(nsub):
        if minimal_sets is not None:
            idx = minimal_sets[:, c].long()
        else:
            idx = sample_minimal_sets(mask, sub, min_pts, generator)
        gi = idx[..., None].expand(-1, -1, -1, 2)
        src_min = torch.gather(src1.expand(-1, sub, -1, -1), 2, gi)  # (P, sub, p, 2)
        dst_min = torch.gather(dst1.expand(-1, sub, -1, -1), 2, gi)
        Hs = fit_min(src_min, dst_min, ones)
        err = geo.symmetric_transfer_error(Hs, src1, dst1)  # (P, sub, M)
        err = torch.where(torch.isfinite(err), err, torch.full_like(err, 1e9))
        cost, inl, n_inl = _score(err, m1, threshold, method)
        ok = geo.homography_is_valid(Hs) & ~(
            _minimal_set_degenerate(src_min) | _minimal_set_degenerate(dst_min)
        )
        cost = torch.where(ok, cost, torch.full_like(cost, 1e30))
        best = torch.argmin(cost, dim=-1)
        ar = torch.arange(P, device=dev)
        c2, H2, i2, n2 = cost[ar, best], Hs[ar, best], inl[ar, best], n_inl[ar, best]
        better = c2 < c_best
        c_best = torch.where(better, c2, c_best)
        H0 = torch.where(better[:, None, None], H2, H0)
        inl0 = torch.where(better[:, None], i2, inl0)
        n_best = torch.where(better, n2, n_best)

    # IRLS refit on the winning inliers
    w = inl0.float()
    H_ref = H0
    for _ in range(_IRLS_ITERS):
        H_ref = fit_refit(src, dst, w)
        e = geo.symmetric_transfer_error(H_ref, src, dst)
        w = torch.where((e < threshold) & mask,
                        1.0 / torch.clamp(e / threshold, min=0.5), torch.zeros_like(e))
    e_ref = geo.symmetric_transfer_error(H_ref, src, dst)
    inl_ref = (e_ref < threshold) & mask & torch.isfinite(e_ref)
    use_ref = (inl_ref.sum(-1) >= n_best) & geo.homography_is_valid(H_ref)
    H_final = torch.where(use_ref[:, None, None], H_ref, H0)
    inl_final = torch.where(use_ref[:, None], inl_ref, inl0)
    n_final = inl_final.sum(-1)
    success = (n_final >= min_pts) & (n_valid >= min_pts) & geo.homography_is_valid(H_final)
    H_final = torch.where(success[:, None, None], H_final, torch.eye(3, device=dev))
    return {
        "H": H_final,
        "inliers": inl_final & success[:, None],
        "num_inliers": n_final * success,
        "num_putative": n_valid,
        "success": success,
        "raw_cost": c_best,
        "raw_H": H0,
        "raw_inliers": inl0,
    }


def verify_pairs(pair_src, pair_dst, pair_mask, threshold: float = 5.5,
                 model: str = "projective", method: str = "ransac", batch: int = 512,
                 accept_alpha: float = 8.0, accept_beta: float = 0.3,
                 accept_small_min: float | None = None, accept_small_ratio: float = 0.9,
                 total: int | None = None, adaptive_first: int | None = None,
                 confidence: float = 99.9, generator: torch.Generator | None = None,
                 minimal_sets=None, device=None):
    """Verify P candidate pairs: batched RANSAC + Brown-Lowe acceptance
    `ni > alpha + beta nf`, OR-ed with the small-sample branch
    `ni >= max(small_min, min_pts + 5) and ni >= small_ratio nf`.

    Adaptive two-phase budget (`adaptive_first` = F < total): phase A
    spends F hypotheses on every pair; `num_trials_observed` at each pair's
    inlier ratio decides which pairs need more, and only those run phase B,
    the remaining total - F hypotheses in sub-batches of F, starting from
    phase A's pre-refit best. `verify_pairs.last_stats` records the split
    as the reference does.

    pair_src/pair_dst (P, M, 2), pair_mask (P, M) numpy arrays;
    `minimal_sets` (P, nsub, sub, p) as `ransac_fit` takes them (adaptive:
    [:, :1] for phase A, [continued, 1:] for phase B). Pairs run in groups
    of at most `_MAX_ELEMS` / (hypotheses x M) to bound the (pairs,
    hypotheses, matches) error tensor. Returns numpy arrays H, H_inv,
    inliers, num_inliers, num_putative, accepted."""
    min_pts = model_min_pts(model)
    P, M = np.shape(pair_mask)
    if P == 0:
        return {
            "H": np.zeros((0, 3, 3), np.float32), "H_inv": np.zeros((0, 3, 3), np.float32),
            "inliers": np.zeros((0, M), bool), "num_inliers": np.zeros((0,), np.int32),
            "num_putative": np.zeros((0,), np.int32), "accepted": np.zeros((0,), bool),
        }
    if accept_small_min is not None:
        accept_small_min = max(float(accept_small_min), min_pts + 5.0)
    small_min = float("inf") if accept_small_min is None else accept_small_min
    if total is None:
        total = batch
    with trace.span("ransac.upload"):
        src = torch.as_tensor(np.asarray(pair_src, np.float32), device=device)
        dst = torch.as_tensor(np.asarray(pair_dst, np.float32), device=device)
        msk = torch.as_tensor(np.asarray(pair_mask, bool), device=device)

    def run(sel, sub, tot, sets, init=None):
        """ransac_fit over the pairs `sel` (an index array or None = all) in
        memory-bounded groups."""
        s_, d_, m_ = (x if sel is None else x[sel] for x in (src, dst, msk))
        n = m_.shape[0]
        step = max(1, _MAX_ELEMS // (sub * M))
        outs = []
        for s in range(0, n, step):
            e = min(n, s + step)
            outs.append(ransac_fit(
                s_[s:e], d_[s:e], m_[s:e], threshold=threshold, model=model, method=method,
                batch=sub, total=tot, generator=generator,
                minimal_sets=None if sets is None else sets[s:e],
                init=None if init is None else tuple(x[s:e] for x in init),
            ))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    if not (adaptive_first is not None and 0 < adaptive_first < total):
        verify_pairs.last_stats = {
            "n_pairs": int(P), "total": int(total), "first": int(total), "n_continued": 0,
            "m_matches": int(M), "trials_spent": float(P * total),
        }
        if minimal_sets is None:
            with trace.span("ransac.draw"):
                minimal_sets = draw_minimal_sets(pair_mask, model, batch, total, generator,
                                                 src.device)
        with trace.span("ransac.phase_a"):
            res = run(None, min(batch, total), total, minimal_sets)
    else:
        first = int(adaptive_first)
        with trace.span("ransac.phase_a"):
            res = run(None, first, first, None if minimal_sets is None else minimal_sets[:, :1])
            ni = res["num_inliers"].cpu().numpy()
            w = ni / np.maximum(res["num_putative"].cpu().numpy(), 1)
            cont = np.nonzero(num_trials_observed(confidence, model, w, total) > first)[0]
        verify_pairs.last_stats = {
            "n_pairs": int(P), "total": int(total), "first": first,
            "n_continued": int(len(cont)), "m_matches": int(M),
            "trials_spent": float(P * first + len(cont) * (total - first)),
        }
        if len(cont):
            with trace.span("ransac.phase_b"):
                ci = torch.as_tensor(cont, device=src.device)
                out_b = run(ci, first, total - first,
                            None if minimal_sets is None
                            else minimal_sets[torch.as_tensor(cont), 1:],
                            init=(res["raw_cost"][ci], res["raw_H"][ci], res["raw_inliers"][ci]))
                for k in res:
                    res[k][ci] = out_b[k]
    ni = res["num_inliers"].float()
    nf = res["num_putative"].float()
    accepted = res["success"] & (
        (ni > accept_alpha + accept_beta * nf)
        | ((ni >= small_min) & (ni >= accept_small_ratio * nf))
    )
    with trace.span("ransac.readback"):
        out = {
            "H": res["H"].cpu().numpy(),
            "H_inv": geo.homography_inverse(res["H"]).cpu().numpy(),
            "inliers": res["inliers"].cpu().numpy(),
            "num_inliers": res["num_inliers"].to(torch.int32).cpu().numpy(),
            "num_putative": res["num_putative"].to(torch.int32).cpu().numpy(),
            "accepted": accepted.cpu().numpy(),
        }
    trace.count("ransac.pairs", int(P))
    trace.count("ransac.accepted", int(out["accepted"].sum()))
    trace.count("ransac.trials", verify_pairs.last_stats["trials_spent"])
    return out
