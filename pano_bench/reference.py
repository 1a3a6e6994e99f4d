"""The plain reference that decides `correct`, in float64 PyTorch.

It works out again, from the scene a folder was made from (the true
rotations, focal and environment, or the true crop offsets and texture),
what the program should have produced, and reads the program's outputs only
to judge them:

- recognition: which views form which panorama (a distractor in none);
- bundle adjustment: the focal and the rotations up to the gauge (the
  rotation that best maps the estimated frame onto the true one);
- the panorama's pixels, against the environment or texture sampled along
  the same canvas rays (Keys bicubic, as the program's views were made);
- matching: every putative match the program listed is held to the rule
  the configuration states (the nearest cross-image neighbour, passing
  Lowe's ratio on squared distances; or, for a pair the pairwise rescue
  re-matched, the mutual nearest within the pair at the rescue ratio),
  recomputed in float64 from the descriptors the program returned; its
  numbers are the widest excess of a listed match over that rule and the
  widest margin of a match the rule makes that a listed pair leaves out,
  in squared-distance units.

- the homography bundle adjustment (planar scans): how far the program's
  homographies lie above the least cost of the objective the
  configuration states, over the inliers the program listed (this follows
  the program's state; the inliers themselves are judged through the
  corner error and the match numbers).

The arithmetic of the first three is `chip_smoke.py`'s (`pano_psnr`,
`multipano_metrics`, `planar_metrics`). Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from pano_bench.scenes import synth



def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def members_wrong(expected: List[np.ndarray], got: List[np.ndarray], n_views: int) -> int:
    """Views whose panorama differs from the expected one: each view's group
    (the set of views stitched with it, or none) compared whole."""
    def groups(sets):
        g = [frozenset()] * n_views
        for s in sets:
            fs = frozenset(int(v) for v in s)
            for v in fs:
                g[v] = fs
        return g

    e, o = groups(expected), groups(got)
    return sum(1 for v in range(n_views) if e[v] != o[v])


def gauge(R_est: np.ndarray, R_true: np.ndarray) -> np.ndarray:
    """The rotation G that best maps each estimated rotation onto the true
    one (R_true ~ R_est G), from the polar part of sum R_est^T R_true."""
    M = sum(R_est[i].T @ R_true[i] for i in range(len(R_true)))
    U, _, Vt = np.linalg.svd(M)
    G = U @ Vt
    if np.linalg.det(G) < 0:
        U[:, -1] *= -1
        G = U @ Vt
    return G


def rotation_err_deg(R_est: np.ndarray, R_true: np.ndarray, G: np.ndarray) -> float:
    """Largest angle, degrees, between a view's gauge-aligned estimate and
    its true rotation."""
    worst = 0.0
    for i in range(len(R_true)):
        E = G.T @ R_est[i].T @ R_true[i]
        c = min(1.0, max(-1.0, (np.trace(E) - 1.0) / 2.0))
        worst = max(worst, math.degrees(math.acos(c)))
    return worst


def _psnr(got: torch.Tensor, want: torch.Tensor) -> float:
    mse = torch.mean((got - want) ** 2).item() if got.numel() else float("nan")
    return 10 * math.log10(1.0 / max(mse, 1e-12))


def rotational_psnr(pano: np.ndarray, cover: np.ndarray, canvas: dict, env: torch.Tensor,
                    G: np.ndarray, mode: str) -> float:
    """PSNR dB of a rotational panorama over its covered pixels against the
    environment sampled along each pixel's ray, gauge-aligned."""
    dev = env.device
    ys, xs = (torch.as_tensor(a, device=dev, dtype=torch.float64) for a in np.nonzero(cover))
    u = float(canvas["x0"]) + xs / float(canvas["f_pan"])
    v = float(canvas["y0"]) + ys / float(canvas["f_pan"])
    if mode == "cylindrical":
        d = torch.stack([torch.sin(u), v, torch.cos(u)], -1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    elif mode in ("spherical", "equirectangular"):
        d = torch.stack([torch.cos(v) * torch.sin(u), torch.sin(v), torch.cos(v) * torch.cos(u)], -1)
    else:
        raise ValueError(f"no reference for projection {mode!r}")
    want = synth.env_lookup(env, d @ torch.as_tensor(G, device=dev))
    got = torch.as_tensor(pano, device=dev)[ys.long(), xs.long()].double() / 255.0
    return _psnr(got, want)


def judge_rotational(result, truth: dict) -> Dict[str, float]:
    """members_wrong, focal_err_pct, rot_err_deg and psnr_db (the worst over
    the true rings and the projections) of a rotational folder's result."""
    panos = list(result.panoramas)
    got = [_np(p["members"]) for p in panos]
    out = {"members_wrong": float(members_wrong([r["members"] for r in truth["rings"]], got,
                                                truth["views"])),
           "focal_err_pct": 0.0, "rot_err_deg": 0.0, "psnr_db": float("inf")}
    f_true = float(truth["focal_px"])
    for ring in truth["rings"]:
        want = set(int(v) for v in ring["members"])
        pr = next((p for p, g in zip(panos, got) if set(int(v) for v in g) == want), None)
        if pr is None:
            out.update(focal_err_pct=float("inf"), rot_err_deg=float("inf"), psnr_db=float("-inf"))
            continue
        true_of = {int(v): R for v, R in zip(ring["members"], ring["R"])}
        R_true = np.stack([true_of[int(v)] for v in _np(pr["members"])])
        R_est = np.asarray(pr["R_render"], np.float64)
        G = gauge(R_est, R_true)
        f_est = _np(pr["ba"]["cameras"].f).astype(np.float64)
        out["focal_err_pct"] = max(out["focal_err_pct"],
                                   float(np.abs(f_est - f_true).max() / f_true * 100))
        out["rot_err_deg"] = max(out["rot_err_deg"], rotation_err_deg(R_est, R_true, G))
        for mode, pano in pr["projections"].items():
            psnr = rotational_psnr(pano, pr["coverage_by_mode"][mode], pr["canvas"][mode],
                                   ring["env"], G, mode)
            out["psnr_db"] = min(out["psnr_db"], psnr)
    return out


def judge_planar(result, truth: dict, bundle: dict) -> Dict[str, float]:
    """members_wrong, corner_err_px (the largest corner displacement of each
    view's homography against its true offset from the anchor; read, not
    compared: no fault reads three times a sound run, PERF.md), h_cost_excess (`homography_cost_excess` over the inliers of the
    accepted pairs the program listed, with the configuration's `bundle`
    Huber scale and regulariser) and psnr_db (the planar panorama against
    the texture) of a planar folder's result."""
    n = truth["views"]
    panos = list(result.panoramas)
    out = {"members_wrong": float(members_wrong([np.arange(n)],
                                                [_np(p["members"]) for p in panos], n)),
           "corner_err_px": float("inf"), "h_cost_excess": float("inf"),
           "psnr_db": float("-inf")}
    pr = next((p for p in panos if len(p["members"]) == n), None)
    if pr is None:
        return out
    w, h = truth["width"], truth["height"]
    offs = np.asarray(truth["offsets"], np.float64)
    H = np.asarray(pr["H_abs"], np.float64)
    a = int(pr["anchor"])
    H_true = np.tile(np.eye(3), (n, 1, 1))
    H_true[:, :2, 2] = offs - offs[a]
    out["h_cost_excess"] = homography_cost_excess(
        H, a, H_true, *_listed_inliers(result, _np(pr["members"])),
        float(bundle["sigma_huber"]), float(bundle["reg_proj"]))
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64)
    err = 0.0
    for k in range(n):
        p = corners @ H[k].T
        p = p[:, :2] / p[:, 2:]
        err = max(err, float(np.abs(p - (corners[:, :2] + offs[k] - offs[a])).max()))
    out["corner_err_px"] = err
    env = truth["env"]
    dev = env.device
    pano, cover = pr["projections"]["planar"], pr["coverage_by_mode"]["planar"]
    x0, y0 = (float(v) for v in pr["offset"])
    s = float(pr["scale"])
    ys, xs = (torch.as_tensor(v, device=dev, dtype=torch.float64) for v in np.nonzero(cover))
    want = synth.bicubic(env, (xs + x0) / s + offs[a][0], (ys + y0) / s + offs[a][1])
    got = torch.as_tensor(pano, device=dev)[ys.long(), xs.long()].double() / 255.0
    out["psnr_db"] = _psnr(got, want)
    return out


def _project(G: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Pi(G [u, 1]) of points u (..., 2) under homographies G (..., 3, 3)."""
    w = (G[..., :, :2] @ u[..., None])[..., 0] + G[..., :, 2]
    return w[..., :2] / w[..., 2:]


def _views(params: torch.Tensor, anchor: int) -> torch.Tensor:
    """Homographies G_k = [params_k, 1] (n, 3, 3), with G_anchor = I."""
    G = torch.cat([params, torch.ones_like(params[:, :1])], 1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=G.dtype, device=G.device)
    return torch.cat([G[:anchor], eye[None], G[anchor + 1:]])


def _canvas_residuals(G: torch.Tensor, pair_ij: torch.Tensor, u_i: torch.Tensor,
                      u_j: torch.Tensor) -> torch.Tensor:
    """Pi(G_i u_i) - Pi(G_j u_j) of every listed match: (P, M, 2)."""
    return _project(G[pair_ij[:, 0]][:, None], u_i) - _project(G[pair_ij[:, 1]][:, None], u_j)


def homography_cost(params: torch.Tensor, anchor: int, pair_ij: torch.Tensor,
                    u_i: torch.Tensor, u_j: torch.Tensor, w: torch.Tensor, sigma: float,
                    reg_proj: float) -> torch.Tensor:
    """The objective the configuration states for the homography bundle
    adjustment (`bundleAdjustmentH.m`, one direction): over every listed
    match, Huber (scale sigma, in px) of the canvas-space residual
    |Pi(G_i u_i) - Pi(G_j u_j)|, plus reg_proj (G31^2 + G32^2) a view;
    G_k = [params_k, 1] maps view k to the anchor's frame, G_anchor = I.
    params (n, 8); pair_ij (P, 2); u_i, u_j (P, M, 2); w (P, M) 1 for a
    listed match, 0 for padding."""
    G = _views(params, anchor)
    r = torch.linalg.norm(_canvas_residuals(G, pair_ij, u_i, u_j), dim=-1)
    rho = torch.where(r <= sigma, r * r, 2.0 * sigma * r - sigma * sigma)
    return (w * rho).sum() + reg_proj * (G[:, 2, :2] ** 2).sum()


def homography_optimum(params0: torch.Tensor, anchor: int, args: tuple,
                       iters: int = 100) -> torch.Tensor:
    """The least cost of `homography_cost` near params0 (n, 8), by damped
    Gauss-Newton on the Huber-reweighted residuals in float64 (the anchor's
    row is not a variable)."""
    pair_ij, u_i, u_j, w, sigma, reg_proj = args
    p0 = params0.double()
    free = torch.arange(p0.shape[0], device=p0.device) != anchor
    rows = torch.nonzero(free).flatten()

    def full(q):
        return p0.index_put((rows,), q.reshape(-1, 8))

    def residuals(q, rw):
        G = _views(full(q), anchor)
        return torch.cat([(rw[..., None] * _canvas_residuals(G, pair_ij, u_i, u_j)).reshape(-1),
                          math.sqrt(reg_proj) * G[free][:, 2, :2].reshape(-1)])

    def cost(q):
        return homography_cost(full(q), anchor, *args).item()

    q = p0[free].reshape(-1)
    c, lam = cost(q), 1e-6
    for _ in range(iters):
        r = torch.linalg.norm(_canvas_residuals(_views(full(q), anchor), pair_ij, u_i, u_j), dim=-1)
        rw = torch.sqrt(w * torch.clamp(sigma / torch.clamp(r, min=1e-30), max=1.0))
        J = torch.func.jacfwd(lambda x: residuals(x, rw))(q)
        A, g = J.T @ J, J.T @ residuals(q, rw)
        while lam < 1e12:
            step = torch.linalg.solve(A + lam * torch.diag(torch.diagonal(A)), -g)
            c_new = cost(q + step)
            if c_new < c:
                break
            lam *= 10.0
        else:
            break
        q, lam = q + step, max(lam / 10.0, 1e-12)
        done = c - c_new <= 1e-13 * c
        c = c_new
        if done:
            break
    return full(q)


def homography_cost_excess(H_abs: np.ndarray, anchor: int, H_true: np.ndarray,
                           pair_ij: np.ndarray, u_i: np.ndarray, u_j: np.ndarray,
                           w: np.ndarray, sigma: float, reg_proj: float) -> float:
    """How far the program's homographies H_abs (n, 3, 3), view -> anchor,
    lie above the least cost of the homography BA's objective over the
    matches it was given (`homography_cost`): (cost(H_abs) - least) /
    least, both in float64. The least is found from the true homographies
    H_true, not from the program's answer. A bundle adjustment that left
    its start (the chained pairwise homographies) unrefined reads high."""
    dev = torch.device("cpu")

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    args = (t(pair_ij, torch.long), t(u_i), t(u_j), t(w), float(sigma), float(reg_proj))

    def params(H):
        H = np.asarray(H, np.float64)
        return t((H / H[:, 2:3, 2:3]).reshape(-1, 9)[:, :8])

    best = homography_optimum(params(H_true), anchor, args)
    least = homography_cost(best, anchor, *args).item()
    got = homography_cost(params(H_abs), anchor, *args).item()
    return (got - least) / least


def _listed_inliers(result, members: np.ndarray):
    """The inliers of the accepted pairs among members, as the program
    listed them: (pair_ij (P, 2) member-local, u_i, u_j (P, M, 2) keypoint
    coordinates, w (P, M))."""
    g = result.graph
    local = {int(v): k for k, v in enumerate(members)}
    xy = _np(result.features.xy).astype(np.float64)
    keep = [p for p in range(len(g.pairs)) if g.accepted[p]
            and int(g.pairs[p, 0]) in local and int(g.pairs[p, 1]) in local]
    M = max([1] + [int((g.pair_mask[p] & g.inliers[p]).sum()) for p in keep])
    pair_ij = np.zeros((len(keep), 2), np.int64)
    u_i = np.zeros((len(keep), M, 2))
    u_j = np.zeros((len(keep), M, 2))
    wt = np.zeros((len(keep), M))
    for k, p in enumerate(keep):
        gi, gj = int(g.pairs[p, 0]), int(g.pairs[p, 1])
        s = np.nonzero(g.pair_mask[p] & g.inliers[p])[0]
        pair_ij[k] = (local[gi], local[gj])
        u_i[k, :len(s)] = xy[gi, g.pair_idx[p, s, 0]]
        u_j[k, :len(s)] = xy[gj, g.pair_idx[p, s, 1]]
        wt[k, :len(s)] = 1.0
    return pair_ij, u_i, u_j, wt


def _two_nearest(x: torch.Tensor, valid: torch.Tensor, img: torch.Tensor, q: torch.Tensor,
                 block: int):
    """Squared distances (float64) of rows q of x to their nearest and second
    nearest valid rows of other images, and the nearest's index: (d1, d2,
    nn), each (len(q),)."""
    norms = (x * x).sum(-1)
    d1, d2, nn = [], [], []
    for s in range(0, len(q), block):
        qb = q[s:s + block]
        d = norms[qb][:, None] + norms[None, :] - 2.0 * (x[qb] @ x.T)
        d = d.clamp_min_(0.0)
        d.masked_fill_(~valid[None, :] | (img[qb][:, None] == img[None, :]), float("inf"))
        top = torch.topk(d, 2, dim=1, largest=False)
        d1.append(top.values[:, 0])
        d2.append(top.values[:, 1])
        nn.append(top.indices[:, 0])
        del d
    return torch.cat(d1), torch.cat(d2), torch.cat(nn)


def _excess(d: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """How far a squared distance lies above its bound, max(0, d - bound).
    Absolute, not relative: the descriptors are unit vectors, and crops of
    one texture give near duplicates whose distances (~1e-7) are as small
    as float32's round-off in them, so a ratio of two would be noise."""
    return torch.clamp(d - bound, min=0.0)


def _margin(d: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """How far a squared distance lies below its bound, bound - d."""
    return bound - d


def _pair_max(values: torch.Tensor, pair: torch.Tensor, P: int) -> torch.Tensor:
    """The largest value of each of P pairs (0 where a pair has none)."""
    out = torch.zeros(P, dtype=torch.float64, device=values.device)
    return out.scatter_reduce(0, pair, values.double(), "amax", include_self=True)


def _pair_count(flags: torch.Tensor, pair: torch.Tensor, P: int) -> torch.Tensor:
    return torch.zeros(P, dtype=torch.long, device=flags.device).index_add_(
        0, pair, flags.long())


def match_excess(desc: torch.Tensor, mask: torch.Tensor, pairs: np.ndarray,
                 pair_idx: np.ndarray, pair_mask: np.ndarray, counts: np.ndarray,
                 ratio: float, rescue_ratio: float, block: int = 2048,
                 chunk: int = 8, pairwise_only: bool = False) -> Dict[str, float]:
    """How far the program's putative matches stray from the matching rule,
    recomputed in float64 from the program's descriptors desc (N, K, D) and
    mask (N, K), for the listed pairs (P, 2), their matches pair_idx (P, M,
    2) / pair_mask (P, M) and the putative counts (N, N).

    Two rules make a pair's list. The pooled matcher's: a valid descriptor a
    of image i is matched to its nearest valid descriptor b of another image
    when d(a, b) < ratio^2 d2, d2 the second nearest (squared distances),
    and the pair lists each such match, from either side, once. The pairwise
    rescue's (a pair the rescue re-matched): b is a's nearest valid
    descriptor in image j with d(a, b) < rescue_ratio^2 d2 there, and a is
    b's nearest in image i. Each pair is held to the rule whose matches its
    list is nearer to (fewer matches in one and not the other). Returns
    - match_excess: the widest excess of a listed match over its pair's
      rule, in squared-distance units: d(a, b) - ratio^2 d2 (where b is not
      a's nearest, d(a, b) >= d2, so that the excess is at least
      (1 - ratio^2) d2), from the side that fits better; under the
      rescue's rule the larger of that at rescue_ratio within image j and
      d(a, b) less b's nearest in image i;
    - match_missing: the widest margin of a match the rule makes that the
      pair does not list (below the pair's last listed match where its
      list may have been capped): ratio^2 d2 - d1, and under the rescue's
      rule the smaller of that and b's own margin against its second
      nearest in image i;
    - pairwise_pairs: how many pairs were held to the rescue's rule.

    With `pairwise_only`, every pair is held to the rescue's rule at
    rescue_ratio: a component's second pass matches each of its pairs so,
    at the configuration's ratio.
    """
    pairs = np.asarray(pairs, np.int64)
    pair_idx = np.asarray(pair_idx, np.int64)
    p, m = np.nonzero(np.asarray(pair_mask))
    P = len(pairs)
    if len(p) == 0:
        return {"match_excess": 0.0, "match_missing": 0.0, "pairwise_pairs": 0.0}
    N, K, D = desc.shape
    dev = desc.device
    x = desc.reshape(N * K, D).double()
    xs = x.reshape(N, K, D)
    valid = mask.reshape(-1).bool()
    vs = valid.reshape(N, K)
    img = torch.arange(N, device=dev).repeat_interleave(K)
    pt = torch.as_tensor(p, device=dev)
    la = torch.as_tensor(pair_idx[p, m, 0], device=dev)
    lb = torch.as_tensor(pair_idx[p, m, 1], device=dev)
    a = torch.as_tensor(pairs[p, 0], device=dev) * K + la
    b = torch.as_tensor(pairs[p, 1], device=dev) * K + lb
    dab = ((x[a] - x[b]) ** 2).sum(-1)
    n_listed = np.bincount(p, minlength=P)
    maybe_capped = torch.as_tensor(np.asarray(counts)[pairs[:, 0], pairs[:, 1]] > n_listed,
                                   device=dev)
    pair_key = pairs[:, 0] * N + pairs[:, 1]
    listed = (torch.as_tensor(pair_key[p], device=dev) * K + la) * K + lb

    # the pooled rule
    q = torch.nonzero(valid).flatten()
    d1, d2, nn = _two_nearest(x, valid, img, q, block)
    pos = torch.full((N * K,), -1, dtype=torch.long, device=dev)
    pos[q] = torch.arange(len(q), device=dev)
    r2 = ratio * ratio
    v_pool = torch.minimum(_excess(dab, r2 * d2[pos[a]]), _excess(dab, r2 * d2[pos[b]]))
    acc = d1 < r2 * d2
    qa, ta = q[acc], nn[acc]
    margin = _margin(d1[acc], r2 * d2[acc])
    ia, ib = img[qa], img[ta]
    swap = ia > ib
    i_img, j_img = torch.where(swap, ib, ia), torch.where(swap, ia, ib)
    i_loc = torch.where(swap, ta - ib * K, qa - ia * K)
    j_loc = torch.where(swap, qa - ia * K, ta - ib * K)
    key = ((i_img * N + j_img) * K + i_loc) * K + j_loc
    order = np.argsort(pair_key)
    keys_sorted = torch.as_tensor(pair_key[order], device=dev)
    slot = torch.searchsorted(keys_sorted, i_img * N + j_img).clamp_max(P - 1)
    in_pair = keys_sorted[slot] == i_img * N + j_img
    rule_pair = torch.as_tensor(order, device=dev)[slot]
    key, margin, rule_pair = key[in_pair], margin[in_pair], rule_pair[in_pair]
    # below the last listed match of a pair whose list may have been capped
    # (the pooled lists are in key order)
    last = torch.full((P,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, pt, listed, "amax", include_self=True)
    below = ~maybe_capped[rule_pair] | (key < last[rule_pair])
    extra = ~torch.isin(listed, key)
    missing = ~torch.isin(key, listed) & below
    pool_excess = _pair_max(v_pool, pt, P)
    pool_missing = _pair_max(torch.where(missing, margin, 0.0), rule_pair, P)
    pool_diff = _pair_count(extra, pt, P) + _pair_count(missing, rule_pair, P)

    # the rescue's rule, pair by pair
    rr2 = rescue_ratio * rescue_ratio
    pw_excess = torch.zeros(P, dtype=torch.float64, device=dev)
    pw_missing = torch.zeros(P, dtype=torch.float64, device=dev)
    pw_diff = torch.zeros(P, dtype=torch.long, device=dev)
    pi = torch.as_tensor(pairs[:, 0], device=dev)
    pj = torch.as_tensor(pairs[:, 1], device=dev)
    for s in range(0, P, chunk):
        c = torch.arange(s, min(P, s + chunk), device=dev)
        A, B = xs[pi[c]], xs[pj[c]]
        d = ((A * A).sum(-1)[:, :, None] + (B * B).sum(-1)[:, None, :]
             - 2.0 * A @ B.transpose(1, 2)).clamp_min(0.0)
        dab_ = d.masked_fill(~vs[pj[c]][:, None, :], float("inf"))
        dba_ = d.masked_fill(~vs[pi[c]][:, :, None], float("inf"))
        t_ab = torch.topk(dab_, 2, dim=2, largest=False)  # a's two nearest in j
        t_ba = torch.topk(dba_, 2, dim=1, largest=False)  # b's two nearest in i
        nn_ab, d1_ab, d2_ab = t_ab.indices[..., 0], t_ab.values[..., 0], t_ab.values[..., 1]
        nn_ba, d1_ba, d2_ba = t_ba.indices[:, 0], t_ba.values[:, 0], t_ba.values[:, 1]
        a_idx = torch.arange(K, device=dev)[None].expand(len(c), K)
        mutual = torch.gather(nn_ba, 1, nn_ab) == a_idx
        ok = vs[pi[c]] & (d1_ab < rr2 * d2_ab) & mutual
        mg = torch.minimum(_margin(d1_ab, rr2 * d2_ab),
                           _margin(d1_ab, torch.gather(d2_ba, 1, nn_ab)))
        sel = (pt >= s) & (pt < s + len(c))
        lc, la_c, lb_c = pt[sel] - s, la[sel], lb[sel]
        dl = d[lc, la_c, lb_c]  # the same arithmetic as the nearest distances
        v = torch.maximum(_excess(dl, rr2 * d2_ab[lc, la_c]), _excess(dl, d1_ba[lc, lb_c]))
        pw_excess[c] = _pair_max(v, lc, len(c))
        rule_keys = ((torch.as_tensor(pair_key, device=dev)[c][:, None] * K + a_idx) * K
                     + nn_ab)
        lk = listed[sel]
        last_d = torch.zeros(len(c), dtype=torch.float64, device=dev).scatter_reduce(
            0, lc, dl, "amax", include_self=True)  # the pairwise lists are in distance order
        keep = ok & (~maybe_capped[c][:, None] | (d1_ab < last_d[:, None]))
        miss = keep & ~torch.isin(rule_keys, lk)
        pw_missing[c] = torch.where(miss, mg, 0.0).amax(1)
        pw_diff[c] = miss.sum(1) + _pair_count(~torch.isin(lk, rule_keys[ok]), lc, len(c))
        del d, dab_, dba_
    pairwise = torch.ones_like(pw_diff, dtype=torch.bool) if pairwise_only else pw_diff < pool_diff
    excess = torch.where(pairwise, pw_excess, pool_excess)
    miss_all = torch.where(pairwise, pw_missing, pool_missing)
    return {"match_excess": float(excess.max().item()),
            "match_missing": float(miss_all.max().item()),
            "pairwise_pairs": float(pairwise.sum().item())}
