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
  of the matcher the configuration states (`stated_matcher`: its operand
  precision, its pooled method, float or binary descriptors; the nearest
  cross-image neighbour passing Lowe's ratio, or, for a pair the pairwise
  rescue re-matched, the mutual nearest within the pair at the rescue
  ratio), recomputed in float64 from the descriptors the program
  returned; its numbers are the widest excess of a listed match over that
  rule and the widest margin of a match the rule makes that a listed pair
  leaves out, in the rule's distance units (`match_excess`).

- the homography bundle adjustment (planar scans): how far the program's
  homographies lie above the least cost of the objective the
  configuration states, over the inliers the program listed (this follows
  the program's state; the inliers themselves are judged through the
  corner error and the match numbers).

The arithmetic of the first three is `chip_smoke.py`'s (`pano_psnr`,
`multipano_metrics`, `planar_metrics`). Nothing here imports the program.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from pano_bench import sketch
from pano_bench.scenes import synth

# the detectors whose descriptors are 256 bits in {0, 1}, matched by Hamming
# distance (the program's `models/features.BINARY_DETECTORS`)
BINARY_DETECTORS = ("HARRIS", "FAST", "ORB", "BRISK")


@dataclasses.dataclass(frozen=True)
class Matcher:
    """The matcher a configuration states, which sets the rule its matches
    are held to (`stated_matcher`): `compute_dtype` the operands of every
    distance's cross term ("float32" or "bfloat16"), `method` the pooled
    matcher ("exhaustive" or "approximate"), `binary` Hamming semantics,
    `threshold` the pairwise matcher's cut on the nearest distance (squared
    distance, or percent of the bits when binary; inf: none), `k` the
    pooled matcher's neighbours (the sketch keeps 8k candidates)."""

    compute_dtype: str = "float32"
    method: str = "exhaustive"
    binary: bool = False
    threshold: float = math.inf
    k: int = 4


def stated_matcher(config: dict) -> Matcher:
    """The matcher of a configuration file's `stitch_config`: its
    `tpu.compute_dtype`, `matching.method`, whether `detector.detector`
    gives binary descriptors, and `matching.threshold`, where None means no
    cut for float descriptors and 10 % of the bits for binary ones."""
    sc = config["stitch_config"]
    m = sc["matching"]
    binary = sc["detector"]["detector"].upper() in BINARY_DETECTORS
    threshold = m["threshold"]
    if threshold is None:
        threshold = 10.0 if binary else math.inf
    dtype = sc["tpu"]["compute_dtype"]
    if dtype not in ("float32", "bfloat16") or m["method"] not in ("exhaustive", "approximate"):
        raise ValueError(f"no matching rule for compute_dtype {dtype!r}, method {m['method']!r}")
    return Matcher(dtype, m["method"], binary, float(threshold), int(m["k"]))



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


_Top = collections.namedtuple("_Top", "values indices")


def _two_smallest(d: torch.Tensor, dim: int, lowest_index_first: bool = False):
    """The two smallest values of d along dim and their indices. With
    `lowest_index_first` (whole-number distances: Hamming), equal values
    go to the lower index, as the program's kernel and its stable sorts
    break ties: they are ranked by d n + index, exact in float64."""
    if not lowest_index_first:
        return torch.topk(d, 2, dim=dim, largest=False)
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    rank = d * n + torch.arange(n, dtype=d.dtype, device=d.device).reshape(shape)
    idx = torch.topk(rank, 2, dim=dim, largest=False).indices
    return _Top(torch.gather(d, dim, idx), idx)


def _two_nearest(x: torch.Tensor, valid: torch.Tensor, img: torch.Tensor, q: torch.Tensor,
                 block: int, xc: torch.Tensor = None, lowest_index_first: bool = False):
    """Squared distances (float64) of rows q of x to their nearest and second
    nearest valid rows of other images, and the nearest's index: (d1, d2,
    nn), each (len(q),). `xc` holds the cross term's operands (x itself
    unless the matcher rounds them)."""
    xc = x if xc is None else xc
    norms = (x * x).sum(-1)
    d1, d2, nn = [], [], []
    for s in range(0, len(q), block):
        qb = q[s:s + block]
        d = norms[qb][:, None] + norms[None, :] - 2.0 * (xc[qb] @ xc.T)
        d = d.clamp_min_(0.0)
        d.masked_fill_(~valid[None, :] | (img[qb][:, None] == img[None, :]), float("inf"))
        top = _two_smallest(d, 1, lowest_index_first)
        d1.append(top.values[:, 0])
        d2.append(top.values[:, 1])
        nn.append(top.indices[:, 0])
        del d
    return torch.cat(d1), torch.cat(d2), torch.cat(nn)


def _gamma(n: int, u: float = 2.0 ** -24) -> float:
    """Higham's gamma_n = n u / (1 - n u): the relative bound of n roundings."""
    return n * u / (1.0 - n * u)


class _SketchRule:
    """The approximate pooled matcher's rule (`matching.method =
    "approximate"`, where D > 32). For a valid query a, C(a) is the min(8k,
    F) targets of least sketch distance |a G - t G|^2 (F all slots; other
    images' valid slots; ties to the lower index); a's nearest and second
    nearest are taken by exact distance within C(a), and the ratio test is
    applied to those. G is `sketch.matrix(D)`.

    The program ranks the sketch in float32 (TF32 off), the reference in
    float64, so a target near the boundary of C(a) may fall in or out. A
    bound E(a, t) on |s^ - s|, the program's sketch distance against the
    exact one, makes each target certainly in, certainly out or admissible
    either way. With u = 2^-24, gamma_n = n u / (1 - n u), m = 32:

    - desc @ G: each entry of P^ = fl(x G) is a D-term float32 dot product,
      so, in any order of summation, |P^_i - P_i| <= e_i = gamma_D
      sum_j |x_j| |G_ji| (Higham, Accuracy and Stability of Numerical
      Algorithms, eq. 3.5).
    - the sketch distance: s^ = max(fl(fl(n^_a + n^_t) - 2 c^), 0) from the
      32-term dot products n^_a = |P^_a|^2, n^_t and c^ = P^_a . P^_t. Each
      product reaches s^ through at most m + 2 roundings, so against s~ =
      |P^_a - P^_t|^2, |s^ - s~| <= gamma_{m+2} (N_a + N_t) + 2 g_x C_at,
      where N_a = sum (|P_ai| + e_ai)^2 >= |P^_a|^2, C_at = sum (|P_ai| +
      e_ai)(|P_ti| + e_ti) >= sum |P^_ai| |P^_ti|, and g_x = gamma_{m+2}
      for float32 operands; bf16 operands (`compute_dtype`) round each to
      within 2^-8 of itself, exact products, so g_x = eps + gamma_{m+2}
      (1 + eps), eps = (1 + 2^-8)^2 - 1.
    - against s = |P_a - P_t|^2: with delta = (P^_a - P_a) - (P^_t - P_t),
      |delta_i| <= e_ai + e_ti, so |s~ - s| = |2 (P_a - P_t) . delta +
      |delta|^2| <= 2 sqrt(s) ee^(1/2) + ee, ee = |e_a + e_t|^2.

    E = 2 sqrt(s ee) + ee + gamma_{m+2} (N_a + N_t) + 2 g_x C_at, taken
    (1 + 2^-20) times larger: that covers the reference's own float64
    rounding of P, s and E, each under 2^-28 of the float32 terms. The
    clamp at 0 moves no distance further. s^ lies in [lo, hi] = [s - E, s +
    E]. With n_c = min(8k, F), L the n_c-th least hi of a's row and U its
    (n_c + 1)-th least lo: t is certainly in C(a) when hi < U (at most n_c
    targets, t among them, can rank up to it), certainly out when lo > L
    (n_c targets surely rank before it) or when the certain ones fill C(a),
    and admissible either way between. An admissible choice is any C of
    n_c targets holding every certain one and admissible ones besides (the
    slots of other images' masked targets fill C where fewer than n_c are
    valid).

    A listed match (a, b), from a's side, counts as excess only by the
    least excess over the admissible choices that hold b: max(0, d(a, b) -
    r^2 d2_C), d2_C the second least exact distance in C, largest where C
    fills with the admissible targets farthest from a. If b is certainly
    out, by lo > L or because the certain targets alone fill C(a), no
    choice holds it: the program could not have listed it from a's side,
    and its excess is infinite. A rule match counts as missing only if it is one under every
    admissible choice: a's nearest among the certain and admissible
    targets is certain, and passes the ratio against the second least
    distance among those, the least d2 of any choice (its margin)."""

    def __init__(self, x: torch.Tensor, xc: torch.Tensor, valid: torch.Tensor,
                 img: torch.Tensor, q: torch.Tensor, block: int, n_cand: int,
                 compute_dtype: str, r2: float):
        F, D = x.shape
        G = torch.as_tensor(sketch.matrix(D), device=x.device).double()
        self.P = x @ G
        self.e = _gamma(D) * (x.abs() @ G.abs())
        self.Pe = self.P.abs() + self.e
        self.n, self.ee, self.N = ((v * v).sum(-1) for v in (self.P, self.e, self.Pe))
        m = sketch.DIM
        eps = 0.0 if compute_dtype == "float32" else (1.0 + 2.0 ** -8) ** 2 - 1.0
        self.g = _gamma(m + 2)
        self.gx = eps + self.g * (1.0 + eps)
        self.valid, self.img, self.n_cand, self.r2 = valid, img, n_cand, r2
        inf = float("inf")
        norms = (x * x).sum(-1)
        keep = {name: [] for name in ("L", "U", "nI", "i12", "a_vals", "a_idx", "d1", "d2",
                                      "nn", "certain")}
        kk = min(n_cand + 1, F)
        for s in range(0, len(q), block):
            qb = q[s:s + block]
            bad = ~valid[None, :] | (img[qb][:, None] == img[None, :])
            lo, hi = self.interval(qb)
            lo.masked_fill_(bad, inf)
            hi.masked_fill_(bad, inf)
            L = torch.topk(hi, n_cand, dim=1, largest=False).values[:, -1]
            U = (torch.topk(lo, kk, dim=1, largest=False).values[:, -1] if kk > n_cand
                 else torch.full_like(L, inf))
            sure = hi < U[:, None]
            nI = sure.sum(1)
            amb = (lo <= L[:, None]) & ~bad & ~sure & (nI < n_cand)[:, None]
            adm = sure | amb
            del lo, hi
            d = norms[qb][:, None] + norms[None, :] - 2.0 * (xc[qb] @ xc.T)
            d = d.clamp_min_(0.0).masked_fill_(bad, inf)
            top = torch.topk(d.masked_fill(~adm, inf), 2, dim=1, largest=False)
            far = torch.topk(d.masked_fill(~amb, -inf), kk, dim=1)
            a_vals = torch.full((len(qb), n_cand + 1), inf, dtype=d.dtype, device=d.device)
            a_idx = torch.full((len(qb), n_cand + 1), -1, dtype=torch.long, device=d.device)
            a_vals[:, :kk] = torch.where(far.values > -inf, far.values, inf)
            a_idx[:, :kk] = torch.where(far.values > -inf, far.indices, -1)
            for name, v in (("L", L), ("U", U), ("nI", nI),
                            ("i12", torch.topk(d.masked_fill(~sure, inf), 2, dim=1,
                                               largest=False).values),
                            ("a_vals", a_vals), ("a_idx", a_idx), ("d1", top.values[:, 0]),
                            ("d2", top.values[:, 1]), ("nn", top.indices[:, 0]),
                            ("certain", torch.gather(sure, 1, top.indices[:, :1])[:, 0])):
                keep[name].append(v)
            del d, bad, sure, adm, amb
        for name, v in keep.items():
            setattr(self, name, torch.cat(v))

    def interval(self, a: torch.Tensor, t: torch.Tensor = None):
        """(lo, hi), the bounds of the program's sketch distances of rows a
        to every target (t None: (len(a), F)) or to targets t, pair by pair."""
        if t is None:
            def dot(v):
                return v[a] @ v.T

            def add(w):
                return w[a][:, None] + w[None, :]
        else:
            def dot(v):
                return (v[a] * v[t]).sum(-1)

            def add(w):
                return w[a] + w[t]
        s = (add(self.n) - 2.0 * dot(self.P)).clamp_min_(0.0)
        ee = add(self.ee) + 2.0 * dot(self.e)
        E = (2.0 * torch.sqrt(s * ee) + ee + self.g * add(self.N)
             + 2.0 * self.gx * dot(self.Pe)) * (1.0 + 2.0 ** -20)
        return s - E, s + E

    def excess(self, row: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
               d_at: torch.Tensor) -> torch.Tensor:
        """The least excess of listed matches (a, t) from a's side over the
        admissible choices of C(a) (the class doc); `row` is a's place among
        the rule's queries (-1: a is no valid query)."""
        inf = float("inf")
        r = row.clamp_min(0)
        lo, hi = self.interval(a, t)
        L, U = self.L[r], self.U[r]
        out = lo > L
        sure = hi < U
        full = ~sure & (self.nI[r] >= self.n_cand)  # the certain targets fill C(a)
        m = self.n_cand - self.nI[r] - (~sure).long()
        a_vals, a_idx = self.a_vals[r], self.a_idx[r]
        hit = a_idx == t[:, None]
        j = torch.where(hit.any(1), hit.long().argmax(1), self.n_cand + 1)

        def fill(p):  # the p-th farthest admissible target of a other than t
            col = (p + (p >= j).long()).clamp(0, self.n_cand)
            return torch.where(p >= 0, torch.gather(a_vals, 1, col[:, None])[:, 0], inf)

        cand = torch.stack([self.i12[r, 0], self.i12[r, 1], torch.where(sure, inf, d_at),
                            fill(m - 1), fill(m - 2)], 1)
        d2c = torch.topk(cand, 2, dim=1, largest=False).values[:, 1]
        v = torch.where(out | full, inf, _excess(d_at, self.r2 * d2c))
        ok = (row >= 0) & self.valid[t] & (self.img[a] != self.img[t])
        return torch.where(ok, v, inf)


def _operands(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """The cross term's operands as the matcher states them: x itself
    (float32), or x rounded to bf16 to nearest even, in float64."""
    return x if compute_dtype == "float32" else x.float().to(torch.bfloat16).double()


def _excess(d: torch.Tensor, bound) -> torch.Tensor:
    """How far a squared distance lies above its bound, max(0, d - bound).
    Absolute, not relative: the descriptors are unit vectors, and crops of
    one texture give near duplicates whose distances (~1e-7) are as small
    as float32's round-off in them, so a ratio of two would be noise."""
    return torch.clamp(d - bound, min=0.0)


def _margin(d: torch.Tensor, bound) -> torch.Tensor:
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
                 chunk: int = 8, pairwise_only: bool = False,
                 matcher: Matcher = Matcher()) -> Dict[str, float]:
    """How far the program's putative matches stray from the rule of the
    matcher the configuration states (`matcher`), recomputed in float64
    from the program's descriptors desc (N, K, D) and mask (N, K), for the
    listed pairs (P, 2), their matches pair_idx (P, M, 2) / pair_mask (P,
    M) and the putative counts (N, N).

    The distance d(a, b) is the squared one, |a - b|^2, from the float32
    descriptors; with bf16 operands (`compute_dtype = "bfloat16"`) it is
    |a|^2 + |b|^2 - 2 bf16(a) . bf16(b), the norms from the float32
    descriptors, as the program's bf16 matchers compute it; on binary
    descriptors it is the Hamming distance, exact, and equal distances go
    to the lower index, as in the program. The ratio test compares d1 with
    rho d2: rho = ratio^2 on squared distances, rho = ratio on Hamming
    distances (binary).

    Two rules make a pair's list. The pooled matcher's: a valid descriptor a
    of image i is matched to its nearest valid descriptor b of another image
    when d(a, b) < rho d2, d2 the second nearest, and the pair lists each
    such match, from either side, once; with the approximate method (D >
    32), nearest and second nearest within a's sketch candidates
    (`_SketchRule`, whose admissible choices near the candidates' boundary
    the numbers below take at their most favourable to the program). The
    pairwise rescue's (a pair the rescue re-matched): b is a's nearest
    valid descriptor in image j with d(a, b) < rho d2 there (d1 <= rho d2
    on binary descriptors, as the program's pairwise matcher tests them),
    and a is b's nearest in image i; where the matcher has a threshold,
    also d(a, b) <= it (percent of the bits on binary descriptors). Each
    pair is held to the rule whose matches its list is nearer to (fewer
    matches in one and not the other). Returns
    - match_excess: the widest excess of a listed match over its pair's
      rule, in the rule's distance units: d(a, b) - rho d2 (where b is not
      a's nearest, d(a, b) >= d2, so that the excess is at least (1 - rho)
      d2), from the side that fits better; under the rescue's rule the
      larger of that at the rescue ratio within image j, d(a, b) less b's
      nearest in image i, and d(a, b) less the threshold;
    - match_missing: the widest margin of a match the rule makes that the
      pair does not list (below the pair's last listed match where its
      list may have been capped): rho d2 - d1, and under the rescue's rule
      the smallest of that, b's own margin against its second nearest in
      image i, and the threshold less d1;
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
    approx = matcher.method == "approximate" and D > sketch.DIM
    if approx and matcher.binary:
        raise ValueError("no rule for the approximate matcher on binary descriptors: its "
                         "equal Hamming distances fall to the sketch's order")
    dev = desc.device
    x = desc.reshape(N * K, D).double()
    xs = x.reshape(N, K, D)
    xc = _operands(x, matcher.compute_dtype)
    xcs = xc.reshape(N, K, D)
    valid = mask.reshape(-1).bool()
    vs = valid.reshape(N, K)
    img = torch.arange(N, device=dev).repeat_interleave(K)
    pt = torch.as_tensor(p, device=dev)
    la = torch.as_tensor(pair_idx[p, m, 0], device=dev)
    lb = torch.as_tensor(pair_idx[p, m, 1], device=dev)
    a = torch.as_tensor(pairs[p, 0], device=dev) * K + la
    b = torch.as_tensor(pairs[p, 1], device=dev) * K + lb
    if matcher.compute_dtype == "float32":
        dab = ((x[a] - x[b]) ** 2).sum(-1)
    else:
        dab = ((x[a] * x[a]).sum(-1) + (x[b] * x[b]).sum(-1)
               - 2.0 * (xc[a] * xc[b]).sum(-1)).clamp_min(0.0)
    n_listed = np.bincount(p, minlength=P)
    maybe_capped = torch.as_tensor(np.asarray(counts)[pairs[:, 0], pairs[:, 1]] > n_listed,
                                   device=dev)
    pair_key = pairs[:, 0] * N + pairs[:, 1]
    listed = (torch.as_tensor(pair_key[p], device=dev) * K + la) * K + lb

    # the pooled rule
    q = torch.nonzero(valid).flatten()
    pos = torch.full((N * K,), -1, dtype=torch.long, device=dev)
    pos[q] = torch.arange(len(q), device=dev)
    r2 = ratio if matcher.binary else ratio * ratio
    if approx:
        rule = _SketchRule(x, xc, valid, img, q, max(1, block // 4), min(8 * matcher.k, N * K),
                           matcher.compute_dtype, r2)
        d1, d2, nn = rule.d1, rule.d2, rule.nn
        v_pool = torch.minimum(rule.excess(pos[a], a, b, dab), rule.excess(pos[b], b, a, dab))
        acc = rule.certain & (d1 < r2 * d2)
    else:
        d1, d2, nn = _two_nearest(x, valid, img, q, block, xc, matcher.binary)
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
    if approx:  # a listed match some admissible choice makes is no difference
        extra &= v_pool > 0
    missing = ~torch.isin(key, listed) & below
    pool_excess = _pair_max(v_pool, pt, P)
    pool_missing = _pair_max(torch.where(missing, margin, 0.0), rule_pair, P)
    pool_diff = _pair_count(extra, pt, P) + _pair_count(missing, rule_pair, P)

    # the rescue's rule, pair by pair
    rr2 = rescue_ratio if matcher.binary else rescue_ratio * rescue_ratio
    cut = matcher.threshold * D / 100.0 if matcher.binary else matcher.threshold
    pw_excess = torch.zeros(P, dtype=torch.float64, device=dev)
    pw_missing = torch.zeros(P, dtype=torch.float64, device=dev)
    pw_diff = torch.zeros(P, dtype=torch.long, device=dev)
    pi = torch.as_tensor(pairs[:, 0], device=dev)
    pj = torch.as_tensor(pairs[:, 1], device=dev)
    for s in range(0, P, chunk):
        c = torch.arange(s, min(P, s + chunk), device=dev)
        A, B = xs[pi[c]], xs[pj[c]]
        Ac, Bc = xcs[pi[c]], xcs[pj[c]]
        d = ((A * A).sum(-1)[:, :, None] + (B * B).sum(-1)[:, None, :]
             - 2.0 * Ac @ Bc.transpose(1, 2)).clamp_min(0.0)
        dab_ = d.masked_fill(~vs[pj[c]][:, None, :], float("inf"))
        dba_ = d.masked_fill(~vs[pi[c]][:, :, None], float("inf"))
        t_ab = _two_smallest(dab_, 2, matcher.binary)  # a's two nearest in j
        t_ba = _two_smallest(dba_, 1, matcher.binary)  # b's two nearest in i
        nn_ab, d1_ab, d2_ab = t_ab.indices[..., 0], t_ab.values[..., 0], t_ab.values[..., 1]
        nn_ba, d1_ba, d2_ba = t_ba.indices[:, 0], t_ba.values[:, 0], t_ba.values[:, 1]
        a_idx = torch.arange(K, device=dev)[None].expand(len(c), K)
        mutual = torch.gather(nn_ba, 1, nn_ab) == a_idx
        if matcher.binary:
            passes = (d1_ab <= rr2 * d2_ab) & (d1_ab < float("inf"))
        else:
            passes = d1_ab < rr2 * d2_ab
        ok = vs[pi[c]] & passes & mutual
        mg = torch.minimum(_margin(d1_ab, rr2 * d2_ab),
                           _margin(d1_ab, torch.gather(d2_ba, 1, nn_ab)))
        sel = (pt >= s) & (pt < s + len(c))
        lc, la_c, lb_c = pt[sel] - s, la[sel], lb[sel]
        dl = d[lc, la_c, lb_c]  # the same arithmetic as the nearest distances
        v = torch.maximum(_excess(dl, rr2 * d2_ab[lc, la_c]), _excess(dl, d1_ba[lc, lb_c]))
        if cut < math.inf:
            ok &= d1_ab <= cut
            mg = torch.minimum(mg, _margin(d1_ab, cut))
            v = torch.maximum(v, _excess(dl, cut))
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
