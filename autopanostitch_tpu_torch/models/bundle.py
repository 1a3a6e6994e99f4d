"""Brown-Lowe bundle adjustment over rotation + focal (+ k1) (port of
`models/bundle.py`).

Host control plane (numpy, copied from the reference because its module
imports jax): focal estimation from homographies, maximum spanning tree,
BFS rotation propagation, rotation-consistency classifier, stratified
match subsampling, incremental camera order.

Device plane (torch): the incremental LM. Each phase works on the compact
subsystem of the active cameras; the Jacobian of the bidirectional
residual is `torch.func.vmap(torch.func.jacrev(...))` over every match, the
normal equations are a dense (pd*n)^2 system solved by Cholesky, and the
accept/reject decision, the lambda schedule and the state update are
`torch.where`s on the device, so an LM iteration never waits for the host.
Each iteration linearizes its CANDIDATE (the reference linearizes only on
accept); the candidate's cost is the one the accept test needs, and the
accepted state's Jacobian is then already at hand.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from autopanostitch_tpu_torch.config import BundleConfig
from autopanostitch_tpu_torch.ops import geometry as geo
from autopanostitch_tpu_torch.ops import projections as proj

_K1_PRIOR_SIGMA = 0.05
_K1_MEAN_WEIGHT = 1.0e4
_K1_STEP_CAP = 0.02
_K1_INC_STEP_CAP = 0.002
_K1_CLAMP = 0.25


class Cameras(NamedTuple):
    """Camera set: R (N, 3, 3) world -> camera, f, cx, cy (N,), k1 (N,) or
    None (pinhole)."""

    R: torch.Tensor
    f: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor | None = None


# ===========================================================================
# Host control plane (numpy)
# ===========================================================================

def center_normalize_H(H: np.ndarray, size_i, size_j):
    """Shift principal points to zero and normalize det to 1. H maps i -> j."""
    hi, wi = size_i
    hj, wj = size_j
    Ci = np.array([[1, 0, (wi - 1) / 2.0], [0, 1, (hi - 1) / 2.0], [0, 0, 1.0]])
    Cj = np.array([[1, 0, (wj - 1) / 2.0], [0, 1, (hj - 1) / 2.0], [0, 0, 1.0]])
    Hc = np.linalg.inv(Cj) @ H @ Ci
    d = np.linalg.det(Hc)
    if not np.isfinite(d) or d == 0:
        return None
    return Hc / (np.sign(d) * np.abs(d) ** (1.0 / 3.0))


def _focal_w_constraint(Hcs):
    ws = []
    for Hn in Hcs:
        h1, h2 = Hn[:, 0], Hn[:, 1]
        denA = h1[0] * h2[0] + h1[1] * h2[1]
        if abs(denA) > 1e-12:
            wA = -(h1[2] * h2[2]) / denA
            if np.isfinite(wA) and wA > 0:
                ws.append(wA)
        denB = (h1[0] ** 2 + h1[1] ** 2) - (h2[0] ** 2 + h2[1] ** 2)
        if abs(denB) > 1e-12:
            wB = (h2[2] ** 2 - h1[2] ** 2) / denB
            if np.isfinite(wB) and wB > 0:
                ws.append(wB)
    ws = np.array([w for w in ws if np.isfinite(w) and w > 0])
    if len(ws) == 0:
        return None
    medw = np.median(ws)
    madw = np.median(np.abs(ws - medw))
    keep = (np.abs(ws - medw) <= 3 * madw if madw > 0
            else np.abs(ws - medw) <= 1e-6 * max(1.0, medw))
    ws = ws[keep]
    if len(ws) == 0:
        return None
    return 1.0 / np.sqrt(ws)


def _focal_shum_szeliski_one(H: np.ndarray) -> float:
    d1 = H[2, 0] * H[2, 1]
    d2 = (H[2, 1] - H[2, 0]) * (H[2, 1] + H[2, 0])
    v1 = -(H[0, 0] * H[0, 1] + H[1, 0] * H[1, 1]) / d1 if d1 != 0 else -np.inf
    v2 = (H[0, 0] ** 2 + H[1, 0] ** 2 - H[0, 1] ** 2 - H[1, 1] ** 2) / d2 if d2 != 0 else -np.inf
    if v1 < v2:
        v1, v2 = v2, v1
    if v1 > 0 and v2 > 0:
        f1 = np.sqrt(v1 if abs(d1) > abs(d2) else v2)
    elif v1 > 0:
        f1 = np.sqrt(v1)
    else:
        return np.nan
    d1 = H[0, 0] * H[1, 0] + H[0, 1] * H[1, 1]
    d2 = H[0, 0] ** 2 + H[0, 1] ** 2 - H[1, 0] ** 2 - H[1, 1] ** 2
    v1 = -H[0, 2] * H[1, 2] / d1 if d1 != 0 else -np.inf
    v2 = (H[1, 2] ** 2 - H[0, 2] ** 2) / d2 if d2 != 0 else -np.inf
    if v1 < v2:
        v1, v2 = v2, v1
    if v1 > 0 and v2 > 0:
        f0 = np.sqrt(v1 if abs(d1) > abs(d2) else v2)
    elif v1 > 0:
        f0 = np.sqrt(v1)
    else:
        return np.nan
    return float(np.sqrt(f1 * f0))


def estimate_focal(pairs, Hs, sizes, method: str = "shumSzeliskiOneHPaper") -> float:
    """Global focal estimate from verified pair homographies (Hs[p] maps
    pairs[p, 0] -> pairs[p, 1])."""
    Hcs = []
    for p, (i, j) in enumerate(pairs):
        Hc = center_normalize_H(Hs[p], sizes[i], sizes[j])
        if Hc is not None:
            Hcs.append(Hc)
    base = float(np.median(np.max(sizes, axis=1)))
    fallback = 0.8 * base
    if not Hcs:
        return fallback
    if method == "wConstraint":
        f_cands = _focal_w_constraint(Hcs)
        if f_cands is None:
            return fallback
        f_cands = f_cands[(f_cands >= 0.3 * base) & (f_cands <= 6.0 * base)]
        return float(np.median(f_cands)) if len(f_cands) else fallback
    both = Hcs + [np.linalg.inv(h) for h in Hcs]
    fv = np.array([_focal_shum_szeliski_one(h) for h in both])
    fv = fv[np.isfinite(fv) & (fv > 0) & (fv < 5e4)]
    return float(np.median(fv)) if len(fv) else fallback


def max_spanning_tree(counts: np.ndarray):
    """Kruskal maximum spanning forest on symmetric match counts."""
    n = counts.shape[0]
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    iu, ju = np.triu_indices(n, 1)
    order = np.argsort(-counts[iu, ju])
    edges = []
    for k in order:
        if counts[iu[k], ju[k]] <= 0:
            break
        i, j = int(iu[k]), int(ju[k])
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            edges.append((i, j))
    return edges


def relative_rotation(H: np.ndarray, size_i, size_j, f: float) -> np.ndarray:
    """Rrel ~ R_j R_i^T from H mapping i -> j."""
    Hc = center_normalize_H(H, size_i, size_j)
    if Hc is None:
        return np.eye(3)
    K0 = np.diag([f, f, 1.0])
    U, _, Vt = np.linalg.svd(np.linalg.inv(K0) @ Hc @ K0)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1.0]) @ Vt
    return R


def propagate_rotations(n, tree_edges, pair_H: dict, sizes, f: float, seed: int):
    """BFS rotation propagation over the spanning tree -> (N, 3, 3)."""
    R = np.tile(np.eye(3), (n, 1, 1))
    visited = np.zeros(n, bool)
    visited[seed] = True
    adj = {k: [] for k in range(n)}
    for i, j in tree_edges:
        adj[i].append(j)
        adj[j].append(i)
    queue = [seed]
    while queue:
        u = queue.pop(0)
        for v in adj[u]:
            if visited[v]:
                continue
            if (u, v) in pair_H:
                R[v] = relative_rotation(pair_H[(u, v)], sizes[u], sizes[v], f) @ R[u]
            elif (v, u) in pair_H:
                R[v] = relative_rotation(pair_H[(v, u)], sizes[v], sizes[u], f).T @ R[u]
            visited[v] = True
            queue.append(v)
    return R


def rotation_consistency(pairs, Hs, sizes, R: np.ndarray, f: float):
    """(noRotation, mean, median, max) angular error in degrees of the
    propagated rotations against the per-pair relative rotations."""
    errs = []
    for p, (i, j) in enumerate(pairs):
        Rrel = relative_rotation(Hs[p], sizes[i], sizes[j], f)
        D = R[j] @ R[i].T
        c = np.clip((np.trace(D.T @ Rrel) - 1) / 2.0, -1.0, 1.0)
        errs.append(np.degrees(np.arccos(c)))
    if not errs:
        return False, 0.0, 0.0, 0.0
    errs = np.array(errs)
    med, mx = float(np.median(errs)), float(errs.max())
    return med > 0.6 and mx > 100.0, float(errs.mean()), med, mx


def stratified_subsample(pts, size_i, cap: int, mode: str, rng: np.random.Generator,
                         grid_bins=(4, 4), polar_bins=(12, 5)) -> np.ndarray:
    """Pick `cap` of len(pts) matches ('random' | 'grid' | 'polar')."""
    Mp = len(pts)
    if Mp <= cap:
        return np.arange(Mp)
    h, w = int(size_i[0]), int(size_i[1])
    if mode == "grid":
        rows, cols = grid_bins
        rb = np.clip(np.ceil((pts[:, 1] + 1.0) * rows / h), 1, rows).astype(int)
        cb = np.clip(np.ceil((pts[:, 0] + 1.0) * cols / w), 1, cols).astype(int)
        bin_id = (rb - 1) * cols + (cb - 1)
        nbins = rows * cols
    elif mode == "polar":
        n_ang, n_rad = polar_bins
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        d = pts - np.array([cx, cy])
        ang = np.mod(np.arctan2(d[:, 1], d[:, 0]), 2 * np.pi)
        rmax = float(np.hypot(max(cx, w - 1 - cx), max(cy, h - 1 - cy)))
        rnorm = np.minimum(1.0, np.hypot(d[:, 0], d[:, 1]) / max(rmax, 1e-9))
        ab = np.minimum((ang / (2 * np.pi) * n_ang).astype(int), n_ang - 1)
        rb = np.minimum((rnorm * n_rad).astype(int), n_rad - 1)
        bin_id = ab * n_rad + rb
        nbins = n_ang * n_rad
    else:
        return rng.choice(Mp, cap, replace=False)

    counts = np.bincount(bin_id, minlength=nbins)
    nonempty = np.nonzero(counts)[0]
    q = np.zeros(nbins, int)
    if len(nonempty) > cap:
        q[nonempty[np.linspace(0, len(nonempty) - 1, cap).astype(int)]] = 1
    else:
        prop = counts[nonempty] / counts[nonempty].sum()
        q[nonempty] = np.maximum(1, np.round(prop * cap).astype(int))
        q = np.minimum(q, counts)
    while q.sum() > cap:
        b = nonempty[np.argmax(q[nonempty])]
        if q[b] <= 1:
            break
        q[b] -= 1
    room = counts - q
    while q.sum() < cap and room.sum() > 0:
        b = int(np.argmax(room))
        q[b] += 1
        room[b] -= 1
    idx = []
    for b in nonempty:
        mem = np.nonzero(bin_id == b)[0]
        if len(mem) <= q[b]:
            idx.extend(mem.tolist())
        else:
            rb_rng = np.random.default_rng((2654435761 * (int(b) + 1)) & 0x7FFFFFFF)
            idx.extend(rb_rng.choice(mem, q[b], replace=False).tolist())
    return np.array(idx[:cap], int)


def incremental_order(counts: np.ndarray, members: np.ndarray, seed: int):
    """Best-connected-first camera order starting at seed (ties -> lowest
    index)."""
    in_rem = np.zeros(counts.shape[0], bool)
    in_rem[np.asarray(members, int)] = True
    in_rem[seed] = False
    score = counts[:, seed].astype(np.int64).copy()
    order = [seed]
    for _ in range(int(in_rem.sum())):
        b = int(np.argmax(np.where(in_rem, score, -1)))
        order.append(b)
        in_rem[b] = False
        score += counts[:, b]
    return order


def _cpinv_focal(active_orig: np.ndarray, smooth_w: float, mean_w: float):
    """Focal coupling block of the Brown-Lowe prior: smoothness between
    cameras within 2 of each other in capture order + global-mean coupling."""
    k = len(active_orig)
    C = np.zeros((k, k), np.float32)
    if smooth_w > 0 and k > 1:
        act = np.asarray(active_orig, np.int64)
        near = (np.abs(act[:, None] - act[None, :]) <= 2) & ~np.eye(k, dtype=bool)
        C -= smooth_w * near
        C[np.arange(k), np.arange(k)] += smooth_w * near.sum(1)
    if mean_w > 0 and k > 1:
        C += mean_w * (np.eye(k) - 1.0 / k)
    return C


# ===========================================================================
# Device plane (torch)
# ===========================================================================

def _undistort_point(u, k1, cx, cy):
    return torch.stack(proj.undistort_pixels(u[0], u[1], k1, cx, cy))


def _project(ps, pdst, Rb_s, Rb_d, cx_s, cy_s, cx_d, cy_d, u_src):
    """Map one source-camera point into the destination camera; params
    [theta (3), f (, k1)] around the base rotations (theta evaluated at 0)."""
    R_s = geo.so3_exp(ps[:3]) @ Rb_s
    R_d = geo.so3_exp(pdst[:3]) @ Rb_d
    if ps.shape[0] > 4:
        u_src = _undistort_point(u_src, ps[4], cx_s, cy_s)
    x = (u_src[0] - cx_s) / ps[3]
    y = (u_src[1] - cy_s) / ps[3]
    ray = torch.stack([x, y, torch.ones_like(x)])
    p = R_d @ (R_s.T @ ray)
    z = p[2]
    z_safe = torch.where(z.abs() < 1e-6, torch.where(z < 0, -1e-6, 1e-6), z)
    return torch.stack([pdst[3] * p[0] / z_safe + cx_d, pdst[3] * p[1] / z_safe + cy_d]), z


def _pair_residual(pp, Rb_i, Rb_j, cx_i, cy_i, cx_j, cy_j, u_i, u_j):
    """Bidirectional residual of one match: pp = [params_i, params_j].
    Returns (r (4,), (r, z (2,))) — the aux form for jacrev."""
    pd = pp.shape[0] // 2
    p_i, p_j = pp[:pd], pp[pd:]
    pred_j, z_j = _project(p_i, p_j, Rb_i, Rb_j, cx_i, cy_i, cx_j, cy_j, u_i)
    pred_i, z_i = _project(p_j, p_i, Rb_j, Rb_i, cx_j, cy_j, cx_i, cy_i, u_j)
    if pd > 4:
        u_j = _undistort_point(u_j, p_j[4], cx_j, cy_j)
        u_i = _undistort_point(u_i, p_i[4], cx_i, cy_i)
    r = torch.cat([u_j - pred_j, u_i - pred_i])
    return r, (r, torch.stack([z_j, z_i]))


_jac_res = torch.func.vmap(torch.func.jacrev(_pair_residual, has_aux=True))


def _huber_w(r2, sigma: float):
    return torch.clamp(sigma / torch.sqrt(r2 + 1e-12), max=1.0)


def _orthonormalize(R):
    r0 = R[..., 0, :]
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = R[..., 1, :]
    r1 = r1 - (r1 * r0).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


class _Phase:
    """The compact LM subsystem of one phase: active cameras and pairs."""

    def __init__(self, Rb, f, k1, cx, cy, u_i, u_j, w, pij, pd, sigma, one_direction):
        self.cx, self.cy = cx, cy
        self.u_i, self.u_j, self.w = u_i, u_j, w
        self.pd, self.sigma, self.one_direction = pd, sigma, one_direction
        pb, M = w.shape
        nb = Rb.shape[0]
        self.ii = pij[:, 0]
        self.jj = pij[:, 1]
        dev = Rb.device
        E = torch.zeros((pb, 2, nb), device=dev)
        E[torch.arange(pb, device=dev), 0, self.ii] = 1.0
        E[torch.arange(pb, device=dev), 1, self.jj] = 1.0
        self.E = E
        self.mi = self.ii[:, None].expand(pb, M).reshape(-1)  # camera of each match
        self.mj = self.jj[:, None].expand(pb, M).reshape(-1)

    def normal_eqns(self, Rb, f, k1):
        """(H (pd nb, pd nb), g (pd nb,), robust cost) linearized at theta = 0."""
        pd = self.pd
        pb, M = self.w.shape
        nb = Rb.shape[0]
        zero3 = torch.zeros((nb, 3), device=f.device)
        cams = [zero3, f[:, None]] + ([k1[:, None]] if pd == 5 else [])
        params = torch.cat(cams, dim=1)  # (nb, pd)
        mi, mj = self.mi, self.mj
        pp = torch.cat([params[mi], params[mj]], dim=1)
        J, (r, z) = _jac_res(
            pp, Rb[mi], Rb[mj], self.cx[mi], self.cy[mi], self.cx[mj], self.cy[mj],
            self.u_i.reshape(-1, 2), self.u_j.reshape(-1, 2),
        )  # J (B, 4, 2pd), r (B, 4), z (B, 2)
        w_ij = _huber_w((r[:, :2] ** 2).sum(-1), self.sigma)
        w_ji = _huber_w((r[:, 2:] ** 2).sum(-1), self.sigma)
        if self.one_direction:
            w_ji = torch.zeros_like(w_ji)
        front = (z[:, 0] > 1e-4) & (z[:, 1] > 1e-4)
        wp = self.w.reshape(-1) * front
        w4 = torch.stack([w_ij, w_ij, w_ji, w_ji], -1) * wp[:, None]
        J = J.reshape(pb, M, 4, 2 * pd)
        r = r.reshape(pb, M, 4)
        w4 = w4.reshape(pb, M, 4)
        Jw = J * w4[..., None]
        JtJ = torch.einsum("pmab,pmac->pbc", Jw, J).reshape(pb, 2, pd, 2, pd)
        Jtg = torch.einsum("pmab,pma->pb", Jw, r).reshape(pb, 2, pd)
        cost = (w4 * r * r).sum()
        H = torch.einsum("psa,ptb,psrtc->arbc", self.E, self.E, JtJ).reshape(nb * pd, nb * pd)
        g = torch.einsum("psa,psr->ar", self.E, Jtg).reshape(nb * pd)
        return H, g, cost


def _lm_phase(Rb, f, k1, phase: _Phase, cpinv_f, seed_local: int, iters: int,
              focal_frac: float, k1_cap: float, lam0: float, cfg: BundleConfig):
    """`iters` LM iterations on one phase's compact subsystem; the accept
    test and every update are device-side selects. Returns (Rb, f, k1, cost)."""
    pd = phase.pd
    nb = Rb.shape[0]
    dev = f.device
    fbar = f.mean()
    theta_prior_w = 1.0 / (cfg.theta_prior**2)
    f_prior_w = 1.0 / ((fbar / cfg.focal_prior_frac) ** 2 + 1e-12)
    pat_theta = torch.tensor([theta_prior_w] * 3 + [0.0] * (pd - 3), device=dev)
    pat_f = torch.tensor([0.0] * 3 + [1.0] + [0.0] * (pd - 4), device=dev)
    prior_diag = pat_theta.repeat(nb) + pat_f.repeat(nb) * f_prior_w
    if pd == 5:
        pat_k1 = torch.tensor([0.0] * 4 + [1.0 / _K1_PRIOR_SIGMA**2], device=dev)
        prior_diag = prior_diag + pat_k1.repeat(nb)
    cp = torch.diag(prior_diag)
    cp[3::pd, 3::pd] += cpinv_f
    if pd == 5:
        cp[4::pd, 4::pd] += _K1_MEAN_WEIGHT * (torch.eye(nb, device=dev) - 1.0 / nb)
    cm = torch.ones(pd * nb, device=dev)
    cm[seed_local * pd : seed_local * pd + 3] = 0.0
    cp = cp * cm[:, None] * cm[None, :]
    pin = torch.diag(1.0 - cm)
    max_rot = float(np.radians(cfg.max_rotation_step_deg))
    f_lo, f_hi = float(cfg.focal_clamp[0]), float(cfg.focal_clamp[1])

    lam = torch.tensor(lam0, device=dev)
    H, g, cost = phase.normal_eqns(Rb, f, k1)
    for _ in range(iters):
        Hm = H * cm[:, None] * cm[None, :]
        gm = g * cm
        damp = torch.diagonal(Hm) + 1e-6
        Hd = Hm + cp + torch.diag(lam * damp) + pin
        L, info = torch.linalg.cholesky_ex(Hd)
        delta = -torch.cholesky_solve(gm[:, None], L)[:, 0]
        ok = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(ok, delta, torch.zeros_like(delta)).reshape(nb, pd)
        rot_norm = torch.linalg.vector_norm(delta[:, :3], dim=-1)
        rot_scale = torch.clamp(max_rot / torch.clamp(rot_norm, min=1e-12), max=1.0)
        f_cap = focal_frac * torch.clamp(f, min=1.0)
        f_scale = torch.clamp(f_cap / torch.clamp(delta[:, 3].abs(), min=1e-12), max=1.0)
        dtheta = delta[:, :3] * rot_scale[:, None]
        df = delta[:, 3] * f_scale
        parts = [dtheta, df[:, None]]
        if pd == 5:
            k1_scale = torch.clamp(k1_cap / torch.clamp(delta[:, 4].abs(), min=1e-12), max=1.0)
            dk1 = delta[:, 4] * k1_scale
            parts.append(dk1[:, None])
        d_flat = torch.cat(parts, dim=1).reshape(-1)

        Rb_c = _orthonormalize(geo.so3_exp(dtheta) @ Rb)
        f_c = torch.clamp(f + df, f_lo, f_hi)
        k1_c = torch.clamp(k1 + dk1, -_K1_CLAMP, _K1_CLAMP) if pd == 5 else k1
        H_c, g_c, cost_c = phase.normal_eqns(Rb_c, f_c, k1_c)
        pred = 0.5 * (lam * (d_flat * damp * d_flat).sum() + d_flat @ (cp @ d_flat)
                      - (d_flat * gm).sum())
        rho = (cost - cost_c) / torch.clamp(pred, min=1e-12)
        accept = (cost_c < cost) & torch.isfinite(cost_c)
        Rb = torch.where(accept, Rb_c, Rb)
        f = torch.where(accept, f_c, f)
        k1 = torch.where(accept, k1_c, k1)
        lam = torch.where(accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                          lam * 4.0)
        lam = torch.clamp(lam, 1e-9, 1e6)
        H = torch.where(accept, H_c, H)
        g = torch.where(accept, g_c, g)
        cost = torch.where(accept, cost_c, cost)
    return Rb, f, k1, cost


def run_incremental_ba(R0, f_init, cx, cy, u_i, u_j, w, loc_pairs, order, seed: int,
                       cfg: BundleConfig, with_k1: bool = False, device=None):
    """Incremental Brown-Lowe BA: camera groups join best-connected-first
    (one LM phase per step on the compact active subsystem, focal coupling
    on), then the staged final passes with focal caps (coupling off).

    R0 (N, 3, 3), f_init/cx/cy (N,) numpy; u_i/u_j (P, M, 2), w (P, M)
    numpy match data of loc_pairs (P, 2). Returns (R, f, k1 | None, cost)
    as tensors on `device`."""
    n = len(f_init)
    f0 = float(np.median(f_init))
    if cfg.focal_smoothness_weight is None:
        smooth_w = (f0 / 20.0) ** 2 * 0.5 if n <= 5 else (f0 / 50.0) ** 2 * 2.0
    else:
        smooth_w = float(cfg.focal_smoothness_weight)
    group = max(1, n // 12)
    steps = list(range(2, n + 1, group))
    if not steps or steps[-1] != n:
        steps.append(n)
    pd = 5 if with_k1 else 4

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    R = t(R0)
    f = t(f_init)
    k1 = torch.zeros(n, device=device)
    cx_d, cy_d = t(cx), t(cy)
    u_i_d, u_j_d, w_d = t(u_i), t(u_j), t(w)
    final_iters = cfg.max_iter_lm // len(cfg.focal_step_fracs) + 1
    phases = [(order[:upto], cfg.incremental_focal_frac, True, _K1_INC_STEP_CAP,
               cfg.incremental_lm_iters, upto) for upto in steps]
    phases += [(order, frac, False, _K1_STEP_CAP, final_iters, None)
               for frac in cfg.focal_step_fracs]

    phase_costs = []
    cost = torch.zeros((), device=device)
    for active, frac, couple, k1_cap, iters, upto in phases:
        act = np.asarray(active, np.int64)
        in_act = np.zeros(n, bool)
        in_act[act] = True
        psel = np.nonzero(in_act[loc_pairs[:, 0]] & in_act[loc_pairs[:, 1]])[0]
        local_of = np.zeros(n, np.int64)
        local_of[act] = np.arange(len(act))
        pij = t(local_of[loc_pairs[psel]], torch.long).reshape(-1, 2)
        cpinv = _cpinv_focal(act, smooth_w, float(cfg.focal_mean_weight)) if couple \
            else np.zeros((len(act), len(act)), np.float32)
        act_d = t(act, torch.long)
        psel_d = t(psel, torch.long)
        phase = _Phase(R[act_d], f[act_d], k1[act_d], cx_d[act_d], cy_d[act_d],
                       u_i_d[psel_d], u_j_d[psel_d], w_d[psel_d], pij, pd,
                       float(cfg.sigma_huber), bool(cfg.residual_one_direction))
        seed_local = int(local_of[seed]) if in_act[seed] else 0
        Rb, fb, kb, cost = _lm_phase(
            R[act_d], f[act_d], k1[act_d], phase, t(cpinv), seed_local, iters, frac,
            k1_cap, float(cfg.lambda0), cfg,
        )
        R = R.index_copy(0, act_d, Rb)
        f = f.index_copy(0, act_d, fb)
        k1 = k1.index_copy(0, act_d, kb)
        if upto is not None:
            phase_costs.append((upto, cost, len(psel)))

    # RMSE-history anomaly check (one deferred host read of the phase costs)
    costs = torch.stack([c for _, c, _ in phase_costs]).cpu().numpy() if phase_costs else []
    rmse_hist = []
    for (upto, _, npair), c in zip(phase_costs, costs):
        rmse = float(np.sqrt(max(float(c), 0.0) / max(npair, 1)))
        if len(rmse_hist) > 3:
            med = float(np.median(rmse_hist))
            if med > 0 and rmse > 2.5 * med:
                warnings.warn(
                    f"bundle adjustment: elevated phase RMSE {rmse:.3f} at n={upto} cameras "
                    f"(median {med:.3f}, {rmse / med:.1f}x) — possible bad camera addition",
                    RuntimeWarning, stacklevel=2,
                )
        rmse_hist.append(rmse)
    return R, f, (k1 if with_k1 else None), cost


def initialize_cameras_summary(pairs, Hs, counts, sizes, method: str = "shumSzeliskiOneHPaper"):
    """Standalone camera initialization (the reference's
    `initializeCameraMatrices.m` as one call): focal estimate, max spanning
    tree, BFS rotation propagation, rotation-consistency classification.

    Returns dict(f, R (N,3,3), seed, tree, no_rotation, consistency_deg).
    """
    n = len(sizes)
    f0 = estimate_focal(pairs, Hs, sizes, method)
    tree = max_spanning_tree(counts)
    deg = np.bincount(np.asarray(pairs).reshape(-1), minlength=n) if len(pairs) else np.zeros(n, int)
    seed = int(np.argmax(deg))
    pair_H = {(int(i), int(j)): Hs[p] for p, (i, j) in enumerate(pairs)}
    R0 = propagate_rotations(n, tree, pair_H, sizes, f0, seed)
    no_rotation, mean_ae, med_ae, max_ae = rotation_consistency(pairs, Hs, sizes, R0, f0)
    return {
        "f": f0,
        "R": R0,
        "seed": seed,
        "tree": tree,
        "no_rotation": no_rotation,
        "consistency_deg": (mean_ae, med_ae, max_ae),
    }


def run_bundle_adjustment(members, pairs, pair_idx, pair_mask, inliers, Hs, xy, counts,
                          sizes, cfg: BundleConfig = BundleConfig(),
                          force_planar: bool = False, device=None):
    """Bundle-adjust one connected component (graph arrays numpy, global
    indices; xy (N, K, 2) numpy keypoints). Returns a dict with member-local
    Cameras (tensors on `device`), the noRotation flag, focal init, seed and
    the member-local pair list."""
    members = np.asarray(members)
    n = len(members)
    remap = {int(g): k for k, g in enumerate(members)}
    sel = np.array([p for p in range(len(pairs))
                    if int(pairs[p, 0]) in remap and int(pairs[p, 1]) in remap], int)
    loc_pairs = np.array([[remap[int(i)], remap[int(j)]] for i, j in pairs[sel]], int)
    loc_sizes = sizes[members]
    loc_counts = counts[np.ix_(members, members)]

    f0 = estimate_focal(loc_pairs, Hs[sel], loc_sizes, cfg.focal_estimate_method)
    tree = max_spanning_tree(loc_counts)
    deg = np.bincount(loc_pairs.reshape(-1), minlength=n)
    seed = int(np.argmax(deg))
    pair_H = {(int(i), int(j)): Hs[sel[p]] for p, (i, j) in enumerate(loc_pairs)}
    R0 = propagate_rotations(n, tree, pair_H, loc_sizes, f0, seed)
    no_rotation, mean_ae, med_ae, max_ae = rotation_consistency(
        loc_pairs, Hs[sel], loc_sizes, R0, f0
    )
    no_rotation = no_rotation or force_planar
    cx = (loc_sizes[:, 1].astype(np.float32) - 1) / 2.0
    cy = (loc_sizes[:, 0].astype(np.float32) - 1) / 2.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    result = {
        "members": members, "pairs": loc_pairs, "pair_sel": sel, "focal_init": f0,
        "seed": seed, "no_rotation": bool(no_rotation),
        "rot_consistency_deg": (mean_ae, med_ae, max_ae),
    }
    if no_rotation:
        result["cameras"] = Cameras(R=t(R0), f=t(np.full(n, f0)), cx=t(cx), cy=t(cy))
        return result

    P = len(sel)
    M = min(cfg.max_matches, pair_mask.shape[1])
    u_i = np.zeros((P, M, 2), np.float32)
    u_j = np.zeros((P, M, 2), np.float32)
    w = np.zeros((P, M), np.float32)
    for k, p in enumerate(sel):
        idxs = np.nonzero(pair_mask[p] & inliers[p])[0]
        if len(idxs) > M:
            rng = np.random.default_rng(1000003 * int(pairs[p, 0]) + int(pairs[p, 1]))
            gi0 = int(pairs[p, 0])
            pick = stratified_subsample(
                xy[gi0, pair_idx[p, idxs, 0]], sizes[gi0], M, cfg.subsample_mode, rng,
                grid_bins=cfg.subsample_grid_bins, polar_bins=cfg.subsample_polar_bins,
            )
            idxs = idxs[pick]
        c = len(idxs)
        gi, gj = int(pairs[p, 0]), int(pairs[p, 1])
        u_i[k, :c] = xy[gi, pair_idx[p, idxs, 0]]
        u_j[k, :c] = xy[gj, pair_idx[p, idxs, 1]]
        w[k, :c] = 1.0

    order = incremental_order(loc_counts, np.arange(n), seed)
    R_ba, f_ba, k1_ba, cost = run_incremental_ba(
        R0, np.full(n, f0, np.float32), cx, cy, u_i, u_j, w, loc_pairs, order, seed, cfg,
        with_k1=bool(cfg.estimate_distortion), device=device,
    )
    result["cameras"] = Cameras(R=R_ba, f=f_ba, cx=t(cx), cy=t(cy), k1=k1_ba)
    result["final_cost"] = float(cost)
    return result
