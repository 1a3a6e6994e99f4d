"""Joint 8-DOF homography bundle adjustment, the planar-scan path (port of
`models/bundle_h.py`, the reference's `bundleAdjustmentH.m`).

Refines absolute homographies G_i (image i -> common canvas, G_anchor = I)
by Levenberg-Marquardt on the canvas-space residual
    r = Pi(G_i u_i) - Pi(G_j u_j)
(unidirectional, the reference default) or the bidirectional chain residual
through adj(G_j) G_i and adj(G_i) G_j, with Huber weights, the RegProj /
RegDet regulariser residuals and the gain-ratio lambda update of the
reference, over a dense 8N x 8N normal system solved by Cholesky.

The match Jacobians (2 x 16, or 4 x 16 bidirectional) and the 3 x 8
regulariser Jacobian are written in closed form; the tests hold them
against `torch.func.jacrev`. Autodiff would give the same numbers, but on
the card the first `vmap(jacrev(...))` of a process costs seconds of
start-up and every iteration a storm of small launches. The LM loop keeps
its accept/reject and lambda decisions on the device, and the problem is
padded to a bucketed (cameras, pairs) shape: on CUDA the whole loop is one
replay of a CUDA graph keyed on that shape, captured at its first call in
the process (`models/bundle.run_graphed`), the counterpart of the
reference's jitted `lax.scan`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from autopanostitch_tpu_torch.config import BundleConfig
from autopanostitch_tpu_torch.models.bundle import _bucket, run_graphed
from autopanostitch_tpu_torch.models.planar import chain_to_anchor
from autopanostitch_tpu_torch.utils import trace


def params_to_H(p):
    """(..., 8) -> (..., 3, 3) with H33 = 1."""
    return torch.cat([p, torch.ones_like(p[..., :1])], -1).reshape(p.shape[:-1] + (3, 3))


def _hom(u):
    return torch.cat([u, torch.ones_like(u[..., :1])], -1)


def _proj_w(w):
    """Pi of (..., 3) points with the reference's |z| < 1e-8 clamp. Returns
    (x (..., 2), dPi/dw (..., 2, 3)); the clamped z is a constant, so its
    column of the derivative is 0 there."""
    z = w[..., 2]
    clamped = z.abs() < 1e-8
    zs = torch.where(clamped, torch.where(z < 0, -1e-8, 1e-8).to(z.dtype), z)
    x = w[..., :2] / zs[..., None]
    inv = 1.0 / zs
    live = (~clamped).to(w.dtype)
    zero = torch.zeros_like(inv)
    D = torch.stack([
        torch.stack([inv, zero, -x[..., 0] * inv * live], -1),
        torch.stack([zero, inv, -x[..., 1] * inv * live], -1),
    ], -2)
    return x, D


def _dH_times(A, uh):
    """d(A H uh)/dp for the 8 free entries p of H (row-major, H33 fixed):
    entry k = (r, c) contributes A[:, r] * uh[c]. A (..., 3, 3), uh
    (..., 3) -> (..., 3, 8)."""
    cols = [A[..., :, k // 3] * uh[..., k % 3, None] for k in range(8)]
    return torch.stack(cols, -1)


def _adj(H):
    """Adjugate rows (c1 x c2, c2 x c0, c0 x c1) of the columns c of H:
    inv(H) up to the determinant, which Pi ignores."""
    c0, c1, c2 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    return torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                        torch.linalg.cross(c0, c1)], -2)


def _dadj_times(H, v):
    """d(adj(H) v)/dp for the 8 free entries of H. Row o of adj(H) v is a
    triple product of v with two columns of H; its gradient with respect
    to column c is g[o][c] below, and entry (r, c) of H picks component r.
    H (..., 3, 3), v (..., 3) -> (..., 3, 8)."""
    c0, c1, c2 = (torch.broadcast_to(H[..., :, k], v.shape) for k in range(3))
    x = torch.linalg.cross
    z = torch.zeros_like(v)
    g = [[z, x(c2, v), x(v, c1)],
         [x(v, c2), z, x(c0, v)],
         [x(c1, v), x(v, c0), z]]
    return torch.stack([torch.stack([g[o][k % 3][..., k // 3] for k in range(8)], -1)
                        for o in range(3)], -2)


def match_residual_jac(p_i, p_j, u_i, u_j, bidir: bool = False):
    """Residuals and closed-form Jacobians of matches: p_i, p_j (..., 8)
    broadcast against u_i, u_j (..., 2). Returns (r (..., R), J (..., R, 16))
    with R = 2 (unidirectional) or 4 (bidirectional), J over [p_i, p_j]."""
    Hi, Hj = params_to_H(p_i), params_to_H(p_j)
    ui, uj = _hom(u_i), _hom(u_j)
    if not bidir:
        xi, Di = _proj_w((Hi @ ui[..., None])[..., 0])
        xj, Dj = _proj_w((Hj @ uj[..., None])[..., 0])
        eye = torch.eye(3, dtype=Hi.dtype, device=Hi.device).expand(Hi.shape)
        Ji = Di @ _dH_times(eye, ui)
        Jj = Dj @ _dH_times(eye, uj)
        return xi - xj, torch.cat([Ji, -Jj], -1)

    def half(Ha, Hb, ua, ub):
        # ub - Pi(adj(Hb) Ha ua): d/dpa through Ha, d/dpb through adj(Hb)
        A = _adj(Hb)
        v = (Ha @ ua[..., None])[..., 0]
        x, D = _proj_w((A @ v[..., None])[..., 0])
        return ub[..., :2] - x, -(D @ _dH_times(A, ua)), -(D @ _dadj_times(Hb, v))

    rf, Jf_i, Jf_j = half(Hi, Hj, ui, uj)
    rb, Jb_j, Jb_i = half(Hj, Hi, uj, ui)
    J = torch.cat([torch.cat([Jf_i, Jf_j], -1), torch.cat([Jb_i, Jb_j], -1)], -2)
    return torch.cat([rf, rb], -1), J


def match_residual(p_i, p_j, u_i, u_j, bidir: bool = False):
    """The residuals alone, written as the reference writes them (the
    autodiff target of the Jacobian tests)."""
    def proj(H, u):
        ph = H @ _hom(u)
        z = ph[2]
        zs = torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8).to(z.dtype), z)
        return ph[:2] / zs

    Hi, Hj = params_to_H(p_i), params_to_H(p_j)
    if not bidir:
        return proj(Hi, u_i) - proj(Hj, u_j)
    return torch.cat([u_j - proj(_adj(Hj) @ Hi, u_i), u_i - proj(_adj(Hi) @ Hj, u_j)])


def reg_residual_jac(p, sq_proj: float, sq_det: float):
    """Per-camera regulariser residuals (`bundleAdjustmentH.m:437-499`):
    sqrt(RegProj) (H31, H32) and sqrt(RegDet) log|det of the 2 x 2|, with
    their Jacobian. p (N, 8) -> (r (N, 3), J (N, 3, 8))."""
    det2 = p[:, 0] * p[:, 4] - p[:, 1] * p[:, 3]
    r = torch.stack([sq_proj * p[:, 6], sq_proj * p[:, 7],
                     sq_det * torch.log(torch.clamp(det2.abs(), min=1e-8))], -1)
    J = torch.zeros(p.shape[0], 3, 8, dtype=p.dtype, device=p.device)
    J[:, 0, 6] = sq_proj
    J[:, 1, 7] = sq_proj
    g = torch.where(det2.abs() > 1e-8, sq_det / det2, torch.zeros_like(det2))
    J[:, 2, 0] = g * p[:, 4]
    J[:, 2, 1] = -g * p[:, 3]
    J[:, 2, 3] = -g * p[:, 1]
    J[:, 2, 4] = g * p[:, 0]
    return r, J


def reg_residual(p, sq_proj: float, sq_det: float):
    """(3,) regulariser residuals of one camera (the autodiff target)."""
    det2 = p[0] * p[4] - p[1] * p[3]
    return torch.stack([sq_proj * p[6], sq_proj * p[7],
                        sq_det * torch.log(torch.clamp(det2.abs(), min=1e-8))])


def _build(params, pair_ij, u_i, u_j, wv, sigma, sq_proj, sq_det, bidir):
    """Dense normal system (H (8N, 8N), g (8N,), cost) at params (N, 8)."""
    N = params.shape[0]
    i, j = pair_ij[:, 0], pair_ij[:, 1]
    r, J = match_residual_jac(params[i][:, None], params[j][:, None], u_i, u_j, bidir)
    rn2 = (r * r).sum(-1)
    wm = wv * torch.clamp(sigma / torch.sqrt(rn2 + 1e-12), max=1.0)  # (P, M)
    Jw = J * wm[..., None, None]
    JtJ = torch.einsum("pmab,pmac->pbc", Jw, J)  # (P, 16, 16)
    Jtg = torch.einsum("pmab,pma->pb", Jw, r)
    cost = (wm[..., None] * r * r).sum()
    ar = torch.arange(8, device=params.device)
    cols = torch.cat([i[:, None] * 8 + ar, j[:, None] * 8 + ar], 1)  # (P, 16)
    H = torch.zeros((8 * N, 8 * N), dtype=params.dtype, device=params.device)
    H.index_put_((cols[:, :, None].expand(-1, -1, 16), cols[:, None, :].expand(-1, 16, -1)),
                 JtJ, accumulate=True)
    g = torch.zeros(8 * N, dtype=params.dtype, device=params.device)
    g.index_put_((cols,), Jtg, accumulate=True)
    rr, Jr = reg_residual_jac(params, sq_proj, sq_det)
    rows = torch.arange(N, device=params.device)[:, None] * 8 + ar  # (N, 8)
    H.index_put_((rows[:, :, None].expand(-1, -1, 8), rows[:, None, :].expand(-1, 8, -1)),
                 torch.einsum("nab,nac->nbc", Jr, Jr), accumulate=True)
    g.index_put_((rows,), torch.einsum("nab,na->nb", Jr, rr), accumulate=True)
    return H, g, cost + (rr * rr).sum()


def _lm_inputs(params0, pair_ij, u_i, u_j, wv, seed_idx: int, lam0: float, nb: int,
               pb: int) -> dict:
    """The LM's device inputs, padded to nb cameras and pb pairs: a padded
    camera is the identity (no regulariser cost), a padded pair joins
    camera 0 to itself with weight 0. `col_mask` (8 nb) is 0 on the seed's
    and the padded cameras' columns."""
    N = params0.shape[0]
    dev, dt = params0.device, params0.dtype
    cam = torch.zeros(nb, dtype=dt, device=dev)
    cam[:N] = 1.0
    cam[seed_idx] = 0.0
    eye = torch.eye(3, dtype=dt, device=dev).reshape(1, 9)[:, :8]

    def pad(x):
        return torch.cat([x, x.new_zeros((pb - x.shape[0],) + x.shape[1:])])

    return dict(params=torch.cat([params0, eye.expand(nb - N, 8)]), pair_ij=pad(pair_ij),
                u_i=pad(u_i), u_j=pad(u_j), w=pad(wv), col_mask=cam.repeat_interleave(8),
                lam0=torch.full((), lam0, dtype=dt, device=dev))


def _lm_h(inp: dict, iters: int, sigma: float, sq_proj: float, sq_det: float, bidir: bool):
    """`iters` LM iterations on `_lm_inputs`' problem, with no host read and
    no upload, so a CUDA graph holds them whole. The masked columns (the
    seed's: the gauge; the padded cameras') are taken out of the system
    with a unit diagonal put back; a non-finite or failed solve gives a
    zero step; the predicted reduction uses the damping of the solve.
    Returns ((nb, 8) params, the last candidate's cost)."""
    params, lam, col_mask = inp["params"], inp["lam0"], inp["col_mask"]
    nb = params.shape[0]
    pin = torch.diag(1.0 - col_mask)
    cost_new = torch.zeros((), dtype=params.dtype, device=params.device)
    args = (inp["pair_ij"], inp["u_i"], inp["u_j"], inp["w"], sigma, sq_proj, sq_det, bidir)
    for _ in range(iters):
        H, g, cost = _build(params, *args)
        H = H * col_mask[:, None] * col_mask[None, :]
        g = g * col_mask
        dH = torch.diagonal(H) + 1e-6
        Hd = H + torch.diag(lam * dH) + pin
        L, info = torch.linalg.cholesky_ex(Hd)
        delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
        good = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(good, delta, torch.zeros_like(delta))
        cand = params + delta.reshape(nb, 8)
        _, _, cost_new = _build(cand, *args)
        pred = 0.5 * (lam * (delta * dH * delta).sum() - (delta * g).sum())
        rho = (cost - cost_new) / torch.clamp(pred, min=1e-12)
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        params = torch.where(accept, cand, params)
        lam = torch.where(accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                          lam * 4.0)
        lam = torch.clamp(lam, 1e-9, 1e6)
    return params, cost_new


def bundle_adjust_h(params0, pair_ij, u_i, u_j, w, pair_valid, seed_idx: int,
                    cfg: BundleConfig = BundleConfig(), iters: int = 40, bidir: bool = False,
                    graphs: bool = True):
    """Joint LM over all homographies (tensors on one device; the seed's
    homography is held), padded to nb = _bucket(N, 8) cameras and pb =
    _bucket(P, 8) pairs and run by `_lm_h`: on CUDA one replay of the graph
    of that shape (`graphs=False` runs the same padded LM eagerly). Returns
    ((N, 8) params, final cost) as tensors; the cost is the last
    candidate's, as the reference returns it."""
    N, (P, M) = params0.shape[0], w.shape
    nb, pb = _bucket(N, 8), _bucket(P, 8)
    sigma = float(cfg.sigma_huber)
    sq_proj = float(np.sqrt(np.float32(cfg.reg_proj)))
    sq_det = float(np.sqrt(np.float32(cfg.reg_det)))
    inp = _lm_inputs(params0, pair_ij, u_i, u_j, w * pair_valid[:, None].to(w.dtype), seed_idx,
                     float(cfg.lambda0), nb, pb)
    run = functools.partial(_lm_h, iters=iters, sigma=sigma, sq_proj=sq_proj, sq_det=sq_det,
                            bidir=bidir)
    params, cost = run_graphed(("h", nb, pb, M, bidir, iters, sigma, sq_proj, sq_det), inp, run,
                               graphs)
    return params[:N].clone(), cost.clone()  # a graph's outputs: its next replay rewrites them


def run_bundle_adjustment_h(loc_pairs: np.ndarray, Hs: np.ndarray, pair_coords, n: int,
                            cfg: BundleConfig = BundleConfig(), anchor: int | None = None,
                            device="cuda"):
    """Chain initialisation + joint homography refinement of one planar
    component. Hs[p] maps loc_pairs[p, 0] -> loc_pairs[p, 1]; pair_coords =
    (u_i (P, M, 2), u_j (P, M, 2), w (P, M)) inlier coordinates (numpy).
    Returns dict(H_abs (n, 3, 3) refined, image -> anchor frame; H_init;
    reachable; anchor; final_cost)."""
    with trace.span("ba_h.chain"):
        H_abs, reachable, anchor = chain_to_anchor(loc_pairs, Hs, n, anchor)
        u_i, u_j, w = pair_coords
        loc_pairs = np.asarray(loc_pairs).reshape(-1, 2)
        pv = reachable[loc_pairs[:, 0]] & reachable[loc_pairs[:, 1]]
        flat = H_abs.reshape(n, 9)
        params0 = (flat[:, :8] / flat[:, 8:9]).astype(np.float32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    with trace.span("ba_h.upload"):
        inputs = (t(params0), t(loc_pairs, torch.long), t(u_i), t(u_j), t(w), t(pv, torch.bool))
    with trace.span("ba_h.lm"):
        params, cost = bundle_adjust_h(*inputs, int(anchor), cfg=cfg, iters=cfg.max_iter_lm,
                                       bidir=not cfg.h_one_direction)
    trace.count("ba.phases")
    trace.count("ba.lm_iterations", cfg.max_iter_lm)
    with trace.span("ba_h.readback"):
        params = params.cpu().numpy()
        cost = float(cost)
    H_ref = np.concatenate([params, np.ones((n, 1), np.float32)], -1).reshape(n, 3, 3)
    return {"H_abs": H_ref, "H_init": H_abs, "reachable": reachable, "anchor": anchor,
            "final_cost": cost}
