"""Brown-Lowe bundle adjustment over rotation + focal (+ k1) (port of
`models/bundle.py`).

Host control plane (numpy, copied from the reference because its module
imports jax): focal estimation from homographies, maximum spanning tree,
BFS rotation propagation, rotation-consistency classifier, stratified
match subsampling, incremental camera order.

Device plane (torch): the incremental LM. Each phase works on the compact
subsystem of the active cameras, padded to a bucketed shape as the
reference pads it; its dense (pd*nb)^2 normal equations come from the
`ba_system` kernel (`kernels/ba.py`: closed-form Jacobians of the
bidirectional residual, summed over each pair's real matches and assembled
from each camera's incidence list) and are solved by Cholesky, and the
accept/reject decision, the lambda schedule and the state update are
`torch.where`s on the device, so an LM iteration never waits for the host.
On CUDA a phase is one replay of a CUDA graph captured once per phase shape
and process (`_PhaseGraph`), the counterpart of the reference's
`lm_phase_group`.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import numpy as np
import torch

from autopanostitch_tpu_torch.config import BundleConfig
from autopanostitch_tpu_torch.kernels import ba as kba
from autopanostitch_tpu_torch.ops import geometry as geo
from autopanostitch_tpu_torch.utils import trace

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

def _orthonormalize(R):
    r0 = R[..., 0, :]
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = R[..., 1, :]
    r1 = r1 - (r1 * r0).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def _bucket(x: int, lo: int) -> int:
    """Next power of two >= max(x, lo): phase shapes, and so the CUDA
    graphs keyed on them, are few and shared across phases and stitches."""
    return max(lo, 1 << int(np.ceil(np.log2(max(x, 1)))))


class _Statics(NamedTuple):
    """The BundleConfig scalars an LM phase bakes in (part of its graph key)."""

    sigma: float
    one_direction: bool
    theta_prior: float
    focal_prior_frac: float
    max_rot: float  # radians
    f_lo: float
    f_hi: float


def _statics(cfg: BundleConfig) -> _Statics:
    return _Statics(float(cfg.sigma_huber), bool(cfg.residual_one_direction),
                    float(cfg.theta_prior), float(cfg.focal_prior_frac),
                    float(np.radians(cfg.max_rotation_step_deg)), float(cfg.focal_clamp[0]),
                    float(cfg.focal_clamp[1]))


class _PhaseSpec(NamedTuple):
    """Host-built arrays of one LM phase, padded to its (nb, pb) shape:
    ints = [cam_take (nb), pair_take (pb), pij (pb, 2), ext (pb), inc_off
    (nb + 1), inc (2 pb)] and floats =
    [cam_ok (nb), seed one-hot (nb), pair_ok (pb), cpinv (nb, nb),
    focal_frac, k1_cap, lam0]."""

    act: np.ndarray
    npair: int
    nb: int
    pb: int
    iters: int
    ints: np.ndarray
    floats: np.ndarray


def pair_extents(w) -> np.ndarray:
    """Each pair's match extent: the last slot with w > 0, plus 1 (0 for a
    pair without one). w (P, M) numpy."""
    real = np.asarray(w) > 0
    return np.where(real.any(1), real.shape[1] - np.argmax(real[:, ::-1], axis=1), 0).astype(
        np.int64)


def _phase_spec(n: int, loc_pairs, extents, active, seed: int, cpinv, focal_frac: float,
                k1_cap: float, lam0: float, iters: int, buckets=(64, 8)) -> _PhaseSpec:
    """One phase's compact subsystem: the active cameras and the pairs
    between them, padded as the reference's `phase_arrays` pads them (nb =
    _bucket(k, 64), pb = _bucket(pairs, 8); `buckets=None` keeps the exact
    sizes). Padded cameras repeat camera 0 under cam_ok = 0, padded pairs
    pair 0 with weight 0 and extent 0. extents (P,) are `pair_extents` of
    loc_pairs' matches; each camera's incidence list holds the phase's
    pairs that touch it as entries 2 x pair + side, in ascending pair order
    (CSR: offsets inc_off, entries inc; padded pairs are in none). cpinv (k,
    k) or None (no focal coupling)."""
    act = np.asarray(active, np.int64)
    in_act = np.zeros(n, bool)
    in_act[act] = True
    psel = np.nonzero(in_act[loc_pairs[:, 0]] & in_act[loc_pairs[:, 1]])[0]
    k, q = len(act), len(psel)
    nb, pb = (_bucket(k, buckets[0]), _bucket(q, buckets[1])) if buckets else (k, q)
    local_of = np.zeros(n, np.int64)
    local_of[act] = np.arange(k)
    cam_take = np.zeros(nb, np.int64)
    cam_take[:k] = act
    pair_take = np.zeros(pb, np.int64)
    pair_take[:q] = psel
    pij = np.zeros((pb, 2), np.int64)
    pij[:q] = local_of[loc_pairs[psel]]
    ext = np.zeros(pb, np.int64)
    ext[:q] = np.asarray(extents)[psel]
    side_cam = pij[:q].reshape(-1)  # the camera of entry 2 x pair + side
    inc = np.zeros(2 * pb, np.int64)
    inc[: 2 * q] = np.argsort(side_cam, kind="stable")  # stable: pairs ascend in each list
    inc_off = np.zeros(nb + 1, np.int64)
    inc_off[1:] = np.cumsum(np.bincount(side_cam, minlength=nb))
    cam_ok = np.zeros(nb, np.float32)
    cam_ok[:k] = 1.0
    seed_1h = np.zeros(nb, np.float32)
    seed_1h[local_of[seed] if in_act[seed] else 0] = 1.0
    pair_ok = np.zeros(pb, np.float32)
    pair_ok[:q] = 1.0
    cp = np.zeros((nb, nb), np.float32)
    if cpinv is not None:
        cp[:k, :k] = cpinv
    floats = np.concatenate([cam_ok, seed_1h, pair_ok, cp.reshape(-1),
                             np.array([focal_frac, k1_cap, lam0], np.float32)])
    return _PhaseSpec(act, q, nb, pb, iters,
                      np.concatenate([cam_take, pair_take, pij.reshape(-1), ext, inc_off, inc]),
                      floats)


def _phase_inputs(spec: _PhaseSpec, ints, floats, R, f, k1, cx, cy, u_i, u_j, w) -> dict:
    """The phase's device inputs: the spec's uploaded arrays (`ints`,
    `floats`, views) and its cameras and pairs gathered from the state."""
    nb, pb = spec.nb, spec.pb
    cam_take, pair_take, pij, ext, inc_off, inc = torch.split(
        ints, [nb, pb, 2 * pb, pb, nb + 1, 2 * pb])
    cam_ok, seed_1h, pair_ok, cpinv, sc = torch.split(floats, [nb, nb, pb, nb * nb, 3])
    return dict(Rb=R[cam_take], f=f[cam_take], k1=k1[cam_take], cx=cx[cam_take], cy=cy[cam_take],
                u_i=u_i[pair_take], u_j=u_j[pair_take], w=w[pair_take] * pair_ok[:, None],
                pij=pij.view(pb, 2), ext=ext, inc_off=inc_off, inc=inc, cam_ok=cam_ok, seed=seed_1h, cpinv=cpinv.view(nb, nb),
                focal_frac=sc[0], k1_cap=sc[1], lam0=sc[2])


def _normal_eqns(Rb, f, k1, inp: dict, pd: int, st: _Statics):
    """(H (pd nb, pd nb), g (pd nb,), robust cost) linearized at theta = 0:
    the `ba_system` kernel (deterministic, no scatter)."""
    return kba.ba_system(Rb, f, k1, inp["cx"], inp["cy"], inp["u_i"], inp["u_j"], inp["w"],
                         inp["pij"], inp["ext"], inp["inc_off"], inp["inc"], pd, st.sigma,
                         st.one_direction)


def _lm_phase(inp: dict, pd: int, iters: int, st: _Statics):
    """`iters` LM iterations on one phase's compact subsystem (the
    reference's `_lm_phase_body`): no host sync and no host-to-device copy,
    so a CUDA graph can hold it whole. The accept test and every update are
    device-side selects; padded cameras (cam_ok = 0) are pinned and keep
    their state. Each iteration linearizes its CANDIDATE (the reference
    linearizes only on accept): the candidate's cost is the one the accept
    test needs, and the accepted state's system is then already at hand.
    Returns (Rb, f, k1, cost)."""
    Rb, f, k1 = inp["Rb"], inp["f"], inp["k1"]
    nb = Rb.shape[0]
    dev = f.device
    okf = inp["cam_ok"]
    ok = okf > 0
    # Brown-Lowe prior precision CpInv (the reference's buildBrownLowePrior)
    fbar = (f * okf).sum() / torch.clamp(okf.sum(), min=1.0)
    f_prior_w = 1.0 / ((fbar / st.focal_prior_frac) ** 2 + 1e-12)
    slot = torch.arange(nb * pd, device=dev) % pd
    prior_diag = (torch.where(slot < 3, 1.0 / st.theta_prior**2, 0.0).to(f.dtype)
                  + (slot == 3) * f_prior_w)
    if pd == 5:
        k1_diag = torch.where(slot == 4, 1.0 / _K1_PRIOR_SIGMA**2, 0.0)
        prior_diag = prior_diag + k1_diag.to(f.dtype)
    cp = torch.diag(prior_diag)
    cp[3::pd, 3::pd] += inp["cpinv"]
    if pd == 5:  # same-lens coupling of the active cameras' k1
        kact = torch.clamp(okf.sum(), min=1.0)
        cp[4::pd, 4::pd] += _K1_MEAN_WEIGHT * (torch.diag(okf) - okf[:, None] * okf[None, :] / kact)
    # active columns, less the gauge: the seed camera's rotation
    theta_slot = torch.arange(pd, device=dev) < 3
    cm = (okf[:, None] * (1.0 - inp["seed"][:, None] * theta_slot)).reshape(-1)
    cp = cp * cm[:, None] * cm[None, :]
    pin = torch.diag(1.0 - cm)
    focal_frac, k1_cap = inp["focal_frac"], inp["k1_cap"]

    lam = inp["lam0"]
    H, g, cost = _normal_eqns(Rb, f, k1, inp, pd, st)
    for _ in range(iters):
        Hm = H * cm[:, None] * cm[None, :]
        gm = g * cm
        damp = torch.diagonal(Hm) + 1e-6
        Hd = Hm + cp + torch.diag(lam * damp) + pin
        L, info = torch.linalg.cholesky_ex(Hd)
        delta = -torch.cholesky_solve(gm[:, None], L)[:, 0]
        good = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(good, delta, torch.zeros_like(delta)).reshape(nb, pd)
        rot_norm = torch.linalg.vector_norm(delta[:, :3], dim=-1)
        rot_scale = torch.clamp(st.max_rot / torch.clamp(rot_norm, min=1e-12), max=1.0)
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

        Rb_c = torch.where(ok[:, None, None], _orthonormalize(geo.so3_exp(dtheta) @ Rb), Rb)
        f_c = torch.where(ok, torch.clamp(f + df, st.f_lo, st.f_hi), f)
        k1_c = torch.where(ok, torch.clamp(k1 + dk1, -_K1_CLAMP, _K1_CLAMP), k1) if pd == 5 else k1
        H_c, g_c, cost_c = _normal_eqns(Rb_c, f_c, k1_c, inp, pd, st)
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


class _PhaseGraph:
    """One LM phase shape, or one homography LM shape, captured as a CUDA
    graph (the counterpart of the reference's `lm_phase_group` program and
    of its jitted homography `lax.scan`): static input buffers, filled
    before each replay, and the output tensors each replay rewrites. The
    graph holds the phase's `iters` iterations whole, so a phase is one
    replay with no kernel launched from Python in between. It keeps its own
    memory pool: the dense system and the iterations' temporaries."""

    def __init__(self, inp: dict, run):
        dev = next(iter(inp.values())).device
        with torch.cuda.device(dev):
            self.inputs = {k: v.clone() for k, v in inp.items()}
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):  # warm-up: library handles and workspaces
                run(self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = trace.launch_counts(captured=True)
            # thread_local: a collective library's watchdog thread (NCCL
            # under `parallel/`) may query events while this thread captures
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.outputs = run(self.inputs)
            # the kernel launches the graph holds, which each replay runs again
            self.launches = {k: n - before.get(k, 0)
                             for k, n in trace.launch_counts(captured=True).items()
                             if n != before.get(k, 0)}
        global graph_captures
        graph_captures += 1
        trace.count("ba.graph_captures")

    def __call__(self, inp: dict):
        global graph_replays
        for k, v in inp.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        for name, n in self.launches.items():
            trace.launched(name, n)
        graph_replays += 1
        trace.count("ba.graph_replays")
        return self.outputs


# (device, pd, iters, statics, (pb, M, 2), nb) -> _PhaseGraph of a rotational
# phase; (device, "h", ...) of the homography LM (`bundle_h.bundle_adjust_h`)
_graphs: dict = {}
graph_captures = 0  # _PhaseGraph captures in this process
graph_replays = 0  # their replays


def run_graphed(key: tuple, inp: dict, run, graphs: bool):
    """run(inp), for an `inp` of tensors on one device whose shapes and
    baked-in scalars `key` names: on CUDA (unless `graphs` is False) a
    replay of the graph cached under (device,) + key, captured at the key's
    first call in the process; eagerly otherwise. Tags the open span `ran`
    = capture / replay / eager. A replay's outputs are the graph's own
    buffers, which its next replay rewrites. A failed capture or replay
    raises."""
    dev = next(iter(inp.values())).device
    if dev.type != "cuda" or not graphs:
        trace.tag(ran="eager")
        return run(inp)
    key = (dev,) + key
    graph = _graphs.get(key)
    trace.tag(ran="replay" if graph is not None else "capture")
    if graph is None:
        graph = _graphs[key] = _PhaseGraph(inp, run)
    return graph(inp)


def _run_phase(inp: dict, pd: int, iters: int, st: _Statics, graphs: bool):
    """One LM phase, from the graph of its shape on CUDA (`run_graphed`)."""
    trace.count("ba.phases")
    trace.count("ba.lm_iterations", iters)
    return run_graphed((pd, iters, st, tuple(inp["u_i"].shape), inp["Rb"].shape[0]), inp,
                       functools.partial(_lm_phase, pd=pd, iters=iters, st=st), graphs)


def _phase_plan(f_init, loc_pairs, extents, order, seed: int, cfg: BundleConfig):
    """The phases of `run_incremental_ba`: one a step of camera groups
    joining best-connected-first (focal coupling on), then the staged final
    passes with focal caps (coupling off). extents: `pair_extents` of the
    pairs' matches. Returns their specs and, for each, the number of
    cameras it holds (None for the final passes)."""
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
    final_iters = cfg.max_iter_lm // len(cfg.focal_step_fracs) + 1
    phases = [(order[:upto], cfg.incremental_focal_frac, True, _K1_INC_STEP_CAP,
               cfg.incremental_lm_iters, upto) for upto in steps]
    phases += [(order, frac, False, _K1_STEP_CAP, final_iters, None)
               for frac in cfg.focal_step_fracs]
    specs = [_phase_spec(n, loc_pairs, extents, active, seed,
                         _cpinv_focal(np.asarray(active), smooth_w, float(cfg.focal_mean_weight))
                         if couple else None, frac, k1_cap, float(cfg.lambda0), iters)
             for active, frac, couple, k1_cap, iters, _ in phases]
    return specs, [p[-1] for p in phases]


def run_incremental_ba(R0, f_init, cx, cy, u_i, u_j, w, loc_pairs, order, seed: int,
                       cfg: BundleConfig, with_k1: bool = False, device=None,
                       graphs: bool = True):
    """Incremental Brown-Lowe BA: camera groups join best-connected-first
    (one LM phase per step on the compact active subsystem, focal coupling
    on), then the staged final passes with focal caps (coupling off).

    Every phase is padded to a bucketed (nb, pb) shape. Its host arrays are
    built up front and uploaded in one copy; on CUDA each phase is then one
    CUDA graph replay (`_run_phase`; `graphs=False` runs the same phases
    eagerly, the card's yardstick). The phase costs are read back once.

    R0 (N, 3, 3), f_init/cx/cy (N,) numpy; u_i/u_j (P, M, 2), w (P, M)
    numpy match data of loc_pairs (P, 2). Returns (R, f, k1 | None, cost)
    as tensors on `device`."""
    n = len(f_init)
    pd = 5 if with_k1 else 4
    st = _statics(cfg)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    with trace.span("ba.upload"):
        specs, uptos = _phase_plan(f_init, loc_pairs, pair_extents(w), order, seed, cfg)
        ints = torch.split(t(np.concatenate([s.ints for s in specs]), torch.long),
                           [len(s.ints) for s in specs])
        floats = torch.split(t(np.concatenate([s.floats for s in specs])),
                             [len(s.floats) for s in specs])
        R = t(R0)
        f = t(f_init)
        k1 = torch.zeros(n, device=device)
        cx_d, cy_d = t(cx), t(cy)
        u_i_d, u_j_d, w_d = t(u_i), t(u_j), t(w)

    phase_costs = []
    cost = torch.zeros((), device=device)
    for spec, ints_p, floats_p, upto in zip(specs, ints, floats, uptos):
        with trace.span("ba.phase"):
            inp = _phase_inputs(spec, ints_p, floats_p, R, f, k1, cx_d, cy_d, u_i_d, u_j_d, w_d)
            Rb, fb, kb, cost = _run_phase(inp, pd, spec.iters, st, graphs)
            k = len(spec.act)
            act_d = ints_p[:k]
            R = R.index_copy(0, act_d, Rb[:k])
            f = f.index_copy(0, act_d, fb[:k])
            k1 = k1.index_copy(0, act_d, kb[:k])
            cost = cost.clone()  # a graph's output: its next replay rewrites it
        if upto is not None:
            phase_costs.append((upto, cost, spec.npair))

    # RMSE-history anomaly check (one deferred host read of the phase costs)
    with trace.span("ba.readback"):
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
    with trace.span("ba.init"):  # focal, initial cameras, the pairs' inliers
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
