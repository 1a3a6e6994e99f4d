"""`ba_normals`: the rotational bundle adjustment's per-pair normal
equations — CUDA kernel wrapper and plain version.

Replaces `pair_system` (`autopanostitch_tpu/models/bundle.py:682`), which
the JAX package leaves to XLA (no Pallas kernel): for each pair of an LM
phase, over its M matches, the bidirectional residual r (4), its Jacobian J
(4 x 2pd) against [theta_i, f_i(, k1_i), theta_j, f_j(, k1_j)] at theta = 0,
the Huber IRLS weights, the front-facing mask and the match weight, summed
into the pair's J^T W J (2pd x 2pd), J^T W r (2pd) and robust cost.

The Jacobian is written in closed form (Brown-Lowe Eq. 20-23): with
R = exp([theta]x) R_b, dR/dtheta_k at 0 is [e_k]x R_b, so a source rotation
moves the world ray by -R_b^T (e_k x ray) and a destination rotation moves
the point by e_k x p; k1 enters only through `undistort_pixels`, linearly.
At the z guard (|z| < 1e-6, the clamped depth) the derivative through the
clamp is 0, as autodiff gives it. `pair_residual_jac` is that closed form;
the tests hold it against `torch.func.jacrev` of the residual written as the
reference writes it.

The kernel is `csrc/ba_normals.cu` (one block a pair, threads over the
matches, a fixed-order tree reduction: a repeat launch is bit-identical).
CUDA tensors launch it or raise; CPU tensors take `ba_normals_plain`.

Launch counting: `launches` counts the kernel's runs on the device. A
launch recorded into a CUDA graph being captured is counted in `captured`
instead; the graph's owner (`models/bundle._PhaseGraph`) adds the launches
it recorded to `launches` at each replay, when they run.
"""

from __future__ import annotations

import ctypes

import torch

from autopanostitch_tpu_torch.kernels import _build

launches = 0  # ba_normals kernel runs: eager launches plus those replayed by CUDA graphs
captured = 0  # launches recorded into CUDA graphs while they were captured


def huber_w(r2, sigma: float):
    """IRLS weight of a squared residual norm under Huber."""
    return torch.clamp(sigma / torch.sqrt(r2 + 1e-12), max=1.0)


def _direction(Rs, Rd, f_s, f_d, k1_s, k1_d, cx_s, cy_s, cx_d, cy_d, u_s, u_d, pd: int):
    """One direction s -> d of the residual, r = obs_d - pred_d, with its
    Jacobian in closed form. Inputs broadcast over leading dims (R (..., 3,
    3), scalars (...), points (..., 2)). Returns r (..., 2), J_s (..., 2,
    pd), J_d (..., 2, pd), z (...)."""
    us, vs = u_s[..., 0], u_s[..., 1]
    ud, vd = u_d[..., 0], u_d[..., 1]
    if pd == 5:  # observations move into pinhole space first
        dxs, dys = us - cx_s, vs - cy_s
        r2s = (dxs * dxs + dys * dys) / (cx_s * cx_s + cy_s * cy_s + 1e-12)
        fac = 1.0 + k1_s * r2s
        us, vs = cx_s + dxs * fac, cy_s + dys * fac
        dxd, dyd = ud - cx_d, vd - cy_d
        r2d = (dxd * dxd + dyd * dyd) / (cx_d * cx_d + cy_d * cy_d + 1e-12)
        fac = 1.0 + k1_d * r2d
        ud, vd = cx_d + dxd * fac, cy_d + dyd * fac
    x = (us - cx_s) / f_s
    y = (vs - cy_s) / f_s
    ray = torch.stack([x, y, torch.ones_like(x)], -1)
    p = (Rd @ (Rs.transpose(-1, -2) @ ray[..., None]))[..., 0]
    p0, p1, z = p.unbind(-1)
    small = z.abs() < 1e-6
    zs = torch.where(small, torch.where(z < 0, -1e-6, 1e-6), z)
    r = torch.stack([ud - (f_d * p0 / zs + cx_d), vd - (f_d * p1 / zs + cy_d)], -1)
    # A = d pred / d p = [[a, 0, c0], [0, a, c1]] (c = 0 where z is clamped)
    a = f_d / zs
    c0 = torch.where(small, 0.0, -a * p0 / zs)
    c1 = torch.where(small, 0.0, -a * p1 / zs)
    # G = A Rd Rs^T: d r / d ray_s (the sign of -A and of the transposed
    # rotation's derivative cancel)
    G = []
    for c in (c0, c1):
        row = len(G)
        AR = a[..., None] * Rd[..., row, :] + c[..., None] * Rd[..., 2, :]
        G.append((Rs @ AR[..., None])[..., 0])
    Js, Jd = [], []
    for row, (g, c) in enumerate(zip(G, (c0, c1))):
        g0, g1, g2 = g.unbind(-1)
        cols = [-g1 + g2 * y, g0 - g2 * x, -g0 * y + g1 * x, (g0 * x + g1 * y) / f_s]
        if pd == 5:
            cols.append(-(g0 * dxs + g1 * dys) * r2s / f_s)
        Js.append(torch.stack(cols, -1))
        # -A (e_k x p), k = 0, 1, 2; then d r / d f_d, d r / d k1_d
        if row == 0:
            cols = [-c * p1, -a * z + c * p0, a * p1, -p0 / zs]
        else:
            cols = [a * z - c * p1, c * p0, -a * p0, -p1 / zs]
        if pd == 5:
            cols.append((dxd if row == 0 else dyd) * r2d)
        Jd.append(torch.stack(cols, -1))
    return r, torch.stack(Js, -2), torch.stack(Jd, -2), z


def pair_residual_jac(Rb_i, Rb_j, f_i, f_j, k1_i, k1_j, cx_i, cy_i, cx_j, cy_j, u_i, u_j,
                      pd: int):
    """Bidirectional residual of matches and its Jacobian in closed form,
    linearized at theta = 0 around the base rotations (broadcasting over
    leading dims). Returns r (..., 4) = [r_ij, r_ji], J (..., 4, 2pd)
    against [params_i, params_j], z (..., 2) = [z_j, z_i]."""
    r_ij, Ji_a, Jj_a, z_j = _direction(Rb_i, Rb_j, f_i, f_j, k1_i, k1_j, cx_i, cy_i, cx_j, cy_j,
                                       u_i, u_j, pd)
    r_ji, Jj_b, Ji_b, z_i = _direction(Rb_j, Rb_i, f_j, f_i, k1_j, k1_i, cx_j, cy_j, cx_i, cy_i,
                                       u_j, u_i, pd)
    J = torch.cat([torch.cat([Ji_a, Jj_a], -1), torch.cat([Ji_b, Jj_b], -1)], -2)
    return torch.cat([r_ij, r_ji], -1), J, torch.stack([z_j, z_i], -1)


def _check(Rb, f, k1, cx, cy, u_i, u_j, w, pij, pd: int):
    nb = Rb.shape[0]
    pb, M = w.shape
    if pd not in (4, 5):
        raise ValueError(f"ba_normals: pd must be 4 or 5, got {pd}")
    if Rb.shape != (nb, 3, 3) or any(t.shape != (nb,) for t in (f, k1, cx, cy)):
        raise ValueError("ba_normals: Rb must be (nb, 3, 3) and f, k1, cx, cy (nb,)")
    if u_i.shape != (pb, M, 2) or u_j.shape != (pb, M, 2) or pij.shape != (pb, 2):
        raise ValueError("ba_normals: u_i, u_j must be (pb, M, 2), w (pb, M), pij (pb, 2)")
    for t in (Rb, f, k1, cx, cy, u_i, u_j, w):
        if t.dtype != w.dtype or t.device != w.device:
            raise ValueError("ba_normals: float inputs must share one dtype and device")
    if w.dtype != torch.float32 and not (w.dtype == torch.float64 and w.device.type == "cpu"):
        raise ValueError("ba_normals: float inputs must be float32 (or float64 on the CPU)")
    if pij.dtype != torch.int64 or pij.device != w.device:
        raise ValueError("ba_normals: pij must be int64 on the inputs' device")


def ba_normals_plain(Rb, f, k1, cx, cy, u_i, u_j, w, pij, pd: int, sigma: float,
                     one_direction: bool):
    """Plain PyTorch version. Rb (nb, 3, 3), f/k1/cx/cy (nb,) of the
    phase's cameras; u_i/u_j (pb, M, 2), w (pb, M) (0 for padding) and the
    compact camera indices pij (pb, 2) of its pairs. Returns JtJ (pb, 2pd,
    2pd), Jtg (pb, 2pd), cost (pb,)."""
    ii, jj = pij[:, 0], pij[:, 1]

    def cam(t, idx):
        return t[idx][:, None]

    r, J, z = pair_residual_jac(
        cam(Rb, ii), cam(Rb, jj), cam(f, ii), cam(f, jj), cam(k1, ii), cam(k1, jj),
        cam(cx, ii), cam(cy, ii), cam(cx, jj), cam(cy, jj), u_i, u_j, pd)
    w_ij = huber_w((r[..., :2] ** 2).sum(-1), sigma)
    w_ji = huber_w((r[..., 2:] ** 2).sum(-1), sigma)
    if one_direction:
        w_ji = torch.zeros_like(w_ji)
    front = (z[..., 0] > 1e-4) & (z[..., 1] > 1e-4)
    w4 = torch.stack([w_ij, w_ij, w_ji, w_ji], -1) * (w * front)[..., None]
    Jw = J * w4[..., None]
    JtJ = torch.einsum("pmab,pmac->pbc", Jw, J)
    Jtg = torch.einsum("pmab,pma->pb", Jw, r)
    return JtJ, Jtg, (w4 * r * r).sum((1, 2))


def ba_normals(Rb, f, k1, cx, cy, u_i, u_j, w, pij, pd: int, sigma: float,
               one_direction: bool):
    """Per-pair normal equations of one LM phase (see `ba_normals_plain`).
    CUDA tensors (float32) launch `csrc/ba_normals.cu`, CPU tensors
    (float32 or float64) take the plain version. pij must index cameras < nb (not checked on the card: that
    would need a host sync)."""
    global launches, captured
    _check(Rb, f, k1, cx, cy, u_i, u_j, w, pij, pd)
    if w.device.type == "cpu":
        return ba_normals_plain(Rb, f, k1, cx, cy, u_i, u_j, w, pij, pd, sigma, one_direction)
    if w.device.type != "cuda":
        raise ValueError(f"ba_normals: unsupported device {w.device}")
    ins = [t.contiguous() for t in (Rb, f, k1, cx, cy, u_i, u_j, w, pij)]
    pb, M = w.shape
    JtJ = torch.empty((pb, 2 * pd, 2 * pd), dtype=torch.float32, device=w.device)
    Jtg = torch.empty((pb, 2 * pd), dtype=torch.float32, device=w.device)
    cost = torch.empty((pb,), dtype=torch.float32, device=w.device)
    if pb == 0:
        return JtJ, Jtg, cost
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _build.library().apst_ba_normals(
        *(t.data_ptr() for t in ins), pb, M, pd, ctypes.c_float(sigma), int(one_direction),
        JtJ.data_ptr(), Jtg.data_ptr(), cost.data_ptr(), stream)
    _build.check(err, "apst_ba_normals")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return JtJ, Jtg, cost
