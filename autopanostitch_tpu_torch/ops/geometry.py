"""Projective / rotation geometry on tensors (port of `ops/geometry.py`).

Conventions as in the reference: 0-based pixel centres, homographies act
on column vectors (x' ~ H [x, y, 1]^T), float32. Every function takes
leading batch dimensions (the reference's `vmap` written out).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def to_homogeneous(pts):
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def from_homogeneous(pts, eps: float = 1e-8):
    w = pts[..., 2:3]
    w_safe = torch.where(w.abs() < eps, torch.where(w < 0, -eps, eps), w)
    return pts[..., :2] / w_safe


def homography_apply(H, pts):
    """Apply (..., 3, 3) homographies to (..., M, 2) points."""
    ph = to_homogeneous(pts)
    return from_homogeneous(ph @ H.transpose(-1, -2))


def inv3x3(H):
    """Closed-form adjugate 3x3 inverse, batched."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det_safe = torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det_safe[..., None, None]


def _normalize_h33(H):
    d = H[..., 2, 2]
    scale = torch.where(d.abs() > 1e-10, d, torch.ones_like(d))
    return H / scale[..., None, None]


def homography_inverse(H):
    """Guarded 3x3 inverse, normalized so H[2, 2] == 1 when possible."""
    return _normalize_h33(inv3x3(H))


def hartley_normalize(pts, w):
    """Weighted Hartley normalization of (..., M, 2) points with (..., M)
    weights. Returns (normalized (..., M, 2), T (..., 3, 3))."""
    wsum = torch.clamp(w.sum(-1), min=_EPS)
    mean = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
    mean_d = (d * w).sum(-1) / wsum
    scale = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-8)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 0, 2] = -scale * mean[..., 0]
    T[..., 1, 2] = -scale * mean[..., 1]
    T[..., 2, 2] = 1.0
    normalized = (pts - mean[..., None, :]) * scale[..., None, None]
    return normalized, T


def fit_homography_dlt(src, dst, w):
    """Weighted normalized-DLT homography (src -> dst), smallest eigenvector
    of A^T A. src/dst (..., M, 2), w (..., M). Returns (..., 3, 3)."""
    sn, Ts = hartley_normalize(src, w)
    dn, Td = hartley_normalize(dst, w)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    sw = torch.sqrt(torch.clamp(w, min=0.0))[..., None]
    A = torch.cat([r1 * sw, r2 * sw], dim=-2)  # (..., 2M, 9)
    AtA = A.transpose(-1, -2) @ A
    _, evecs = torch.linalg.eigh(AtA)
    Hn = evecs[..., :, 0].reshape(evecs.shape[:-2] + (3, 3))
    H = torch.linalg.solve_ex(Td, Hn @ Ts)[0]
    return _normalize_h33(H)


def chol_solve_small(A, b):
    """Solve SPD A x = b for small static n by an UNROLLED Cholesky with a
    clamped pivot (reference `chol_solve_small`: the clamp keeps
    near-degenerate RANSAC minimal sets finite). A (..., n, n), b (..., n)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        s = A[..., i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        Lii = torch.sqrt(torch.clamp(s, min=1e-20))
        L[i][i] = Lii
        for j in range(i + 1, n):
            t = A[..., j, i]
            for k in range(i):
                t = t - L[j][k] * L[i][k]
            L[j][i] = t / Lii
    y = [None] * n
    for i in range(n):
        t = b[..., i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t / L[i][i]
    return torch.stack(x, dim=-1)


def fit_homography_4pt(src, dst, w=None):
    """Minimal-case homography (h33 = 1, Hartley-normalized 8x8 normal
    equations through `chol_solve_small`). src/dst (..., 4, 2)."""
    ones = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    sn, Ts = hartley_normalize(src, ones)
    dn, Td = hartley_normalize(dst, ones)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)  # (..., 8)
    At = A.transpose(-1, -2)
    AtA = At @ A + 1e-8 * torch.eye(8, dtype=src.dtype, device=src.device)
    Atb = (At @ b[..., None])[..., 0]
    h = chol_solve_small(AtA, Atb)
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(h.shape[:-1] + (3, 3))
    H = inv3x3(Td) @ (Hn @ Ts)
    return _normalize_h33(H)


def _weighted_means(src, dst, w):
    wsum = torch.clamp(w.sum(-1), min=_EPS)[..., None]
    return (src * w[..., None]).sum(-2) / wsum, (dst * w[..., None]).sum(-2) / wsum


def _affine_h(A, t):
    """(..., 2, 2) linear part and (..., 2) translation -> (..., 3, 3)."""
    H = torch.zeros(A.shape[:-2] + (3, 3), dtype=A.dtype, device=A.device)
    H[..., :2, :2] = A
    H[..., :2, 2] = t
    H[..., 2, 2] = 1.0
    return H


def _with_translation(A, ms, md):
    return _affine_h(A, md - (A @ ms[..., None])[..., 0])


def _fms(a, b, c):
    """c - a b rounded once (a fused multiply-add): exact in float64."""
    return (c.double() - a.double() * b.double()).to(c.dtype)


def solve2x2(A, B):
    """X with A X = B for (..., 2, 2) A and B: LU with partial pivoting in
    the rounding order of the reference's `jnp.linalg.solve` on a 2x2
    system (reciprocal pivots, fused substitution steps), so the two agree
    bit for bit even on ill-conditioned minimal sets. A singular A gives
    inf / nan, as there, and raises nothing."""
    swap = (A[..., 1, 0].abs() > A[..., 0, 0].abs())[..., None, None]
    A = torch.where(swap, A.flip(-2), A)
    B = torch.where(swap, B.flip(-2), B)
    a00, a01, a10, a11 = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
    r00 = 1.0 / a00
    l = a10 * r00
    u11 = a11 - l * a01
    y0 = B[..., 0, :]
    x1 = _fms(l[..., None], y0, B[..., 1, :]) * (1.0 / u11)[..., None]
    x0 = _fms(a01[..., None], x1, y0) * r00[..., None]
    return torch.stack([x0, x1], -2)


def _cross(a, b):
    """a^T b over the points: (..., M, 2) x (..., M, 2) -> (..., 2, 2).
    Minimal sets (M <= 4) accumulate point by point, one rounding a step,
    which is how the reference's dot rounds them: their fits are often
    ill-conditioned, and so agree bit for bit. Larger sets take a matmul."""
    if a.shape[-2] > 4:
        return a.transpose(-1, -2) @ b
    acc = torch.zeros(a.shape[:-2] + (2, 2), dtype=a.dtype, device=a.device)
    for k in range(a.shape[-2]):
        acc = (acc.double() + a[..., k, :, None].double() * b[..., k, None, :].double()).to(a.dtype)
    return acc


def fit_affine(src, dst, w):
    """Weighted least-squares affine fit src -> dst: A = (dc^T W sc)
    (sc^T W sc + 1e-8 I)^-1 by a 2x2 solve, as the reference. src/dst
    (..., M, 2), w (..., M). Returns (..., 3, 3) with last row [0 0 1]."""
    ms, md = _weighted_means(src, dst, w)
    s0 = src - ms[..., None, :]
    sc = s0 * w[..., None]
    Sxx = _cross(sc, s0)
    Sxy = _cross(sc, dst - md[..., None, :])
    Sxx = Sxx + 1e-8 * torch.eye(2, dtype=src.dtype, device=src.device)
    A = solve2x2(Sxx, Sxy).transpose(-1, -2)
    return _with_translation(A, ms, md)


def _rotation_terms(src, dst, w):
    """(a, b, ms, md, sc) of the weighted cross-covariance C = (W dc)^T sc:
    a = C00 + C11, b = C10 - C01."""
    ms, md = _weighted_means(src, dst, w)
    sc = src - ms[..., None, :]
    dc = dst - md[..., None, :]
    C = _cross(dc * w[..., None], sc)
    return C[..., 0, 0] + C[..., 1, 1], C[..., 1, 0] - C[..., 0, 1], ms, md, sc


def _rot_scale(ca, sb):
    return torch.stack([torch.stack([ca, -sb], -1), torch.stack([sb, ca], -1)], -2)


def fit_similarity(src, dst, w):
    """Weighted similarity (Procrustes) fit in closed form."""
    a, b, ms, md, sc = _rotation_terms(src, dst, w)
    denom = torch.clamp((w[..., None] * sc * sc).sum((-2, -1)), min=_EPS)
    return _with_translation(_rot_scale(a / denom, b / denom), ms, md)


def fit_rigid(src, dst, w):
    """Weighted rigid (rotation + translation) fit in closed form."""
    a, b, ms, md, _ = _rotation_terms(src, dst, w)
    n = torch.sqrt(torch.clamp(a * a + b * b, min=_EPS))
    return _with_translation(_rot_scale(a / n, b / n), ms, md)


def _weighted_median(vals, w):
    """Smallest value whose cumulative weight reaches half the total, along
    the last dim (zero weights ignored): a stable sort and a left-side
    search, as the reference's argsort + searchsorted."""
    v, order = torch.sort(vals, dim=-1, stable=True)
    c = torch.cumsum(torch.gather(w, -1, order), -1)
    idx = torch.searchsorted(c, 0.5 * c[..., -1:], side="left")
    return torch.gather(v, -1, idx.clamp(0, vals.shape[-1] - 1))[..., 0]


def fit_translation(src, dst, w):
    """Weighted-median translation fit, per axis."""
    d = dst - src
    t = torch.stack([_weighted_median(d[..., 0], w), _weighted_median(d[..., 1], w)], -1)
    eye = torch.eye(2, dtype=src.dtype, device=src.device).expand(t.shape[:-1] + (2, 2))
    return _affine_h(eye, t)


def transfer_error(H, src, dst):
    """|H(src) - dst| per point: H (..., 3, 3), src/dst (..., M, 2) -> (..., M)."""
    pred = homography_apply(H, src)
    return torch.sqrt(((pred - dst) ** 2).sum(-1))


def symmetric_transfer_error(H, src, dst):
    """0.5 * (|H src - dst| + |H^-1 dst - src|) per point."""
    Hi = homography_inverse(H)
    return 0.5 * (transfer_error(H, src, dst) + transfer_error(Hi, dst, src))


def homography_is_valid(H):
    """Finite, non-degenerate, condition number bounded by
    ||H||_F ||adj H||_F / |det| < 3e7 (SVD-free, as the reference)."""
    finite = torch.isfinite(H).all(-1).all(-1)
    det2 = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    det3 = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    adj_fro2 = (
        (e * i - f * h) ** 2 + (b * i - c * h) ** 2 + (b * f - c * e) ** 2
        + (d * i - f * g) ** 2 + (a * i - c * g) ** 2 + (a * f - c * d) ** 2
        + (d * h - e * g) ** 2 + (a * h - b * g) ** 2 + (a * e - b * d) ** 2
    )
    fro2 = (H * H).sum(-1).sum(-1)
    cond_bound = torch.sqrt(fro2 * adj_fro2) / torch.clamp(det3.abs(), min=_EPS)
    return finite & (det2.abs() > 1e-9) & (det3.abs() > 1e-12) & (cond_bound < 3e7)


def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w):
    """Rodrigues exponential map (..., 3) -> (..., 3, 3), stable near 0."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R):
    """Logarithm map (..., 3, 3) -> (..., 3), stable over [0, pi] (near pi
    the axis comes from the symmetric part, as in the reference)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    scale = torch.where(
        sin_t.abs() < 1e-6, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t + _EPS)
    )
    w_std = v * scale[..., None]

    one_m_c = torch.clamp(1.0 - cos_t, min=1e-12)[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    a = torch.sqrt(torch.clamp((diag - cos_t[..., None]) / one_m_c, min=0.0))
    S = 0.5 * (R + R.transpose(-1, -2))
    k = torch.argmax(a, dim=-1)
    Sk = torch.gather(S, -1, k[..., None, None].expand(S.shape[:-1] + (1,)))[..., 0]
    sign_i = torch.where(Sk >= 0.0, 1.0, -1.0)
    onehot_k = torch.arange(3, device=R.device) == k[..., None]
    sign_i = torch.where(onehot_k, torch.ones_like(sign_i), sign_i)
    a = a * sign_i
    flip = (a * v).sum(-1) < 0.0
    a = torch.where(flip[..., None], -a, a)
    w_pi = a * theta[..., None]
    near_pi = (cos_t < -0.99)[..., None]
    return torch.where(near_pi, w_pi, w_std)


def project_to_so3(M):
    """Nearest rotation by SVD with det correction."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    S = torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape).clone()
    S[..., 2, 2] = d
    return U @ S @ Vt


def build_K(f, cx, cy):
    """K = [[f, 0, cx], [0, f, cy], [0, 0, 1]], broadcast over leading dims."""
    f, cx, cy = torch.broadcast_tensors(
        torch.as_tensor(f, dtype=torch.float32),
        torch.as_tensor(cx, dtype=torch.float32),
        torch.as_tensor(cy, dtype=torch.float32),
    )
    zero = torch.zeros_like(f)
    one = torch.ones_like(f)
    return torch.stack(
        [
            torch.stack([f, zero, cx], dim=-1),
            torch.stack([zero, f, cy], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def invert_K(K):
    """Closed-form inverse of an fx = fy pinhole K (broadcasts)."""
    f = K[..., 0, 0]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    inv_f = 1.0 / f
    zero = torch.zeros_like(f)
    one = torch.ones_like(f)
    return torch.stack(
        [
            torch.stack([inv_f, zero, -cx * inv_f], dim=-1),
            torch.stack([zero, inv_f, -cy * inv_f], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
