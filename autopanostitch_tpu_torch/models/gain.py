"""Gain compensation, rotational and planar paths (port of `models/gain.py`).

Overlap statistics are sampled on each image's own strided pixel grid, as
the reference does: grid colours by a strided slice, each grid point's
world ray projected into every camera, a bounds test for visibility. The
(N, N) counts and colour sums accumulate in ONE pass over grid chunks (the
reference's camera-block host loop worked around a TPU runtime fault and is
not carried over). The planar path maps a strided canvas grid into every
image through its inverse homography instead. The tiny per-channel solve is
host numpy, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from autopanostitch_tpu_torch.config import GainConfig
from autopanostitch_tpu_torch.ops import geometry as geo
from autopanostitch_tpu_torch.ops import projections as proj
from autopanostitch_tpu_torch.ops import sampling as samp
from autopanostitch_tpu_torch.utils import trace


def overlap_statistics_imagespace(images, feathers, sizes, R, K, stride: int,
                                  margin: float = 1.0, k1=None, max_elems: int = 1 << 25,
                                  points: slice | None = None):
    """(Nij (N, N), sumC (N, N, 3)) tensors; Nij counts on image i's grid.

    images (N, H, W, 3), feathers (N, H, W), sizes (N, 2) int, R/K
    (N, 3, 3), k1 (N,) or None, all tensors on one device. Grid points run
    in chunks of max_elems / N^2 to bound the (N, N, chunk) projection.
    `points` restricts the sums to a range of the strided grid's points
    (row-major), as the sharded statistics split them over ranks."""
    N, H, W, _ = images.shape
    dev = images.device
    col_all = images[:, ::stride, ::stride].reshape(N, -1, 3) * 255.0
    wf_own = feathers[:, ::stride, ::stride].reshape(N, -1)
    ys = torch.arange(0, H, stride, device=dev, dtype=torch.float32)
    xs = torch.arange(0, W, stride, device=dev, dtype=torch.float32)
    ys, xs = torch.meshgrid(ys, xs, indexing="ij")
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    h_v = sizes[:, 0].float()[:, None]
    w_v = sizes[:, 1].float()[:, None]
    own = (
        (xs[None] >= margin) & (xs[None] <= w_v - 1 - margin)
        & (ys[None] >= margin) & (ys[None] <= h_v - 1 - margin)
        & (wf_own > 1e-4)
    )  # (N, P)
    if points is not None:
        xs, ys, own, col_all = xs[points], ys[points], own[:, points], col_all[:, points]
    Rt_Kinv = R.transpose(1, 2) @ geo.invert_K(K)
    if k1 is None:
        pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)  # (P, 3)
        rays = torch.einsum("iab,pb->ipa", Rt_Kinv, pix)
    else:
        cxs = K[:, 0, 2][:, None]
        cys = K[:, 1, 2][:, None]
        xu, yu = proj.undistort_pixels(xs[None], ys[None], k1[:, None], cxs, cys)
        pix = torch.stack([xu, yu, torch.ones_like(xu)], -1)  # (N, P, 3)
        rays = torch.einsum("iab,ipb->ipa", Rt_Kinv, pix)
    KR = K @ R

    P = xs.shape[0]
    chunk = max(1, max_elems // (N * N))
    trace.count("gain.chunks", -(-P // chunk))
    Nij = torch.zeros((N, N), device=dev)
    sumC = torch.zeros((N, N, 3), device=dev)
    for s in range(0, P, chunk):
        r_c = rays[:, s : s + chunk]
        prj = torch.einsum("jab,icb->ijca", KR, r_c)  # (i, j, c, 3)
        z = prj[..., 2]
        zi = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
        u = prj[..., 0] / zi
        v = prj[..., 1] / zi
        if k1 is not None:
            u, v = proj.distort_pixels(u, v, k1[None, :, None],
                                       K[:, 0, 2][None, :, None], K[:, 1, 2][None, :, None])
        vis = (
            (z > 1e-6)
            & (u >= margin) & (u <= w_v[None] - 1 - margin)
            & (v >= margin) & (v <= h_v[None] - 1 - margin)
        )
        V = (own[:, None, s : s + chunk] & vis).float()
        Nij += V.sum(-1)
        sumC += torch.einsum("ijp,ipc->ijc", V, col_all[:, s : s + chunk])
    return Nij, sumC


def overlap_statistics_planar(images, feathers, H_inv, x0: float, y0: float, stride: int,
                              grid_h: int, grid_w: int, chunk: int = 16384):
    """Planar-path overlap statistics (reference `gainCompensationH.m`):
    the canvas subgrid (stride px, world origin (x0, y0)) maps into each
    image through H_inv (N, 3, 3); a grid point counts for image i where it
    lands inside i with feather weight > 1e-4 and a positive denominator.
    Returns (Nij (N, N), sumC (N, N, 3)) tensors, colours on the 0-255
    scale of the Brown-Lowe sigmas."""
    N = images.shape[0]
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(grid_h, device=dev), torch.arange(grid_w, device=dev),
                            indexing="ij")
    xp = (xs * stride).float().reshape(-1) + x0
    yp = (ys * stride).float().reshape(-1) + y0
    idx = torch.arange(N, device=dev)
    Hi = H_inv[:, None]  # (N, 1, 3, 3)
    Nij = torch.zeros((N, N), device=dev)
    sumC = torch.zeros((N, N, 3), device=dev)
    for s in range(0, xp.shape[0], chunk):
        xx, yy = xp[None, s : s + chunk], yp[None, s : s + chunk]
        den = Hi[..., 2, 0] * xx + Hi[..., 2, 1] * yy + Hi[..., 2, 2]
        den = torch.where(den.abs() < 1e-10, torch.full_like(den, 1e-10), den)
        u = (Hi[..., 0, 0] * xx + Hi[..., 0, 1] * yy + Hi[..., 0, 2]) / den
        v = (Hi[..., 1, 0] * xx + Hi[..., 1, 1] * yy + Hi[..., 1, 2]) / den
        col, ok = samp.sample_bilinear_indexed(images, idx, u, v)
        wf, _ = samp.sample_bilinear_indexed(feathers[..., None], idx, u, v)
        V = (ok & (wf[..., 0] > 1e-4) & (den > 0)).float()
        col = col * 255.0
        Nij += V @ V.mT
        for c in range(3):
            sumC[:, :, c] += (V * col[..., c]) @ V.mT
    return Nij, sumC


def compute_gains_planar(images, feathers, H_inv, x0: float, y0: float, canvas_hw,
                         cfg: GainConfig = GainConfig()) -> np.ndarray:
    """Planar-path gains (N, 3) (reference `gainCompensationH.m`): device
    statistics on the canvas grid + host solve. H_inv (N, 3, 3) numpy maps
    canvas world coordinates to source pixels."""
    n = images.shape[0]
    if not cfg.enabled:
        return np.ones((n, 3), np.float32)
    Hc, Wc = canvas_hw
    stride = cfg.grid_stride
    gh = max(1, int(np.ceil(Hc / stride)))
    gw = max(1, int(np.ceil(Wc / stride)))
    Nij, sumC = overlap_statistics_planar(
        images, feathers, torch.as_tensor(np.asarray(H_inv, np.float32), device=images.device),
        x0, y0, stride, gh, gw)
    return solve_gains(Nij.cpu().numpy(), sumC.cpu().numpy(), cfg)


def solve_gains(Nij: np.ndarray, sumC: np.ndarray, cfg: GainConfig = GainConfig(),
                min_overlap: int = 50, lambda_diag: float = 1e-8) -> np.ndarray:
    """Per-channel (N, N) gain solve (Brown-Lowe Eq. 29), clamped."""
    N = Nij.shape[0]
    gains = np.ones((N, 3), np.float32)
    sN2 = cfg.sigma_n**2
    sg2 = cfg.sigma_g**2
    iu, ju = np.triu_indices(N, 1)
    ok = np.minimum(Nij[iu, ju], Nij[ju, iu]) >= min_overlap
    if not ok.any():
        return gains
    ii, jj = iu[ok], ju[ok]
    Kij = 0.5 * (Nij[ii, jj] + Nij[jj, ii])
    Ibar_ij = sumC[ii, jj] / Nij[ii, jj, None]
    Ibar_ji = sumC[jj, ii] / Nij[jj, ii, None]
    wN = Kij / sN2
    wG = Kij / sg2
    A = np.zeros((N, N, 3))
    b = np.zeros((N,))
    np.add.at(A, (ii, ii), wN[:, None] * Ibar_ij**2 + wG[:, None])
    np.add.at(A, (jj, jj), wN[:, None] * Ibar_ji**2 + wG[:, None])
    cross = -wN[:, None] * Ibar_ij * Ibar_ji
    np.add.at(A, (ii, jj), cross)
    np.add.at(A, (jj, ii), cross)
    np.add.at(b, ii, wG)
    np.add.at(b, jj, wG)
    for c in range(3):
        x = np.linalg.solve(A[:, :, c] + lambda_diag * np.eye(N), b)
        gains[:, c] = np.clip(x, cfg.clamp[0], cfg.clamp[1])
    return gains


def compute_gains_rotational(images, feathers, R, K, sizes, cfg: GainConfig = GainConfig(),
                             k1=None) -> np.ndarray:
    """Rotational-path gains (N, 3): device statistics + host solve. R, K,
    k1 may be numpy or tensors; they move to the images' device."""
    n = images.shape[0]
    if not cfg.enabled:
        return np.ones((n, 3), np.float32)
    dev = images.device

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=dtype, device=dev)

    Nij, sumC = overlap_statistics_imagespace(
        images, feathers, t(sizes, torch.int32), t(R), t(K), int(cfg.grid_stride),
        k1=None if k1 is None else t(k1),
    )
    return solve_gains(Nij.cpu().numpy(), sumC.cpu().numpy(), cfg)
