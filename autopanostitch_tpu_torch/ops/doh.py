"""Determinant-of-Hessian blob detector, the 'SURF' detector option (port of
`ops/doh.py`), batched over images.

DoH(x, sigma) = sigma^4 (L_xx L_yy - L_xy^2) over an 8-level geometric
Gaussian scale ladder, 3x3x3 scale-space non-maximum suppression, top-k
selection, and SIFT descriptors at the detected scale. `extract_from_levels`
is shared with KAZE (`ops/kaze.py`), whose levels come from nonlinear
diffusion instead.

The per-keypoint window phase is kernel B2 (`kernels/sift_window.py`): one
`orient_hist` and one `descriptor` launch for all keypoints of an image
group, on the flattened (G * 8, H, W, 2) magnitude/angle stack of its
full-resolution levels, with 80 px windows. `extract_from_levels` records
the spans `doh.detect` and `doh.window` (`utils/trace.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.kernels.sift_window import descriptor, orient_hist, smooth_hist
from autopanostitch_tpu_torch.ops import sift
from autopanostitch_tpu_torch.ops.sift import SiftFeatures, gaussian_blur, top_k_stable
from autopanostitch_tpu_torch.utils import trace

_N_SCALES = 8


def hessian_response(L, sigma: float):
    """Scale-normalised det-Hessian of (already smoothed) levels (..., H, W),
    from central (wrap-around) differences."""
    Lxx = torch.roll(L, -1, -1) + torch.roll(L, 1, -1) - 2 * L
    Lyy = torch.roll(L, -1, -2) + torch.roll(L, 1, -2) - 2 * L
    Lx = sift._grad_maps(L)[0]
    Lxy = sift._grad_maps(Lx)[1]
    return (sigma ** 4) * (Lxx * Lyy - Lxy * Lxy)


def doh_sigmas(cfg: DetectorConfig, n_scales: int = _N_SCALES) -> list:
    k = 2.0 ** 0.5
    return [cfg.sigma * (k ** i) for i in range(n_scales)]


def detect_levels(Ls, sigmas, K: int, resp_fn=None, border: int = 8):
    """The K strongest 3x3x3 maxima of the responses of a (G, S, H, W)
    stack of scale-space levels: (values, level index, y, x), each (G, K);
    a value <= 0 marks an empty slot. resp_fn(levels, sigma) gives a
    level's response (default `hessian_response`)."""
    if resp_fn is None:
        resp_fn = hessian_response
    G, S, H, W = Ls.shape
    resp = torch.stack([resp_fn(Ls[:, i], s) for i, s in enumerate(sigmas)], 1)

    # 3x3x3 non-maximum suppression over (scale, y, x), interior scales;
    # max_pool3d pads with -inf, as the reference's reduce_window
    center = resp[:, 1:-1]
    mx = F.max_pool3d(resp[:, None], 3, stride=1, padding=1)[:, 0, 1:-1]
    is_max = (center >= mx) & (center > 1e-6)
    b = border
    is_max[..., :b, :] = False
    is_max[..., -b:, :] = False
    is_max[..., :b] = False
    is_max[..., -b:] = False

    score = torch.where(is_max, center, torch.full_like(center, -1.0)).reshape(G, -1)
    vals, flat = top_k_stable(score, K)
    si = flat // (H * W) + 1  # back to the level index
    rem = flat % (H * W)
    return vals, si, rem // W, rem % W


def extract_from_levels(Ls, sigmas, cfg: DetectorConfig, resp_fn=None,
                        border: int = 8) -> SiftFeatures:
    """Detection and description on a (G, S, H, W) stack of scale-space
    levels (Gaussian for SURF, nonlinear for KAZE): `detect_levels` in the
    span `doh.detect`, the window phase (B2) in `doh.window`."""
    G, S, H, W = Ls.shape
    dev = Ls.device
    K = cfg.max_keypoints
    with trace.span("doh.detect"):
        vals, si, yi, xi = detect_levels(Ls, sigmas, K, resp_fn, border)
        valid = vals > 0
        y = yi.to(torch.float32)
        x = xi.to(torch.float32)
        sigma_kp = torch.tensor(sigmas, dtype=torch.float32, device=dev)[si]

    with trace.span("doh.window"):
        # magnitude / angle of every level's gradient, the image group
        # flattened into the levels
        dx, dy = sift._grad_maps(Ls)
        src = torch.stack([torch.sqrt(dx * dx + dy * dy), torch.atan2(dy, dx)], -1)
        src = src.reshape(G * S, H, W, 2)
        del dx, dy

        win = min(80, (min(H, W) // 8) * 8)
        cx = torch.clamp(torch.round(x).long() - win // 2, 0, max(W - win, 0))
        cy = torch.clamp(torch.round(y).long() - win // 2, 0, max(H - win, 0))
        lev = torch.arange(G, device=dev)[:, None] * S + si
        lx, ly = x - cx.to(torch.float32), y - cy.to(torch.float32)
        args = sift._flat(lev, cy, cx, lx, ly, sigma_kp)
        hist = orient_hist(src, *args, win)
        thetas, th_ok = sift._dominant_orientations(smooth_hist(hist))
        theta = thetas[:, 0].contiguous()
        desc = descriptor(src, *args, theta, win, cfg.descriptor_width, cfg.descriptor_bins)
    theta, ok0 = theta.reshape(G, K), th_ok[:, 0].reshape(G, K)
    desc = desc.reshape(G, K, -1)

    mask = valid & ok0
    mf = mask.to(torch.float32)
    return SiftFeatures(
        xy=torch.stack([x, y], -1) * mf[..., None],
        scale=torch.where(mask, sigma_kp, torch.ones_like(sigma_kp)),
        orientation=theta * mf,
        response=torch.where(mask, vals, torch.zeros_like(vals)),
        desc=desc * mf[..., None],
        mask=mask,
    )


def extract_doh(imgs, cfg: DetectorConfig = DetectorConfig()) -> SiftFeatures:
    """DoH blobs + SIFT descriptors of a (G, H, W) gray image group."""
    sigmas = doh_sigmas(cfg)
    Ls = torch.stack([gaussian_blur(imgs, s) for s in sigmas], 1)
    return extract_from_levels(Ls, sigmas, cfg)


def batched(extract, imgs, cfg: DetectorConfig, group: int = 8) -> SiftFeatures:
    """`extract` over (N, H, W) images, `group` at a time (the reference's
    image groups), concatenated."""
    N = imgs.shape[0]
    G = max(1, min(group, N))
    outs = [extract(imgs[g: g + G], cfg) for g in range(0, N, G)]
    return SiftFeatures(*[torch.cat(f) for f in zip(*outs)])


def extract_doh_batch(imgs, cfg: DetectorConfig, group: int = 8) -> SiftFeatures:
    return batched(extract_doh, imgs, cfg, group)

