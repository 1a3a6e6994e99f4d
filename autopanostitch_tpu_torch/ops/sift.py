"""SIFT detection and description on tensors (port of `ops/sift.py`).

Same pipeline and numerics as the reference: Gaussian/DoG pyramid
(separable convolutions, edge-replicate), 3x3x3 extrema with Lowe's 0.8
pre-filter, top-`cap` candidates by |DoG|, closed-form quadratic subpixel
refinement, contrast and edge tests, 36-bin orientation histogram on a
small window, oriented-candidate selection, and the 4x4x8 descriptor by
dense-window soft binning on a large window. Both window phases run in
the fused kernels of B2 (`kernels/sift_window.py`), one launch per phase
for all keypoints of an octave of an image group: they read each window
from the magnitude/angle stack into shared memory and bin it there.

Top-k selections use a STABLE descending sort: `jax.lax.top_k` keeps the
lower index on ties and torch.topk promises no order there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.kernels.sift_window import descriptor, orient_hist, smooth_hist
from autopanostitch_tpu_torch.ops.sampling import gaussian_blur

_INIT_SIGMA = 0.5
_ORI_BINS = 36
_ORI_SIGMA_FACTOR = 1.5
_ORI_RADIUS_FACTOR = 3.0
_ORI_PEAK_RATIO = 0.8
_DESC_SCALE_FACTOR = 3.0


class SiftFeatures(NamedTuple):
    """Fixed-capacity keypoints, (N, K, ...) tensors (see the reference)."""

    xy: torch.Tensor
    scale: torch.Tensor
    orientation: torch.Tensor
    response: torch.Tensor
    desc: torch.Tensor
    mask: torch.Tensor


def top_k_stable(x, k: int):
    """(values, indices) of the k largest along the last dim; ties keep the
    lower index (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Gaussian pyramid
# ---------------------------------------------------------------------------

def build_pyramid(img, cfg: DetectorConfig):
    """Gaussian + DoG pyramid of (G, H, W) images: a list over octaves of
    dicts with gauss (G, S+3, Ho, Wo) and dog (G, S+2, Ho, Wo)."""
    s = cfg.num_layers_in_octave
    sigma0 = cfg.sigma
    k = 2.0 ** (1.0 / s)
    base_extra = math.sqrt(max(sigma0**2 - _INIT_SIGMA**2, 0.01))
    base = gaussian_blur(img, base_extra)
    sig_prev = [sigma0 * (k**i) for i in range(s + 2)]
    sig_next = [sigma0 * (k ** (i + 1)) for i in range(s + 2)]
    increments = [math.sqrt(n**2 - p**2) for p, n in zip(sig_prev, sig_next)]

    octaves = []
    current = base
    for o in range(cfg.num_octaves):
        gs = [current]
        for inc in increments:
            gs.append(gaussian_blur(gs[-1], inc))
        gauss = torch.stack(gs, dim=1)
        dog = gauss[:, 1:] - gauss[:, :-1]
        octaves.append({"gauss": gauss, "dog": dog, "stride": 2**o})
        current = gs[s][:, ::2, ::2]
        if current.shape[-2] < 8 or current.shape[-1] < 8:
            break
    return octaves


# ---------------------------------------------------------------------------
# Extrema detection + candidate selection
# ---------------------------------------------------------------------------

def _extrema_mask(dog, contrast_threshold: float):
    """(G, S+2, H, W) -> (G, S, H, W) bool 26-neighbour extrema with the
    0.8 * threshold pre-filter and a 4-px border kill."""
    center = dog[:, 1:-1]
    pre = center.abs() > 0.8 * contrast_threshold
    x = dog[:, None]
    mx = F.max_pool3d(x, 3, stride=1, padding=1)[:, 0, 1:-1]
    mn = -F.max_pool3d(-x, 3, stride=1, padding=1)[:, 0, 1:-1]
    ext = ((center >= mx) | (center <= mn)) & pre
    b = 4
    ext[:, :, :b, :] = False
    ext[:, :, -b:, :] = False
    ext[:, :, :, :b] = False
    ext[:, :, :, -b:] = False
    return ext


def _select_candidates(dog, ext, cap: int):
    """Top-`cap` extrema per image by |DoG|: (si, yi, xi, valid), (G, cap)."""
    G, S, H, W = ext.shape
    resp = torch.where(ext, dog[:, 1:-1].abs(), torch.full_like(ext, -1.0, dtype=dog.dtype))
    vals, flat = top_k_stable(resp.reshape(G, -1), cap)
    valid = vals > 0
    si = flat // (H * W)
    rem = flat % (H * W)
    return si, rem // W, rem % W, valid


def _refine(dog, si, yi, xi):
    """Quadratic 3D subpixel refinement of every candidate (reference
    `_refine_one`, with its 3x3x3 patch fetched as dynamic_slice does:
    starts clamped so the patch stays inside). dog (G, S+2, H, W); si/yi/xi
    (G, C). Returns (off (G, C, 3), contrast, tr, det, converged)."""
    G, S2, H, W = dog.shape
    s0 = si.clamp(0, S2 - 3)
    y0 = (yi - 1).clamp(0, H - 3)
    x0 = (xi - 1).clamp(0, W - 3)
    g_idx = torch.arange(G, device=dog.device)[:, None]

    def d(a, b, c):
        return dog[g_idx, s0 + a, y0 + b, x0 + c]

    g0 = (d(2, 1, 1) - d(0, 1, 1)) * 0.5
    g1 = (d(1, 2, 1) - d(1, 0, 1)) * 0.5
    g2 = (d(1, 1, 2) - d(1, 1, 0)) * 0.5
    c = d(1, 1, 1)
    hss = d(2, 1, 1) + d(0, 1, 1) - 2 * c
    hyy = d(1, 2, 1) + d(1, 0, 1) - 2 * c
    hxx = d(1, 1, 2) + d(1, 1, 0) - 2 * c
    hsy = (d(2, 2, 1) - d(2, 0, 1) - d(0, 2, 1) + d(0, 0, 1)) * 0.25
    hsx = (d(2, 1, 2) - d(2, 1, 0) - d(0, 1, 2) + d(0, 1, 0)) * 0.25
    hyx = (d(1, 2, 2) - d(1, 2, 0) - d(1, 0, 2) + d(1, 0, 0)) * 0.25
    a, b_, c_ = hss + 1e-8, hsy, hsx
    d_, e_, f_ = hsy, hyy + 1e-8, hyx
    g_, h_, i_ = hsx, hyx, hxx + 1e-8
    det = a * (e_ * i_ - f_ * h_) - b_ * (d_ * i_ - f_ * g_) + c_ * (d_ * h_ - e_ * g_)
    det = torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    b0, b1, b2 = -g0, -g1, -g2
    off = torch.stack(
        [
            b0 * (e_ * i_ - f_ * h_) - b_ * (b1 * i_ - f_ * b2) + c_ * (b1 * h_ - e_ * b2),
            a * (b1 * i_ - f_ * b2) - b0 * (d_ * i_ - f_ * g_) + c_ * (d_ * b2 - b1 * g_),
            a * (e_ * b2 - b1 * h_) - b_ * (d_ * b2 - b1 * g_) + b0 * (d_ * h_ - e_ * g_),
        ],
        dim=-1,
    ) / det[..., None]
    converged = (off.abs() < 0.6).all(-1) & torch.isfinite(off).all(-1)
    contrast = c + 0.5 * (g0 * off[..., 0] + g1 * off[..., 1] + g2 * off[..., 2])
    tr = hxx + hyy
    det2 = hxx * hyy - hyx * hyx
    return off, contrast, tr, det2, converged


def _detect_octave(dog, cfg: DetectorConfig, cap: int):
    """Detection for one octave: (x_sub, y_sub, layer, |contrast|, valid)."""
    ext = _extrema_mask(dog, cfg.contrast_threshold)
    si, yi, xi, valid = _select_candidates(dog, ext, cap)
    off, contrast, tr, det, converged = _refine(dog, si, yi, xi)
    r = cfg.edge_threshold
    edge_ok = (det > 0) & (tr * tr / torch.clamp(det, min=1e-12) < (r + 1.0) ** 2 / r)
    contrast_ok = contrast.abs() >= cfg.contrast_threshold
    valid = valid & converged & edge_ok & contrast_ok
    x_sub = xi.float() + off[..., 2]
    y_sub = yi.float() + off[..., 1]
    layer = (si + 1).float() + off[..., 0]
    return x_sub, y_sub, layer, contrast.abs(), valid


# ---------------------------------------------------------------------------
# Orientation & descriptor
# ---------------------------------------------------------------------------

def _grad_maps(gauss):
    """Central differences with wrap-around (as jnp.roll) of (..., H, W)."""
    dx = 0.5 * (torch.roll(gauss, -1, dims=-1) - torch.roll(gauss, 1, dims=-1))
    dy = 0.5 * (torch.roll(gauss, -1, dims=-2) - torch.roll(gauss, 1, dims=-2))
    return dx, dy


def _dominant_orientations(hist):
    """(K, 36) -> primary + strongest secondary peak >= 0.8 max, parabolic
    interpolation: (theta (K, 2), ok (K, 2))."""
    n = _ORI_BINS
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    is_peak = (hist > left) & (hist > right)
    peak_val = torch.where(is_peak, hist, torch.full_like(hist, -1.0))
    main = torch.argmax(peak_val, -1)
    main_val = peak_val.gather(-1, main[:, None])[:, 0]
    peak_val2 = peak_val.scatter(-1, main[:, None], -1.0)
    second = torch.argmax(peak_val2, -1)
    second_val = peak_val2.gather(-1, second[:, None])[:, 0]

    def interp(b):
        b1 = b[:, None]
        l, c, r = left.gather(-1, b1)[:, 0], hist.gather(-1, b1)[:, 0], right.gather(-1, b1)[:, 0]
        denom = l - 2 * c + r
        off = torch.where(denom.abs() > 1e-12, 0.5 * (l - r) / denom, torch.zeros_like(denom))
        off = torch.clamp(off, -0.5, 0.5)
        return ((b.float() + off) / n) * 2 * math.pi

    theta = torch.stack([interp(main), interp(second)], -1)
    ok = torch.stack(
        [main_val > 0, (second_val > 0) & (second_val >= _ORI_PEAK_RATIO * main_val)], -1
    )
    return theta, ok


def _octave_caps(cfg: DetectorConfig):
    return [max(128, cfg.max_keypoints >> o) for o in range(cfg.num_octaves)]


def _ceil_to(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _flat(*xs):
    """(G, Kc) per-keypoint tensors -> (G * Kc,) contiguous: int64 ones as
    int32, float ones as they are."""
    return [x.reshape(-1).to(torch.int32 if x.dtype == torch.int64 else x.dtype).contiguous()
            for x in xs]


def _orientation_phase(src, lev, ys, xs, lx, ly, sigma_rel, win: int, chunk: int):
    """Dominant orientations of (G, Kc) keypoints whose (win, win) windows
    start at (lev, ys, xs) of the flattened (G * S3, Ho, Wo, 2) stack `src`:
    (theta (G, Kc, 2), ok (G, Kc, 2))."""
    G, Kc = lev.shape
    hist = orient_hist(src, *_flat(lev, ys, xs, lx, ly, sigma_rel), win, chunk=chunk)
    theta, ok = _dominant_orientations(smooth_hist(hist))
    return theta.reshape(G, Kc, 2), ok.reshape(G, Kc, 2)


def _descriptor_phase(src, lev, ys, xs, lx, ly, sigma_rel, theta, win: int,
                      cfg: DetectorConfig, chunk: int):
    """Descriptors (G, Kc, d*d*nbins) of oriented keypoints, windows as in
    `_orientation_phase`."""
    G, Kc = lev.shape
    desc = descriptor(src, *_flat(lev, ys, xs, lx, ly, sigma_rel, theta), win,
                      cfg.descriptor_width, cfg.descriptor_bins, chunk=chunk)
    return desc.reshape(G, Kc, -1)


def _extract_group(imgs, cfg: DetectorConfig, chunk: int) -> SiftFeatures:
    """Full SIFT on a (G, H, W) grayscale group -> SiftFeatures (G, K, ...)."""
    G = imgs.shape[0]
    s = cfg.num_layers_in_octave
    k = 2.0 ** (1.0 / s)
    octaves = build_pyramid(imgs, cfg)

    parts = []
    for o, octv in enumerate(octaves):
        cap = _octave_caps(cfg)[min(o, cfg.num_octaves - 1)]
        stride = 2**o
        gauss = octv["gauss"]  # (G, S3, Ho, Wo)
        x_sub, y_sub, layer, resp, valid = _detect_octave(octv["dog"], cfg, cap)

        dx, dy = _grad_maps(gauss)
        mag = torch.sqrt(dx * dx + dy * dy)
        ang = torch.atan2(dy, dx)
        dxy = torch.stack([mag, ang], dim=-1)  # (G, S3, Ho, Wo, 2)
        del dx, dy, mag, ang
        sigma_rel = cfg.sigma * torch.pow(k, layer)
        level = torch.clamp(torch.round(layer).long(), 0, gauss.shape[1] - 1)

        S3, Ho, Wo = gauss.shape[1:]
        srel_max = cfg.sigma * 2.0 ** ((s + 0.5) / s)
        r_desc = (_DESC_SCALE_FACTOR * srel_max * math.sqrt(2.0)
                  * (cfg.descriptor_width + 1) / 2.0)
        Wwin = min(_ceil_to(int(2 * r_desc + 2), 8), (min(Ho, Wo) // 8) * 8)
        r_ori = _ORI_RADIUS_FACTOR * _ORI_SIGMA_FACTOR * srel_max
        Wori = min(Wwin, _ceil_to(int(2 * r_ori + 2), 8))

        def corners(win, xq, yq):
            cx = torch.clamp(torch.round(xq).long() - win // 2, 0, max(Wo - win, 0))
            cy = torch.clamp(torch.round(yq).long() - win // 2, 0, max(Ho - win, 0))
            return cy, cx

        src = dxy.reshape(G * S3, Ho, Wo, 2)  # the image batch flattened into the levels
        img_of = torch.arange(G, device=dxy.device)[:, None] * S3

        # ---- orientation phase (small window) ----
        oy, ox = corners(Wori, x_sub, y_sub)
        thetas, th_ok = _orientation_phase(
            src, img_of + level, oy, ox, x_sub - ox.float(), y_sub - oy.float(), sigma_rel,
            Wori, chunk)  # (G, cap, 2) each

        # ---- oriented-candidate selection ----
        ok2 = valid[:, :, None] & th_ok
        score2 = torch.where(ok2, resp[:, :, None], torch.full_like(ok2, -1.0, dtype=resp.dtype))
        svals, sidx = top_k_stable(score2.reshape(G, -1), cap)
        ci = sidx // 2
        sel_ok = svals > 0

        def take(a):
            return torch.gather(a, 1, ci)

        xs_s, ys_s = take(x_sub), take(y_sub)
        lv_s, sr_s = take(level), take(sigma_rel)
        th_s = torch.gather(thetas.reshape(G, -1), 1, sidx)

        # ---- descriptor phase ----
        dyc, dxc = corners(Wwin, xs_s, ys_s)
        desc = _descriptor_phase(
            src, img_of + lv_s, dyc, dxc, xs_s - dxc.float(), ys_s - dyc.float(), sr_s, th_s,
            Wwin, cfg, chunk)
        del dxy, src
        parts.append(dict(
            xy=torch.stack([xs_s, ys_s], dim=-1) * stride,
            scale=sr_s * stride,
            theta=th_s,
            resp=torch.where(sel_ok, svals, torch.zeros_like(svals)),
            desc=desc,
            mask=sel_ok,
        ))

    cat = {key: torch.cat([p[key] for p in parts], dim=1) for key in parts[0]}
    K = cfg.max_keypoints
    score = torch.where(cat["mask"], cat["resp"], torch.full_like(cat["resp"], -1.0))
    top_vals, top_idx = top_k_stable(score, K)
    sel_mask = top_vals > 0

    def take2(a):
        return torch.gather(a, 1, top_idx)

    def take3(a):
        return torch.gather(a, 1, top_idx[..., None].expand(-1, -1, a.shape[-1]))

    m3 = sel_mask[..., None]
    return SiftFeatures(
        xy=torch.where(m3, take3(cat["xy"]), 0.0),
        scale=torch.where(sel_mask, take2(cat["scale"]), 1.0),
        orientation=torch.where(sel_mask, take2(cat["theta"]), 0.0),
        response=torch.where(sel_mask, top_vals, 0.0),
        desc=torch.where(m3, take3(cat["desc"]), 0.0),
        mask=sel_mask,
    )


def extract_batch(imgs, cfg: DetectorConfig = DetectorConfig(), group: int = 50,
                  chunk: int = 256) -> SiftFeatures:
    """SIFT over same-size grayscale images (N, H, W) -> SiftFeatures
    (N, max_keypoints, ...). Images run `group` at a time (as the
    reference). On the card each window phase is one kernel launch per
    octave of a group; on the CPU the plain versions bin `chunk` keypoints'
    windows at a time (per-keypoint work, so the chunk changes no result)."""
    N = imgs.shape[0]
    G = max(1, min(group, N))
    outs = [_extract_group(imgs[g : g + G], cfg, chunk) for g in range(0, N, G)]
    return SiftFeatures(*[torch.cat(f) for f in zip(*outs)])


def rgb_to_gray(img):
    """ITU-R BT.601 luma (MATLAB rgb2gray weights)."""
    return img[..., 0] * 0.2989 + img[..., 1] * 0.587 + img[..., 2] * 0.114
