"""Corner detectors (Harris, FAST) and oriented binary descriptors (ORB-style)
on tensors (port of `ops/corners.py`), batched over images.

- Harris response over a blurred structure tensor;
- FAST-9 segment-test score from 16 shifted comparisons and circular runs;
- intensity-centroid orientation (ORB);
- steered BRIEF, 256 bits as a {0,1} float vector: its squared L2 distance
  IS the Hamming distance, so the matchers and kernel B1 take it as it is.

Same numerics as the reference: wrap-around shifts (`torch.roll`, as
`jnp.roll`), top-k with ties to the lower index (`top_k_stable`), and
integer casts that truncate toward zero. The BRIEF sample pairs are the
reference's: the same numpy generator and seed.
"""

from __future__ import annotations

import numpy as np
import torch

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.ops.sift import SiftFeatures, _grad_maps, gaussian_blur, top_k_stable

# 16-point Bresenham circle of radius 3 (FAST), as (dx, dy)
_FAST_OFFSETS = [
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
]


def harris_response(img, sigma: float = 1.5, k: float = 0.04):
    """det(M) - k tr(M)^2 of the blurred structure tensor of (..., H, W)."""
    dx, dy = _grad_maps(img)
    Ixx = gaussian_blur(dx * dx, sigma)
    Iyy = gaussian_blur(dy * dy, sigma)
    Ixy = gaussian_blur(dx * dy, sigma)
    tr = Ixx + Iyy
    return (Ixx * Iyy - Ixy * Ixy) - k * tr * tr


def fast_score(img, threshold: float = 0.05, arc: int = 9):
    """FAST segment test on (..., H, W): a corner has `arc` contiguous circle
    points all brighter (or all darker) than the centre +- threshold; its
    score is the sum of |circle - centre| over the 16 points, else 0."""
    stack = torch.stack([torch.roll(img, (-dy, -dx), (-2, -1)) for dx, dy in _FAST_OFFSETS])
    brighter = stack > img + threshold
    darker = stack < img - threshold

    def has_run(mask):
        run = torch.zeros_like(img, dtype=torch.bool)
        for start in range(16):
            seg = mask[start % 16]
            for o in range(1, arc):
                seg = seg & mask[(start + o) % 16]
            run = run | seg
        return run

    corner = has_run(brighter) | has_run(darker)
    diff = (stack - img).abs()
    strength = diff[0]
    for d in diff[1:]:
        strength = strength + d
    return torch.where(corner, strength, torch.zeros_like(strength))


def _nms(resp, radius: int = 1):
    """Strict-or-equal local maxima of (..., H, W) over the (2r+1)^2
    neighbourhood (wrap-around), and positive."""
    m = resp
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx or dy:
                m = torch.maximum(m, torch.roll(resp, (dy, dx), (-2, -1)))
    return (resp >= m) & (resp > 0)


def _select_corners(resp, cap: int, border: int = 16):
    """Top-`cap` NMS maxima of (N, H, W) responses, a `border` px frame
    excluded: (x, y, score, valid), each (N, cap)."""
    keep = _nms(resp)
    keep[..., :border, :] = False
    keep[..., -border:, :] = False
    keep[..., :border] = False
    keep[..., -border:] = False
    N, H, W = resp.shape
    score = torch.where(keep, resp, torch.full_like(resp, -1.0)).reshape(N, -1)
    vals, flat = top_k_stable(score, cap)
    return (flat % W).to(torch.float32), (flat // W).to(torch.float32), vals, vals > 0


def _patch_index(size: int, coord, offs):
    """Pixel index of coord + offs, truncated toward zero, then clipped."""
    return torch.clamp((coord[..., None, None] + offs).to(torch.int32), 0, size - 1).long()


def intensity_centroid_orientation(img, x, y, radius: int = 7):
    """ORB orientation atan2(m01, m10) of the intensity centroid of the
    radius-7 disc around each keypoint. img (N, H, W), x/y (N, K)."""
    N, H, W = img.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    circle = ((ox * ox + oy * oy) <= radius * radius).to(img.dtype)
    xs = _patch_index(W, x, ox)
    ys = _patch_index(H, y, oy)
    n = torch.arange(N, device=img.device)[:, None, None, None]
    patch = img[n, ys, xs] * circle  # (N, K, 2r+1, 2r+1)
    m10 = (patch * ox).sum((-2, -1))
    m01 = (patch * oy).sum((-2, -1))
    return torch.atan2(m01, m10)


def _brief_pattern(n_bits: int = 256, patch: float = 24.0, seed: int = 7) -> np.ndarray:
    """Fixed Gaussian-distributed BRIEF point pairs [x1 y1 x2 y2] (host
    constant, the reference's generator and seed)."""
    r = np.random.default_rng(seed)
    pts = np.clip(r.normal(scale=patch / 5.0, size=(n_bits, 4)), -patch / 2, patch / 2)
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()


def rotated_brief(img_blur, x, y, theta):
    """Steered-BRIEF 256-bit descriptors as {0,1} float vectors: (N, K, 256)
    of img_blur (N, H, W) at keypoints x/y/theta (N, K)."""
    N, H, W = img_blur.shape
    pat = torch.as_tensor(_PATTERN, device=img_blur.device)
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    xi, yi = x[..., None], y[..., None]
    n = torch.arange(N, device=img_blur.device)[:, None, None]

    def sample(px, py):
        xi0 = torch.clamp(px.to(torch.int32), 0, W - 1).long()
        yi0 = torch.clamp(py.to(torch.int32), 0, H - 1).long()
        return img_blur[n, yi0, xi0]

    a = sample(c * pat[:, 0] - s * pat[:, 1] + xi, s * pat[:, 0] + c * pat[:, 1] + yi)
    b = sample(c * pat[:, 2] - s * pat[:, 3] + xi, s * pat[:, 2] + c * pat[:, 3] + yi)
    return (a < b).to(torch.float32)


def extract_corners_batch(imgs, cfg: DetectorConfig = DetectorConfig(),
                          method: str = "harris") -> SiftFeatures:
    """Corners + oriented binary descriptors of (N, H, W) gray images.

    method: 'harris' | 'fast' | 'orb' (FAST corners ranked by the Harris
    response) | 'brisk' (as 'fast'). Returns SiftFeatures (N, K, ...) whose
    desc is 256-d {0,1}."""
    if method == "harris":
        resp = harris_response(imgs, sigma=cfg.sigma)
    elif method in ("fast", "brisk"):
        resp = fast_score(imgs)
    elif method == "orb":
        fr = fast_score(imgs)
        hr = harris_response(imgs, sigma=cfg.sigma)
        resp = torch.where(fr > 0, torch.clamp(hr, min=0.0), torch.zeros_like(hr))
    else:
        raise ValueError(f"unknown corner method {method!r}")
    K = cfg.max_keypoints
    x, y, score, valid = _select_corners(resp, K)
    blur = gaussian_blur(imgs, 2.0)
    theta = intensity_centroid_orientation(blur, x, y)
    desc = rotated_brief(blur, x, y, theta) * valid[..., None]
    vf = valid.to(torch.float32)
    return SiftFeatures(
        xy=torch.stack([x, y], -1) * vf[..., None],
        scale=torch.full(x.shape, cfg.sigma, dtype=torch.float32, device=x.device),
        orientation=theta * vf,
        response=torch.where(valid, score, torch.zeros_like(score)),
        desc=desc,
        mask=valid,
    )
