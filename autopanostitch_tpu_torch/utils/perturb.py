"""Capture-realism perturbations for robustness evaluation (the port's own
copy of the JAX package's `utils/perturb.py`, host numpy, same names and
defaults).

The reference's standing claim is robustness on real photographs
(the reference repository's README, dataset compilation, ~6-8% artifact rate).
Real captures differ from synthetic test views in three dominant ways this
module reproduces, so a multi-view set can be stress-tested with controlled
severity:

- exposure differences between frames (auto-exposure steps of +-1 stop) —
  exercised by gain compensation (`gainCompensationRKf.m`),
- sensor noise (shot/read noise at JPEG-survivable levels) — exercises the
  contrast threshold and the matcher's ratio test,
- mild radial lens distortion — the pinhole model error every consumer lens
  introduces; exercises RANSAC's inlier band and BA's Huber loss.

All functions take/return float images in [0, 1] on the host (numpy): these
run once per experiment, not in the hot path.
"""

from __future__ import annotations

import numpy as np

_GAMMA = 2.2


def exposure_jitter(img: np.ndarray, stops: float) -> np.ndarray:
    """Scale exposure by `stops` photographic stops, gamma-aware.

    sRGB-encoded values are linearized, scaled by 2**stops (a physical
    light-quantity change), re-encoded and clipped — matching how a
    camera's auto-exposure step shows up in delivered JPEGs."""
    lin = np.clip(img, 0.0, 1.0) ** _GAMMA
    return np.clip(lin * (2.0 ** stops), 0.0, 1.0) ** (1.0 / _GAMMA)


def add_sensor_noise(
    img: np.ndarray, sigma: float, rng: np.random.Generator,
    shot_frac: float = 0.5,
) -> np.ndarray:
    """Additive Gaussian read noise + signal-dependent shot noise.

    sigma is the read-noise std in [0,1] units (e.g. 2/255); shot noise
    scales with sqrt(intensity) like photon statistics."""
    read = rng.normal(0.0, sigma, img.shape)
    shot = rng.normal(0.0, 1.0, img.shape) * np.sqrt(
        np.clip(img, 0.0, 1.0)
    ) * sigma * shot_frac
    return np.clip(img + read + shot, 0.0, 1.0).astype(img.dtype)


def radial_distort(img: np.ndarray, k1: float, k2: float = 0.0) -> np.ndarray:
    """Apply Brown radial distortion r' = r (1 + k1 r^2 + k2 r^4) about the
    image center (r normalized by the half-diagonal).

    k1 < 0 = barrel (wide-angle consumer lenses), k1 > 0 = pincushion.
    Inverse-mapped with bilinear resampling so the output grid is regular."""
    h, w = img.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    norm = np.hypot(cx, cy)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    u = (xs - cx) / norm
    v = (ys - cy) / norm
    r2 = u * u + v * v
    factor = 1.0 + k1 * r2 + k2 * r2 * r2
    sx = cx + u * factor * norm
    sy = cy + v * factor * norm
    sx = np.clip(sx, 0, w - 1)
    sy = np.clip(sy, 0, h - 1)
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    im = np.clip(img, 0.0, 1.0)
    out = (
        im[y0, x0] * (1 - fx) * (1 - fy)
        + im[y0, x1] * fx * (1 - fy)
        + im[y1, x0] * (1 - fx) * fy
        + im[y1, x1] * fx * fy
    )
    return out.astype(img.dtype)


def perturb_views(
    views,
    stops_amp: float = 1.0,
    noise_sigma: float = 2.0 / 255.0,
    k1: float = -0.05,
    seed: int = 0,
):
    """Standard robustness recipe over a view list: alternating +-stops_amp
    exposure, per-view sensor noise, and a common mild barrel distortion.

    Returns a new list of float32 views in [0, 1]."""
    rng = np.random.default_rng(seed)
    out = []
    for i, v in enumerate(views):
        v = np.asarray(v, np.float32)
        stops = stops_amp if i % 2 == 0 else -stops_amp
        v = exposure_jitter(v, stops)
        if k1:
            v = radial_distort(v, k1)
        if noise_sigma:
            v = add_sensor_noise(v, noise_sigma, rng)
        out.append(v.astype(np.float32))
    return out
