"""Frozen copy of the synthetic scene arithmetic of `tests/synthdata.py`.

The textures are made as there (numpy's generator, so a seed gives the same
texture); the pinhole views are rendered with the same Keys bicubic sampler,
in float64 on a torch device, so that a pool of 800x600 views is made in
seconds on the card. `tests/test_bench_scenes.py` holds both against
`tests/synthdata.py` on the CPU. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch


def texture(seed: int, h: int, w: int) -> np.ndarray:
    """Multi-octave value-noise RGB texture in [0, 1], rich in corners."""
    r = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    for octave, amp in [(8, 0.5), (16, 0.25), (32, 0.15), (64, 0.1)]:
        gh, gw = max(2, h // octave), max(2, w // octave)
        grid = r.uniform(size=(gh, gw, 3)).astype(np.float32)
        ys = np.minimum((np.arange(h) * gh // h), gh - 1)
        xs = np.minimum((np.arange(w) * gw // w), gw - 1)
        img += amp * grid[ys][:, xs]
    img -= img.min()
    img /= img.max()
    return img


def smooth_texture(seed: int, h: int, w: int, cutoff: float = 0.08,
                   device="cpu") -> torch.Tensor:
    """Band-limited RGB texture in [0, 1] (h, w, 3) float32 on `device`: an
    FFT low-pass of numpy's white noise, in float64 as numpy computes it."""
    noise = np.random.default_rng(seed).standard_normal((h, w, 3)).astype(np.float32)
    x = torch.as_tensor(noise, device=device).double()
    fy = torch.fft.fftfreq(h, device=device, dtype=torch.float64)[:, None]
    fx = torch.fft.fftfreq(w, device=device, dtype=torch.float64)[None, :]
    keep = (torch.hypot(fy, fx) <= cutoff).double()
    img = torch.fft.ifft2(torch.fft.fft2(x, dim=(0, 1)) * keep[..., None], dim=(0, 1)).real
    img = img - img.min()
    img = img / img.max()
    return img.float()


def rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _cubic(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    at = t.abs()
    at2, at3 = at * at, at * at * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
    return torch.where(at <= 1.0, w1, torch.where(at < 2.0, w2, torch.zeros_like(at)))


def bicubic(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Keys bicubic (a = -0.5) samples of img (h, w, c) at float64 pixel
    coordinates x, y (any shape), borders clamped: float64 (..., c)."""
    h, w = img.shape[:2]
    src = img.double()
    x = x.clamp(0, w - 1.001)
    y = y.clamp(0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx, fy = x - x0, y - y0
    out = torch.zeros(x.shape + (img.shape[-1],), dtype=torch.float64, device=img.device)
    for j in range(-1, 3):
        wy = _cubic(fy - j)[..., None]
        yj = (y0 + j).clamp(0, h - 1)
        row = torch.zeros_like(out)
        for i in range(-1, 3):
            wx = _cubic(fx - i)[..., None]
            row += wx * src[yj, (x0 + i).clamp(0, w - 1)]
        out += wy * row
    return out


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (h, w, c), borders clamped: float64 (..., c)."""
    h, w = img.shape[:2]
    src = img.double()
    x = x.clamp(0, w - 1.001)
    y = y.clamp(0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (src[y0, x0] * (1 - fx) * (1 - fy) + src[y0, x0 + 1] * fx * (1 - fy)
            + src[y0 + 1, x0] * (1 - fx) * fy + src[y0 + 1, x0 + 1] * fx * fy)


def env_lookup(env: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bicubic samples of an equirectangular environment along world rays
    d (..., 3): float64 (..., 3)."""
    eh, ew = env.shape[:2]
    theta = torch.atan2(d[..., 0], d[..., 2])
    phi = torch.atan2(d[..., 1], torch.hypot(d[..., 0], d[..., 2]))
    ex = (theta + np.pi) / (2 * np.pi) * (ew - 1)
    ey = (phi + np.pi / 2) / np.pi * (eh - 1)
    return bicubic(env, ex, ey)


def render_pinhole(env: torch.Tensor, R: np.ndarray, f: float, w: int, h: int) -> torch.Tensor:
    """Pinhole views (world -> camera rotations R (n, 3, 3), focal f px) of
    the environment, bicubic: float32 (n, h, w, 3) on env's device."""
    dev = env.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev), indexing="ij")
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    d = torch.stack([(xs - cx) / f, (ys - cy) / f, torch.ones_like(xs)], -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    Rt = torch.as_tensor(np.asarray(R, np.float64), device=dev)
    return torch.stack([env_lookup(env, d @ Rt[k]).float() for k in range(Rt.shape[0])])
