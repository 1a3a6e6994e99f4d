"""Image sampling, homography warping, output limits, explicit separable
resizing and feather weights (port of `ops/sampling.py` plus the
`jax.image.resize` calls of the main path).

Samplers take 0-based pixel coordinates (pixel centres at integers), gather
every tap through a clamped index (the reference's `_gather_2d`) and return
0 outside the image with a validity mask. The `*_indexed` forms sample
image idx[...] of a stack with the image axis folded into the gather.

`jax.image.resize` is not torch's `F.interpolate`: its cubic is Keys
a = -0.5 (torch's bicubic is a = -0.75), and its downsampling antialiases
(the kernel widens by the scale factor). `resize_weights` therefore builds
the reference's per-axis weight matrix itself — same half-pixel sample
positions, same border renormalisation, same out-of-range zeroing — and
`resize` contracts one axis at a time with it (each matrix uploaded once per
device and kept). `resize_taps` gives the same weights as (first index,
taps) tables, the form the multiband kernels read. The separable Gaussian
blur lives here too (SIFT's pyramid and the multiband pyramid share it).

This module imports nothing of the package: `kernels/render.py` reads it
for its plain versions and tap tables.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_F32_EPS = float(np.finfo(np.float32).eps)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_weights(in_size: int, out_size: int, method: str,
                   antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) float32 weights of `jax.image.resize` along one
    axis (`jax._src.image.scale.compute_weight_mat`)."""
    kernel = _KERNELS[method]
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(float(inv_scale), 1.0) if antialias else 1.0
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
    sample_f = sample_f - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    x = (x / np.float32(kernel_scale)).astype(np.float32)
    w = kernel(x).astype(np.float32)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * _F32_EPS, w / np.where(tot != 0, tot, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _weights_on(in_size: int, out_size: int, method: str, device: torch.device) -> torch.Tensor:
    """`resize_weights` on `device`, uploaded once per (in, out, method,
    device)."""
    return torch.as_tensor(resize_weights(in_size, out_size, method), device=device)


def resize_taps(in_size: int, out_size: int, method: str, antialias: bool = True):
    """`resize_weights` as compact tables for the kernels: (first (out,)
    int32, taps (out, n) float32) with dense[first[j] + t, j] = taps[j, t]
    and every other entry 0. n is the widest run of a column's nonzero
    weights, and each window is shifted to lie inside [0, in_size)."""
    w = resize_weights(in_size, out_size, method, antialias)
    nz = w != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, in_size - 1 - nz[::-1].argmax(axis=0), 0)
    n = int(max((hi - lo + 1).max(initial=1), 1))
    first = np.clip(lo, 0, in_size - n).astype(np.int32)
    rows = first[:, None] + np.arange(n)[None, :]
    taps = w[rows, np.arange(out_size)[:, None]].astype(np.float32)
    return first, taps


def resize_axis(x: torch.Tensor, axis: int, out_size: int, method: str) -> torch.Tensor:
    """Resize one axis of x like `jax.image.resize(..., method)`."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    y = torch.movedim(x, axis, -1) @ _weights_on(in_size, out_size, method, x.device)
    return torch.movedim(y, -1, axis)


def resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    """`jax.image.resize(x, shape, method)` for method 'linear' | 'cubic'."""
    for axis, n in enumerate(shape):
        x = resize_axis(x, axis, int(n), method)
    return x


def gaussian_kernel1d(sigma: float, device=None):
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img, sigma: float):
    """Separable Gaussian blur of (..., H, W) with edge-replicate padding."""
    if sigma <= 0:
        return img
    k = gaussian_kernel1d(sigma, img.device)
    r = k.shape[0] // 2
    H, W = img.shape[-2:]
    x = img.reshape(-1, 1, H, W)
    x = F.pad(x, (r, r, r, r), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    return x.reshape(img.shape)


def down2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., ceil(H/2), ceil(W/2)), antialiased linear resize
    (the multiband pyramid's step down)."""
    H, W = x.shape[-2:]
    x = resize_axis(x, x.ndim - 2, (H + 1) // 2, "linear")
    return resize_axis(x, x.ndim - 1, (W + 1) // 2, "linear")


def up2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., h', w') -> (..., h, w) linear resize (the pyramid's step up)."""
    x = resize_axis(x, x.ndim - 2, h, "linear")
    return resize_axis(x, x.ndim - 1, w, "linear")


def upsample2x_cubic(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C) Keys a = -0.5 upsample, the
    `jax.image.resize(..., "cubic")` of the bicubic2x renderer; contiguous,
    as the samplers gather whole pixels from it."""
    N, H, W, C = images.shape
    return resize(images, (N, 2 * H, 2 * W, C), "cubic").contiguous()


def _tap(flat, base, xi, yi, H: int, W: int):
    """Clamped integer gather from the (N * H * W, C) view of a stack."""
    return flat[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]


def _flat(imgs, idx):
    N, H, W, C = imgs.shape
    return imgs.reshape(N * H * W, C), (idx.long() * (H * W))[..., None], H, W


def sample_bilinear_indexed(imgs, idx, x, y):
    """Bilinear sampling of image idx[...] of the stack imgs (N, H, W, C) at
    (..., P) coords (idx (...,) broadcasts against x's leading dims).
    Returns (values (..., P, C), valid (..., P))."""
    flat, base, H, W = _flat(imgs, idx)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    top = _tap(flat, base, x0i, y0i, H, W) * (1.0 - fx) + _tap(flat, base, x0i + 1, y0i, H, W) * fx
    bot = (_tap(flat, base, x0i, y0i + 1, H, W) * (1.0 - fx)
           + _tap(flat, base, x0i + 1, y0i + 1, H, W) * fx)
    out = top * (1.0 - fy) + bot * fy
    valid = (x >= 0.0) & (x <= W - 1.0) & (y >= 0.0) & (y <= H - 1.0)
    return out * valid[..., None], valid


def sample_nearest_indexed(imgs, idx, x, y):
    """Nearest-neighbour form of `sample_bilinear_indexed`; torch.round
    rounds half to even like jnp.round. Valid within half a pixel."""
    flat, base, H, W = _flat(imgs, idx)
    out = _tap(flat, base, torch.round(x).long(), torch.round(y).long(), H, W)
    valid = (x >= -0.5) & (x <= W - 0.5) & (y >= -0.5) & (y <= H - 0.5)
    return out * valid[..., None], valid


def sample_bicubic_indexed(imgs, idx, x, y):
    """Keys (a = -0.5) bicubic form of `sample_bilinear_indexed`: 16 clamped
    taps, summed in the reference's order (rows of 4 weighted by x, then
    weighted by y)."""
    flat, base, H, W = _flat(imgs, idx)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    out = torch.zeros(x.shape + (imgs.shape[-1],), dtype=imgs.dtype, device=imgs.device)
    for j in range(-1, 3):
        wy = _cubic_kernel(fy - j)[..., None]
        row = torch.zeros_like(out)
        for i in range(-1, 3):
            row = row + _cubic_kernel(fx - i)[..., None] * _tap(flat, base, x0 + i, y0 + j, H, W)
        out = out + wy * row
    valid = (x >= 0.0) & (x <= W - 1.0) & (y >= 0.0) & (y <= H - 1.0)
    return out * valid[..., None], valid


_INDEXED = {"bilinear": sample_bilinear_indexed, "nearest": sample_nearest_indexed,
            "bicubic": sample_bicubic_indexed}


def _single(sampler, img, x, y):
    return sampler(img[None], torch.zeros((), dtype=torch.long, device=img.device), x, y)


def sample_bilinear(img, x, y):
    """Bilinear sampling of (H, W, C) at (...) float coords; out-of-bounds
    samples are 0. Returns (values (..., C), valid (...))."""
    return _single(sample_bilinear_indexed, img, x, y)


def sample_nearest(img, x, y):
    """Nearest-neighbour sampling of (H, W, C) with out-of-bounds masking."""
    return _single(sample_nearest_indexed, img, x, y)


def sample_bicubic(img, x, y):
    """Keys bicubic sampling of (H, W, C) with out-of-bounds masking."""
    return _single(sample_bicubic_indexed, img, x, y)


def _cubic_kernel(t, a: float = -0.5):
    """Keys cubic kernel (a = -0.5, the reference `imageWarp.m:276-302`)."""
    at = t.abs()
    at2 = at * at
    at3 = at2 * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
    return torch.where(at <= 1.0, w1, torch.where(at < 2.0, w2, torch.zeros_like(at)))


def sample_indexed(method: str, imgs, idx, x, y, fine=None):
    """Sample image idx[...] of imgs with `method` ('nearest' | 'bilinear' |
    'bicubic' | 'bicubic2x'). bicubic2x takes bilinear taps on `fine`, the
    2x Keys upsample of imgs (`upsample2x_cubic`), where the
    jax.image.resize convention puts original coordinate u at 2u + 0.5;
    validity is judged in the original bounds."""
    if method == "bicubic2x":
        H, W = imgs.shape[1:3]
        col, _ = sample_bilinear_indexed(fine, idx, torch.clamp(2.0 * x + 0.5, 0.0, 2 * W - 1.0),
                                         torch.clamp(2.0 * y + 0.5, 0.0, 2 * H - 1.0))
        valid = (x >= 0.0) & (x <= W - 1.0) & (y >= 0.0) & (y <= H - 1.0)
        return col * valid[..., None], valid
    if method not in _INDEXED:
        raise ValueError(f"unknown interpolation {method!r}")
    return _INDEXED[method](imgs, idx, x, y)


def homography_coords(H_inv, out_h: int, out_w: int, x_offset=0.0, y_offset=0.0):
    """Source coordinates (xs, ys) (..., out_h, out_w) of the canvas pixels
    of an inverse-map warp: canvas pixel (xc, yc) is world point
    (xc + x_offset, yc + y_offset), mapped through H_inv (..., 3, 3)."""
    dev = H_inv.device
    yc, xc = torch.meshgrid(torch.arange(out_h, device=dev, dtype=torch.float32),
                            torch.arange(out_w, device=dev, dtype=torch.float32), indexing="ij")
    xw = xc + x_offset
    yw = yc + y_offset
    h = H_inv[..., None, None, :, :]
    denom = h[..., 2, 0] * xw + h[..., 2, 1] * yw + h[..., 2, 2]
    denom = torch.where(denom.abs() < 1e-10, torch.full_like(denom, 1e-10), denom)
    xs = (h[..., 0, 0] * xw + h[..., 0, 1] * yw + h[..., 0, 2]) / denom
    ys = (h[..., 1, 0] * xw + h[..., 1, 1] * yw + h[..., 1, 2]) / denom
    return xs, ys


def warp_homography(img, H_inv, out_h: int, out_w: int, x_offset=0.0, y_offset=0.0,
                    method: str = "bilinear"):
    """Inverse-map warp of img (H, W, C) by homography onto an (out_h,
    out_w) canvas (see `homography_coords`). Returns (warped (out_h, out_w,
    C), valid (out_h, out_w))."""
    xs, ys = homography_coords(H_inv, out_h, out_w, x_offset, y_offset)
    fine = upsample2x_cubic(img[None]) if method == "bicubic2x" else None
    return sample_indexed(method, img[None], torch.zeros((), dtype=torch.long, device=img.device),
                          xs, ys, fine)


def output_limits(H, h, w, n_samples: int = 64):
    """Bounding box (x_min, x_max, y_min, y_max) of an (h, w) image under
    homography H, from n_samples points per side; points that map to
    infinity are left out."""
    return tuple(output_limits_batch(H[None], torch.tensor([[h, w]], device=H.device),
                                     n_samples)[0])


def output_limits_batch(Hs, sizes, n_samples: int = 64):
    """(N, 3, 3) homographies x (N, 2 [h, w]) sizes -> (N, 4)
    [xmin, xmax, ymin, ymax]."""
    dev = Hs.device
    t = torch.linspace(0.0, 1.0, n_samples, device=dev)
    h = sizes[:, 0].float()[:, None]
    w = sizes[:, 1].float()[:, None]
    xs = t * (w - 1)
    ys = t * (h - 1)
    zx, zy = torch.zeros_like(xs), torch.zeros_like(ys)
    px = torch.cat([xs, xs, zy, (w - 1.0).expand_as(ys)], 1)
    py = torch.cat([zx, (h - 1.0).expand_as(xs), ys, ys], 1)
    ph = torch.stack([px, py, torch.ones_like(px)], -1)  # (N, 4n, 3)
    out = ph @ Hs.transpose(1, 2)
    wz = out[..., 2]
    ok = wz.abs() > 1e-9
    xy = out[..., :2] / torch.where(ok, wz, torch.ones_like(wz))[..., None]
    big = torch.full_like(wz, 1e9)
    return torch.stack([
        torch.where(ok, xy[..., 0], big).min(1).values,
        torch.where(ok, xy[..., 0], -big).max(1).values,
        torch.where(ok, xy[..., 1], big).min(1).values,
        torch.where(ok, xy[..., 1], -big).max(1).values,
    ], -1)


def feather_weights(h: int, w: int, device=None):
    """Separable linear border-ramp weights (h, w), max at the centre."""
    wx = 1.0 - torch.abs(torch.linspace(-1.0, 1.0, w, device=device))
    wy = 1.0 - torch.abs(torch.linspace(-1.0, 1.0, h, device=device))
    return torch.clamp(wy, min=1e-4)[:, None] * torch.clamp(wx, min=1e-4)[None, :]


def feather_stack(sizes, H: int, W: int):
    """(N, 2) valid sizes (tensor) -> (N, H, W) feather ramps, zero outside
    each image's valid region."""
    dev = sizes.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    h = sizes[:, 0].float()[:, None, None]
    w = sizes[:, 1].float()[:, None, None]
    wy = 1.0 - torch.abs(2.0 * ys / torch.clamp(h - 1.0, min=1.0) - 1.0)
    wx = 1.0 - torch.abs(2.0 * xs / torch.clamp(w - 1.0, min=1.0) - 1.0)
    ramp = torch.clamp(wy, min=1e-4) * torch.clamp(wx, min=1e-4)
    inside = (ys <= h - 1.0) & (xs <= w - 1.0)
    return torch.where(inside, ramp, torch.zeros_like(ramp))
