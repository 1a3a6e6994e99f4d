"""A plain float64 KAZE detector, for holding the program's nonlinear scale
space and keypoints to (`tests/test_torch_kaze_reference.py` on the CPU; on
a card, the group of views that the timed path hands the detector). Plain
`torch` only; it imports nothing of the program and no JAX.

Written from the published description: Alcantarilla, Bartoli and Davison,
"KAZE Features", ECCV 2012, with the fast explicit diffusion of Grewenig,
Weickert and Bruhn, "From Box Filtering to Fast Explicit Diffusion", DAGM
2010, at the settings the `kaze800` configuration states:

1. contrast factor k: the 70th percentile of |grad (G_1 * L)|, taken over
   the pixels whose magnitude is not zero (at most 1e-6 counts as zero) by
   an exact sort, not KAZE's 300-bin histogram; at least 1e-3;
2. evolution times t_i = sigma_i^2 / 2 of the ladder sigma_i = sigma_0
   sqrt(2)^i; level 0 is G_{sigma_0} * L;
3. dL/dt = div(g grad L) with the Perona-Malik conductivity
   g2 = 1 / (1 + |grad (G_1 * L)|^2 / k^2), computed afresh at the start of
   every FED cycle;
4. each level's time T split into m = ceil(n(T) / 12) equal FED cycles,
   each of n(T / m) explicit steps with tau_max = 0.25, the steps of a
   cycle in Grewenig's order (no Leja reordering);
5. an explicit step L + tau sum_n (g + g_n) / 2 (L_n - L) over the four
   neighbours, the Neumann boundary by replicate padding;
6. the response sigma^4 det H of G_sigma * L_i with 3-point second
   differences, and 3x3x3 non-maximum suppression over (scale, y, x) on the
   interior levels, 8 px from the border, then the K strongest maxima with
   their level.

Departures from KAZE, each the configuration's (`configs/kaze800.json`,
`assumed`): gradients and the mixed second derivative are central
differences that wrap at the image border, not Scharr filters; the
response is taken on the level blurred again by its own sigma; a top-K
selection replaces the detector threshold. The reference stops at the
keypoints: their orientation and descriptor are the window phase of the
SIFT-window kernel, which `tests/test_torch_sift_window.py` holds to its
plain version.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TAU_MAX = 0.25  # explicit stability limit of the 2-D 5-point scheme
CYCLE_STEPS = 12  # the most steps that decide a level's number of cycles
PERCENTILE = 70.0
K_SIGMA = 1.0
BORDER = 8


class Keypoints(NamedTuple):
    """The K strongest maxima of each image, (G, K) each; an empty slot has
    response <= 0."""

    response: torch.Tensor
    level: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor


def sigmas(sigma0: float = 1.6, levels: int = 8) -> List[float]:
    return [sigma0 * math.sqrt(2.0) ** i for i in range(levels)]


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """G_sigma * img of (..., H, W): a sampled Gaussian of radius
    ceil(3 sigma) (at least 1), normalised to sum 1, along x then y, with
    the border replicated."""
    r = max(1, int(math.ceil(3.0 * sigma)))
    t = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    H, W = img.shape[-2:]
    x = F.pad(img.reshape(-1, 1, H, W), (r, r, r, r), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    return x.reshape(img.shape)


def central(L: torch.Tensor, dim: int) -> torch.Tensor:
    """(L[i + 1] - L[i - 1]) / 2 along dim, periodic at the border."""
    return 0.5 * (torch.roll(L, -1, dim) - torch.roll(L, 1, dim))


def contrast_k(img: torch.Tensor) -> torch.Tensor:
    """(G,) contrast factors of (G, H, W) images (step 1)."""
    s = blur(img, K_SIGMA)
    mag = torch.hypot(central(s, -1), central(s, -2)).reshape(img.shape[0], -1)
    out = []
    for m in mag:
        nz = torch.sort(m[m > 1e-6]).values
        if len(nz) == 0:
            out.append(torch.zeros((), dtype=img.dtype, device=img.device))
            continue
        out.append(nz[min(int(PERCENTILE / 100.0 * len(nz)), len(nz) - 1)])
    return torch.clamp(torch.stack(out), min=1e-3)


def fed_steps(T: float) -> List[float]:
    """One FED cycle reaching time T: n = ceil(sqrt(3 T / tau_max + 1/4) -
    1/2) steps tau_j = tau_max / (2 cos^2(pi (2j + 1) / (4n + 2))), scaled by
    3 T / (tau_max n (n + 1)) so that they sum to T."""
    if T <= 0:
        return []
    n = max(1, math.ceil(math.sqrt(3.0 * T / TAU_MAX + 0.25) - 0.5))
    scale = 3.0 * T / (TAU_MAX * n * (n + 1))
    return [scale * TAU_MAX / (2.0 * math.cos(math.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
            for j in range(n)]


def cycles(T: float) -> List[List[float]]:
    """A level's time T as m = ceil(n(T) / 12) equal FED cycles (step 4)."""
    if T <= 0:
        return []
    m = max(1, math.ceil(len(fed_steps(T)) / CYCLE_STEPS))
    return [fed_steps(T / m) for _ in range(m)]


def conductivity(L: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """g2 of (G, H, W) levels (step 3)."""
    s = blur(L, K_SIGMA)
    grad2 = central(s, -1) ** 2 + central(s, -2) ** 2
    return 1.0 / (1.0 + grad2 / (k * k)[:, None, None])


def step(L: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit step of div(g grad L) (step 5)."""
    G, H, W = L.shape
    Lp = F.pad(L[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gp = F.pad(g[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    c = (slice(None), slice(1, H + 1), slice(1, W + 1))
    flux = torch.zeros_like(L)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        n = (slice(None), slice(1 + dy, H + 1 + dy), slice(1 + dx, W + 1 + dx))
        flux = flux + 0.5 * (gp[c] + gp[n]) * (Lp[n] - Lp[c])
    return L + tau * flux


def scale_space(img: torch.Tensor, sig: List[float], k=None) -> torch.Tensor:
    """(G, S, H, W) levels of (G, H, W) images at t_i = sigma_i^2 / 2."""
    if k is None:
        k = contrast_k(img)
    L = blur(img, sig[0])
    levels = [L]
    for a, b in zip(sig[:-1], sig[1:]):
        for cyc in cycles(0.5 * b * b - 0.5 * a * a):
            g = conductivity(L, k)
            for tau in cyc:
                L = step(L, g, tau)
        levels.append(L)
    return torch.stack(levels, 1)


def response(L: torch.Tensor, sigma: float) -> torch.Tensor:
    """sigma^4 det H of G_sigma * L, (..., H, W) (step 6)."""
    s = blur(L, sigma)
    Lxx = torch.roll(s, -1, -1) + torch.roll(s, 1, -1) - 2.0 * s
    Lyy = torch.roll(s, -1, -2) + torch.roll(s, 1, -2) - 2.0 * s
    Lxy = central(central(s, -1), -2)
    return sigma ** 4 * (Lxx * Lyy - Lxy * Lxy)


def detect(levels: torch.Tensor, sig: List[float], K: int) -> Keypoints:
    """The K strongest 3x3x3 maxima above 1e-6 on levels 1 .. S-2, at least
    BORDER px from the border; ties keep the lower (level, y, x)."""
    G, S, H, W = levels.shape
    resp = torch.stack([response(levels[:, i], s) for i, s in enumerate(sig)], 1)
    keep = torch.zeros(G, S - 2, H, W, dtype=torch.bool, device=levels.device)
    inner = resp[:, 1:-1]
    padded = F.pad(resp, (1, 1, 1, 1), value=-math.inf)
    biggest = torch.full_like(inner, -math.inf)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                biggest = torch.maximum(
                    biggest, padded[:, 1 + ds:S - 1 + ds, 1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx])
    keep[..., BORDER:H - BORDER, BORDER:W - BORDER] = True
    keep &= (inner >= biggest) & (inner > 1e-6)
    score = torch.where(keep, inner, torch.full_like(inner, -1.0)).reshape(G, -1)
    order = torch.sort(score, dim=-1, descending=True, stable=True)
    vals, flat = order.values[:, :K], order.indices[:, :K]
    rem = flat % (H * W)
    return Keypoints(vals, flat // (H * W) + 1, rem // W, rem % W)
