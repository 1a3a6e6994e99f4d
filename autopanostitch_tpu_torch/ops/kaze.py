"""KAZE: det-Hessian blobs of a nonlinear (Perona-Malik) scale space (port of
`ops/kaze.py`), batched over images.

The image evolves by dL/dt = div(g(|grad L_sigma|) grad L) with
g = 1 / (1 + s^2 / k^2), in FED (fast explicit diffusion) cycles of at most
12 explicit 5-point steps with edge-replicating shifts, the conductivity
refreshed each cycle, up to the times t_i = sigma_i^2 / 2 of the DoH
detector's sigma ladder. Detection and description are `doh`'s
(`extract_from_levels`, kernel B2 for the window phase) with sigma-sized
derivatives. The step sizes are host Python floats, applied in float32 as
the reference applies them. Each explicit step is one launch of the
`fed_step` kernel on a card (`kernels/kaze.py`); the conductivity refresh,
the contrast sort, the base blur and the detection are plain PyTorch.

Each image group records the spans `kaze.contrast`, `kaze.scale_space` and
`kaze.detect` (`utils/trace.py`; `doh.detect` and `doh.window` beneath the
last) and adds to the counters `kaze.groups`, `kaze.fed_cycles` and
`kaze.fed_steps`, counted from the host's step lists.
"""

from __future__ import annotations

import math

import torch

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.kernels import kaze as kaze_kernels
from autopanostitch_tpu_torch.ops import doh
from autopanostitch_tpu_torch.ops.sift import SiftFeatures, _grad_maps, gaussian_blur
from autopanostitch_tpu_torch.utils import trace

TAU_MAX = 0.25  # 2-D explicit-scheme stability limit


def contrast_k(img, sigma: float = 1.0, perc: float = 70.0):
    """Per image of (G, H, W): the `perc` percentile of |grad (G_sigma * L)|
    over the pixels with a nonzero gradient (by sort and index), at least
    1e-3. Returns (G,)."""
    gx, gy = _grad_maps(gaussian_blur(img, sigma))
    mag = torch.sqrt(gx * gx + gy * gy).reshape(img.shape[0], -1)
    F = mag.shape[1]
    srt = torch.sort(mag, dim=-1)[0]
    n_nz = (mag > 1e-6).sum(-1).to(torch.int32)
    # float32 as the reference: int F - n_nz plus float32(perc / 100) n_nz
    pos = (F - n_nz).to(torch.float32) + torch.tensor(perc / 100.0) * n_nz.to(torch.float32)
    idx = torch.clamp(pos.to(torch.int32), 0, F - 1).long()
    return torch.clamp(srt.gather(1, idx[:, None])[:, 0], min=1e-3)


def _conductivity(L, k):
    """PM g2 conductivity of (G, H, W) levels from the sigma = 1 gradient."""
    gx, gy = _grad_maps(gaussian_blur(L, 1.0))
    kk = (k * k)[:, None, None]
    return 1.0 / (1.0 + (gx * gx + gy * gy) / kk)


def fed_tau(T: float, tau_max: float = TAU_MAX) -> list:
    """FED step sizes covering diffusion time T in one cycle (host floats)."""
    if T <= 0:
        return []
    n = int(math.ceil(0.5 * (math.sqrt(1.0 + 12.0 * T / tau_max) - 1.0)))
    n = max(n, 1)
    taus = [
        tau_max / (2.0 * math.cos(math.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
        for j in range(n)
    ]
    s = sum(taus)
    return [t * T / s for t in taus]


def fed_cycles(T: float, tau_max: float = TAU_MAX, n_max: int = 12) -> list:
    """T split into FED cycles of at most n_max inner steps each."""
    if T <= 0:
        return []
    n_full = int(math.ceil(0.5 * (math.sqrt(1.0 + 12.0 * T / tau_max) - 1.0)))
    m = max(1, int(math.ceil(max(n_full, 1) / n_max)))
    return [fed_tau(T / m, tau_max) for _ in range(m)]


def _diffusion_step(L, g, tau: float):
    """One explicit step of div(g grad L) with half-point conductivities and
    Neumann boundaries; tau is applied as a float32. The one call site of
    the step: `kernels/kaze.fed_step` (one kernel launch on a card, the plain
    version on the CPU)."""
    return kaze_kernels.fed_step(L, g, tau)


def nonlinear_scale_space(img, sigmas, k_sigma: float = 1.0, k=None):
    """(G, S, H, W) evolved levels of (G, H, W) images at t_i = sigma_i^2 / 2:
    level 0 the Gaussian base, each next one a further set of FED cycles.
    k: the (G,) contrast factors, `contrast_k(img, k_sigma)` where None."""
    if k is None:
        k = contrast_k(img, k_sigma)
    L = gaussian_blur(img, float(sigmas[0]))
    levels = [L]
    t_prev = 0.5 * float(sigmas[0]) ** 2
    n_cycles = n_steps = 0
    for s in sigmas[1:]:
        t = 0.5 * float(s) ** 2
        for cycle in fed_cycles(t - t_prev):
            g = _conductivity(L, k)  # refreshed per cycle
            for tau in cycle:
                L = _diffusion_step(L, g, tau)
            n_cycles += 1
            n_steps += len(cycle)
        levels.append(L)
        t_prev = t
    trace.count("kaze.fed_cycles", n_cycles)
    trace.count("kaze.fed_steps", n_steps)
    return torch.stack(levels, 1)


def hessian_response_scharr(L, sigma: float):
    """det-Hessian with sigma-sized derivatives: that of G_sigma * L."""
    return doh.hessian_response(gaussian_blur(L, sigma), sigma)


def extract_kaze(imgs, cfg: DetectorConfig = DetectorConfig()) -> SiftFeatures:
    """KAZE blobs + SIFT-window descriptors of a (G, H, W) gray image group."""
    sigmas = doh.doh_sigmas(cfg)
    trace.count("kaze.groups")
    with trace.span("kaze.contrast"):
        k = contrast_k(imgs)
    with trace.span("kaze.scale_space"):
        Ls = nonlinear_scale_space(imgs, sigmas, k=k)
    with trace.span("kaze.detect"):
        return doh.extract_from_levels(Ls, sigmas, cfg, resp_fn=hessian_response_scharr)


def extract_kaze_batch(imgs, cfg: DetectorConfig, group: int = 8) -> SiftFeatures:
    return doh.batched(extract_kaze, imgs, cfg, group)
