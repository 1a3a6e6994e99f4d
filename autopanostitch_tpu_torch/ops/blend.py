"""Linear and Burt-Adelson multiband blending (port of `ops/blend.py`).

Contributors stack along a leading axis; any dimensions before it are
batch dimensions (the renderer blends many tiles at once). The multiband
blend runs on `kernels/render.py` (its CUDA kernels on the card, its plain
version on the CPU).
"""

from __future__ import annotations

import torch

from autopanostitch_tpu_torch.kernels import render as render_kernels
from autopanostitch_tpu_torch.ops.sampling import down2 as _down2  # noqa: F401
from autopanostitch_tpu_torch.ops.sampling import up2 as _up2  # noqa: F401

_EPS = 1e-8


def linear_blend(colors, weights):
    """colors (N, H, W, C), weights (N, H, W) -> (H, W, C) weighted mean."""
    wsum = weights.sum(0)
    acc = (colors * weights[..., None]).sum(0)
    return acc / torch.clamp(wsum, min=_EPS)[..., None]


def multiband_blend(colors, weights, bands: int = 3, sigma: float = 1.0, to_u8: bool = False):
    """Laplacian-pyramid blend across contributors.

    colors (..., N, H, W, 3) in [0, 1], weights (..., N, H, W) ->
    (..., H, W, 3), clamped to [0, 1] and zero where no weight; with to_u8
    the renderer's finish instead: (uint8 (..., H, W, 3), covered (..., H,
    W)), zero where the weights sum to at most 1e-3."""
    return render_kernels.multiband(colors, weights, bands, sigma, to_u8)
