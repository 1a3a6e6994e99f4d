"""KAZE's FED diffusion step — the CUDA kernel wrapper and its plain version.

`fed_step` is one explicit step L + tau div(g grad L) of the nonlinear
scale space (`ops/kaze.nonlinear_scale_space`) over a (G, H, W) float32
image group: per pixel, the flux of the neighbours E (x + 1), W (x - 1),
S (y + 1) and N (y - 1), in this order, each (0.5 * (g + g_nb)) * (L_nb -
L) added to a flux that starts at 0, a neighbour index clamped at the image
edge (Neumann boundaries), then L + tau * flux with tau as a float32; every
sum and product rounded on its own. That order is the contract of both
versions: `fed_step_plain` builds the step from edge-replicating shifts in
PyTorch (what the JAX package's `_diffusion_step` computes, XLA there), and
the kernel, `csrc/kaze.cu`, computes it in one launch a step, equal to the
plain version bit for bit on the card.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. Launch counting (`trace.launched`): `fed_step`, one a step, so a
stitch's `launches.fed_step` equals its `kaze.fed_steps`. This module
imports only `kernels/_build` and `utils/trace`.
"""

from __future__ import annotations

import torch

from autopanostitch_tpu_torch.kernels import _build
from autopanostitch_tpu_torch.utils import trace

trace.declare_kernels("fed_step")


def _shift(a, d: int, dim: int):
    """torch.roll by d along dim with the wrapped row replaced by the edge
    row it left (edge replication)."""
    r = torch.roll(a, d, dim)
    edge = 0 if d > 0 else -1
    r.select(dim, edge).copy_(a.select(dim, edge))
    return r


def fed_step_plain(L, g, tau: float):
    """Plain PyTorch version of `fed_step` (same arguments)."""
    flux = torch.zeros_like(L)
    for d, dim in ((-1, -1), (1, -1), (-1, -2), (1, -2)):  # E, W, S, N
        flux = flux + 0.5 * (g + _shift(g, d, dim)) * (_shift(L, d, dim) - L)
    return L + tau * flux


def _check(L, g) -> None:
    if L.device != g.device:
        raise ValueError(f"fed_step: L on {L.device} and g on {g.device}")
    if L.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fed_step: unsupported device {L.device}")
    if L.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"fed_step: L and g must be float32, got {L.dtype} and {g.dtype}")
    if L.ndim != 3 or g.shape != L.shape:
        raise ValueError(f"fed_step: L and g must be one (G, H, W) shape, got "
                         f"{tuple(L.shape)} and {tuple(g.shape)}")
    if not (L.is_contiguous() and g.is_contiguous()):
        raise ValueError("fed_step: L and g must be contiguous")


def fed_step(L, g, tau: float):
    """One explicit FED step of (G, H, W) float32 levels L under the
    conductivity g (same shape, device, contiguous): a new (G, H, W)
    tensor L + tau div(g grad L), tau applied as a float32."""
    _check(L, g)
    if L.device.type == "cpu":
        return fed_step_plain(L, g, tau)
    out = torch.empty_like(L)
    if out.numel() == 0:
        return out
    G, H, W = L.shape
    err = _build.library().apst_fed_step(
        L.data_ptr(), g.data_ptr(), out.data_ptr(), G, H, W, float(tau),
        torch.cuda.current_stream(L.device).cuda_stream)
    _build.check(err, "apst_fed_step")
    trace.launched("fed_step")
    return out
