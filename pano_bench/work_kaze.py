"""The work that KAZE's nonlinear scale space is counted with, whatever
implements it: one call evolves a (G, H, W) group of gray images through
the levels of a sigma ladder (`kaze_reference.py` states the scheme).

Operations, float32, a pixel of the group:
- the base blur G_{sigma_0}: a separable Gaussian of 2 ceil(3 sigma_0) + 1
  taps an axis, a multiply and an add a tap;
- each FED cycle, the conductivity: the sigma = 1 blur (7 taps an axis),
  the central gradient (2 subtractions, 2 halvings), and
  g = 1 / (1 + (gx^2 + gy^2) / k^2) (3 + 3 operations);
- each FED step, 22: for each of the 4 neighbours the half-point
  conductivity (an add, a halving), the difference, the product and the
  sum into the flux (5), then L + tau flux (2).

Bytes: the group read once and its levels written once, float32. The
step and cycle counts come from the sigma list by the FED rule (the
program's counters are not read). The bound of a call is the larger of
its operations at the float32 peak outside the tensor cores and its bytes
at the memory bandwidth (`work.peak`)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

from pano_bench import kaze_reference

STEP_OPS = 22
GRADIENT_OPS = 4
CONDUCTIVITY_OPS = 6


def blur_ops(sigma: float) -> int:
    """Operations a pixel of a separable Gaussian blur of sigma."""
    taps = 2 * max(1, int(math.ceil(3.0 * sigma))) + 1
    return 2 * 2 * taps


def fed_counts(sigmas: Sequence[float]) -> Tuple[int, int]:
    """(cycles, steps) of the FED rule from level 0 to the last level."""
    n_cycles = n_steps = 0
    for a, b in zip(sigmas[:-1], sigmas[1:]):
        cyc = kaze_reference.cycles(0.5 * float(b) ** 2 - 0.5 * float(a) ** 2)
        n_cycles += len(cyc)
        n_steps += sum(len(c) for c in cyc)
    return n_cycles, n_steps


def scale_space_ops(shape: Sequence[int], sigmas: Sequence[float]) -> float:
    """Float32 operations of one call on a (G, H, W) group."""
    G, H, W = shape
    n_cycles, n_steps = fed_counts(sigmas)
    per_cycle = blur_ops(kaze_reference.K_SIGMA) + GRADIENT_OPS + CONDUCTIVITY_OPS
    per_pixel = blur_ops(float(sigmas[0])) + n_cycles * per_cycle + n_steps * STEP_OPS
    return float(G * H * W) * per_pixel


def scale_space_bytes(shape: Sequence[int], sigmas: Sequence[float]) -> float:
    """Bytes of one call: the group read once, its levels written once."""
    G, H, W = shape
    return 4.0 * G * H * W * (1 + len(sigmas))


def scale_space_bound_s(shape, sigmas, fp32_flop_s: float, hbm_byte_s: float) -> float:
    """The least seconds one call needs."""
    return max(scale_space_ops(shape, sigmas) / fp32_flop_s,
               scale_space_bytes(shape, sigmas) / hbm_byte_s)
