"""Analytic per-stage FLOP accounting for a bench (the port's own copy of
the JAX package's `utils/flops.py`: the same counting functions).

Counts the arithmetic the pipeline's stage math performs, from the
workload shapes alone: no instrumentation. The counts are lower bounds
(elementwise glue, masking and bookkeeping are ignored); divided by
measured device seconds they give achieved FLOP/s and the share of a peak.

Only two stages carry FLOPs: the pooled matcher (the all-pairs distance is
one F x F x D product, kernel B1) and SIFT's pyramid convolutions. RANSAC,
BA, gain and render are bound by latency and bandwidth (small batched
solves, top-k, gathers), so their share of a FLOP peak is near 0 by
nature; the per-stage numbers show that distribution.

Peak: one H100 SXM's dense bf16 tensor-core rate, 989 TFLOP/s (the figure
`chip_smoke.py`'s bounds use). B1 runs float32 as 3xTF32 and the other
stages in float32, so one bf16 peak understates their efficiency: a
conservative denominator.
"""

from __future__ import annotations

H100_SXM_BF16_PEAK_FLOPS = 989e12  # dense bf16 tensor cores


def matching_flops(n_desc_valid: int, dim: int = 128, k: int = 4) -> float:
    """Pooled kNN: one (F, D) x (D, F) distance matmul (2 F^2 D) plus the
    norm expansion (~3 F^2). top_k is comparison work, not FLOPs."""
    f = float(n_desc_valid)
    return 2.0 * f * f * dim + 3.0 * f * f


def sift_flops(
    n_images: int, h: int, w: int, num_octaves: int, scales_per_octave: int = 3,
    max_keypoints: int = 512,
) -> float:
    """Gaussian pyramid separable convolutions + DoG + descriptor build.

    Per octave: (scales+3) blurs, separable 2x(2*r+1) taps with r ~ 4-8
    (use 13-tap per axis as a representative mid-pyramid kernel), plus the
    128-d descriptor contraction per keypoint (16x16 window x 128 bins)."""
    total = 0.0
    taps = 13
    for o in range(num_octaves):
        ho, wo = h >> o, w >> o
        blurs = scales_per_octave + 3
        total += n_images * blurs * ho * wo * (2 * 2 * taps)  # separable conv
        total += n_images * (blurs - 1) * ho * wo  # DoG subtract
        total += n_images * (blurs - 3) * ho * wo * 26  # 3x3x3 extrema compare
    # orientation + descriptor: ~16x16 window, grads + trilinear binning
    total += n_images * max_keypoints * (16 * 16) * 30
    # descriptor contraction (window pixels x 128 bins)
    total += n_images * max_keypoints * 2 * (16 * 16) * 128
    return total


def ransac_flops(
    n_pairs: int, trials_per_pair: float, m_matches: int, min_pts: int = 4,
    irls_iters: int = 3,
) -> float:
    """Hypothesis solves + symmetric-transfer scoring + IRLS refits.

    Per hypothesis: 8x8 normal-equations solve (~2/3 * 8^3 + A build
    2*8*8*8) and a (2, M) symmetric transfer error (~60 flops/match)."""
    solve = (2.0 / 3.0) * 8**3 + 2.0 * 8 * 8 * (2 * min_pts)
    score = 60.0 * m_matches
    per_pair = trials_per_pair * (solve + score)
    refit = irls_iters * (2.0 * 9 * 9 * m_matches + (2.0 / 3.0) * 9**3 + score)
    return n_pairs * (per_pair + refit)


def ba_flops(
    phases: int, iters: int, n_pairs: int, m_matches: int, nb: int,
    pd: int = 5,
) -> float:
    """LM: per-iteration pair residual+Jacobian builds and the dense
    (pd*nb)^2 Cholesky solve. Jacobian: 4 residuals x 2pd params x ~40
    flops per match (projection chain, both directions)."""
    pair_lin = n_pairs * m_matches * (4 * 2 * pd * 40.0 + 120.0)
    n = pd * nb
    solve = (1.0 / 3.0) * n**3 + 2.0 * n * n
    scatter = n_pairs * (2 * pd) ** 2
    per_iter = pair_lin + solve + scatter + 0.5 * pair_lin  # accept-test cost
    return phases * iters * per_iter


def gain_flops(n_images: int, grid_points: int) -> float:
    """Image-space overlap stats: project every grid point into every
    camera (~20 flops) + the (N, N, 3) color-sum einsum (2 flops/term)."""
    return n_images * n_images * grid_points * (20.0 + 2.0 * 3)


def render_flops(canvas_px: int, contributors: int, channels: int = 3) -> float:
    """Inverse-map sampling: per pano pixel per contributor: ray gen +
    rotate + project (~45) + bilinear gather weights (4 taps x (3 color +
    1 feather) ~ 30) + blend accumulate."""
    return canvas_px * contributors * (45.0 + 30.0 * (channels + 1) / 3.0 + 10.0)


def stage_mfu(flops: float, seconds: float, peak: float = H100_SXM_BF16_PEAK_FLOPS):
    """(achieved GFLOP/s, MFU fraction) for one stage."""
    if seconds <= 0:
        return 0.0, 0.0
    rate = flops / seconds
    return rate / 1e9, rate / peak
