"""Feature-extraction stage: (N, H, W, 3) image stack -> batched SIFT
(port of `models/features.py` for the SIFT detector)."""

from __future__ import annotations

import numpy as np
import torch

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.ops import sampling as samp
from autopanostitch_tpu_torch.ops import sift
from autopanostitch_tpu_torch.ops.sift import SiftFeatures


def upsample_levels(cfg: DetectorConfig, sizes) -> int:
    """Number of 2x upsample levels (Lowe octave -1, -2): the reference's
    tri-state rule on the largest valid image dimension."""
    if cfg.upsample_input is not None:
        return 1 if cfg.upsample_input else 0
    maxdim = int(np.asarray(sizes).max())
    if maxdim < int(cfg.upsample_second_below):
        return 2
    return 1 if maxdim < int(cfg.upsample_below) else 0


def extract_features(images, sizes, cfg: DetectorConfig = DetectorConfig(),
                     border: int = 6) -> SiftFeatures:
    """SIFT on an (N, H, W, 3) padded stack (uint8 or float in [0, 1]) on
    any device; keypoints in the padding or within `border` px of the valid
    edge are masked. Other detectors are not ported yet (ROADMAP A11)."""
    if cfg.detector.upper() not in ("SIFT", "VL_SIFT"):
        raise NotImplementedError(
            f"detector {cfg.detector!r} is not ported yet (ROADMAP A11); the port runs SIFT"
        )
    levels = upsample_levels(cfg, sizes)
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    sizes_t = torch.as_tensor(np.asarray(sizes), dtype=torch.int32, device=images.device)
    gray = sift.rgb_to_gray(images)
    scale_back = 1.0
    if levels:
        N, H, W = gray.shape
        s = 1 << levels
        gray = samp.resize(gray, (N, s * H, s * W), "linear")
        sizes_t = sizes_t * s
        scale_back = 1.0 / s
    feats = mask_borders(sift.extract_batch(gray, cfg), sizes_t, border)
    if scale_back != 1.0:
        feats = feats._replace(xy=feats.xy * scale_back, scale=feats.scale * scale_back)
    return feats


def mask_borders(feats: SiftFeatures, sizes, border: int = 6) -> SiftFeatures:
    """Mask keypoints in the zero-padding or hugging the valid border."""
    h_valid = sizes[:, 0][:, None].float()
    w_valid = sizes[:, 1][:, None].float()
    x = feats.xy[..., 0]
    y = feats.xy[..., 1]
    in_valid = (
        (x >= border) & (x <= w_valid - 1 - border)
        & (y >= border) & (y <= h_valid - 1 - border)
    )
    return feats._replace(mask=feats.mask & in_valid)
