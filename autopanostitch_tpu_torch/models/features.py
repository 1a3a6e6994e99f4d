"""Feature-extraction stage: (N, H, W, 3) image stack -> batched features
(port of `models/features.py`): SIFT, the corner detectors with binary
descriptors (HARRIS, FAST, ORB, BRISK), SURF's determinant of Hessian and
KAZE, dispatched on `DetectorConfig.detector`."""

from __future__ import annotations

import numpy as np
import torch

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.ops import corners, doh, kaze, sift
from autopanostitch_tpu_torch.ops import sampling as samp
from autopanostitch_tpu_torch.ops.sift import SiftFeatures
from autopanostitch_tpu_torch.parallel import sharded

BINARY_DETECTORS = ("HARRIS", "FAST", "ORB", "BRISK")  # 256-bit {0,1} descriptors
SHARDED_DETECTORS = ("SIFT", "VL_SIFT")  # what the multi-GPU path extracts


def descriptor_width(cfg: DetectorConfig) -> int:
    """Width of the descriptors cfg.detector gives: 256 bits for the corner
    detectors, descriptor_width^2 * descriptor_bins for SIFT, SURF, KAZE."""
    if cfg.detector.upper() in BINARY_DETECTORS:
        return 256
    return cfg.descriptor_width ** 2 * cfg.descriptor_bins


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
                     border: int = 6, mesh=None) -> SiftFeatures:
    """Features of an (N, H, W, 3) padded stack (uint8 or float in [0, 1])
    on any device, by cfg.detector: 'HARRIS' | 'FAST' | 'ORB' | 'BRISK'
    (256-bit {0,1} descriptors), 'SURF', 'KAZE', else SIFT. Keypoints in the
    padding or within `border` px of the valid edge are masked; the
    upsample levels apply to every detector. With a `parallel.mesh.Mesh`,
    SIFT runs on the images split across its ranks (other detectors
    raise)."""
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
    det = cfg.detector.upper()
    if mesh is not None and det not in SHARDED_DETECTORS:
        raise ValueError(f"the sharded extraction runs SIFT, not detector={cfg.detector!r}")
    if mesh is not None:
        feats = sharded.sharded_extract(gray, mesh, cfg)
    elif det in BINARY_DETECTORS:
        feats = corners.extract_corners_batch(gray, cfg, det.lower())
    elif det == "SURF":
        feats = doh.extract_doh_batch(gray, cfg)
    elif det == "KAZE":
        feats = kaze.extract_kaze_batch(gray, cfg)
    else:  # SIFT / VL_SIFT
        feats = sift.extract_batch(gray, cfg)
    feats = mask_borders(feats, sizes_t, border)
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
