"""Panorama cropping: nonzero bounding box and largest inscribed rectangle.

Host-side equivalents of:
- `renderPanorama.m cropNonzeroBbox :1459-1504` (tight bbox of covered px)
- `imageProcessing/panoramaCropper.m:96-157` (largest inscribed axis-aligned
  rectangle via per-row histogram + monotonic-stack max-rectangle)
- `imageProcessing/cropNsavePanorama.m` (save orchestration lives in the
  CLI / pipeline)

We operate on the renderer's exact coverage mask instead of the reference's
canvas-color thresholding + imfill; a color-threshold fallback is provided
for externally produced panoramas (`mask_from_color`).
"""

from __future__ import annotations

import subprocess

import numpy as np


def mask_from_color(pano: np.ndarray, canvas_color: str = "black",
                    black_range: int = 0, white_range: int = 250,
                    fill_holes: bool = True) -> np.ndarray:
    """Valid-pixel mask by thresholding against the canvas color
    (reference `panoramaCropper.m:73-88`; thresholds `inputs.m:117-118`).

    Interior holes — shadow pixels darker than ``black_range`` or highlights
    brighter than ``white_range`` inside the panorama — are filled like the
    reference's `imfill(BW, 'holes')` (`panoramaCropper.m:85`), so they do not
    shrink the inscribed-rectangle crop."""
    if pano.dtype != np.uint8:
        img = (np.clip(pano, 0, 1) * 255).astype(np.uint8)
    else:
        img = pano
    if canvas_color == "white":
        mask = (img <= white_range).any(axis=-1)
    else:
        mask = (img > black_range).any(axis=-1)
    if fill_holes and mask.any():
        from scipy.ndimage import binary_fill_holes

        mask = binary_fill_holes(mask)
    return mask


def fill_canvas_color(pano: np.ndarray, mask: np.ndarray,
                      canvas_color: str = "black") -> np.ndarray:
    """Fill uncovered pixels with the configured canvas color
    (reference `inputs.m canvasColor`; the renderer composites onto zeros,
    so 'black' is a no-op)."""
    if canvas_color == "black":
        return pano
    fill = 255 if pano.dtype == np.uint8 else 1.0
    out = pano.copy()
    out[~mask] = fill
    return out


def draw_rect(pano: np.ndarray, rect, color=(255, 0, 0), width: int = 3) -> np.ndarray:
    """Overlay the crop rectangle outline (reference
    `cropNsavePanorama.m showCropBoundingBox` / `inputs.m:122`).

    rect = (r0, r1, c0, c1) half-open. Returns a copy."""
    out = pano.copy()
    if out.dtype != np.uint8:
        color = tuple(c / 255.0 for c in color)
    r0, r1, c0, c1 = rect
    r0 = max(r0, 0)
    c0 = max(c0, 0)
    r1 = min(r1, out.shape[0])
    c1 = min(c1, out.shape[1])
    out[r0 : min(r0 + width, r1), c0:c1] = color
    out[max(r1 - width, r0) : r1, c0:c1] = color
    out[r0:r1, c0 : min(c0 + width, c1)] = color
    out[r0:r1, max(c1 - width, c0) : c1] = color
    return out


def crop_bbox(pano: np.ndarray, mask: np.ndarray):
    """Tight bounding box crop (reference cropNonzeroBbox).

    Returns (cropped, (r0, r1, c0, c1))."""
    rows = np.nonzero(mask.any(axis=1))[0]
    cols = np.nonzero(mask.any(axis=0))[0]
    if len(rows) == 0 or len(cols) == 0:
        return pano, (0, pano.shape[0], 0, pano.shape[1])
    r0, r1 = int(rows[0]), int(rows[-1]) + 1
    c0, c1 = int(cols[0]), int(cols[-1]) + 1
    return pano[r0:r1, c0:c1], (r0, r1, c0, c1)


def _max_rect_histogram(heights: np.ndarray):
    """Largest rectangle under a histogram via monotonic stack.
    Returns (area, left, right_exclusive, height)."""
    stack: list[int] = []
    best = (0, 0, 0, 0)
    n = len(heights)
    for i in range(n + 1):
        h = heights[i] if i < n else 0
        start = i
        while stack and heights[stack[-1]] >= h:
            top = stack.pop()
            left = stack[-1] + 1 if stack else 0
            area = int(heights[top]) * (i - left)
            if area > best[0]:
                best = (area, left, i, int(heights[top]))
            start = left
        stack.append(i)
    return best


def largest_inscribed_rect(mask: np.ndarray):
    """Largest all-valid axis-aligned rectangle (reference
    `panoramaCropper.m:96-157`). Returns (r0, r1, c0, c1) or None.

    O(H*W) per-row histogram sweep. The native C++ host path
    (`autopanostitch_tpu_torch.native.max_rectangle`) is used where g++
    builds it; this numpy/python form is the path without it and the
    reference implementation for tests.
    """
    try:
        from autopanostitch_tpu_torch.native import max_rectangle as _native

        return _native(mask)
    except (OSError, subprocess.SubprocessError):  # no g++ or no loadable library
        pass
    H, W = mask.shape
    heights = np.zeros(W, np.int64)
    best = (0, 0, 0, 0, 0)  # area, r1, left, right, height
    for r in range(H):
        heights = np.where(mask[r], heights + 1, 0)
        area, left, right, h = _max_rect_histogram(heights)
        if area > best[0]:
            best = (area, r + 1, left, right, h)
    area, r1, c0, c1, h = best
    if area == 0:
        return None
    return (r1 - h, r1, c0, c1)


def crop_panorama(pano: np.ndarray, mask: np.ndarray):
    """Crop to the largest inscribed valid rectangle; falls back to the
    uncropped panorama on failure (reference `panoramaCropper.m:160-165`)."""
    rect = largest_inscribed_rect(mask)
    if rect is None:
        return pano, None
    r0, r1, c0, c1 = rect
    return pano[r0:r1, c0:c1], rect
