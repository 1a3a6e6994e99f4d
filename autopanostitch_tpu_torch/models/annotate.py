"""Panorama annotations: per-image warped boundary polygons + index labels
(port of `models/annotate.py`).

Host-side equivalent of the reference's debugging annotations
(`renderPanorama.m allWarpedBoxes :1148-1280`, `brightColors :502-517`,
insertShape/insertText drawing `:437-477`), toggled by
`showPanoramaImgsNums` / `showCropBoundingBox` (`inputs.m:121-122`). The
boundary rays go through the port's own projections on the CPU (a few
hundred points an image); the drawing is PIL on numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from autopanostitch_tpu_torch.ops import geometry as geo
from autopanostitch_tpu_torch.ops import projections as proj


def bright_colors(n: int, seed: int = 0) -> np.ndarray:
    """N vivid RGB colors (uint8), reference `brightColors`."""
    r = np.random.default_rng(seed)
    c = r.uniform(size=(n, 3))
    c /= np.maximum(c.max(axis=1, keepdims=True), 1e-6)
    return (255 * c).astype(np.uint8)


def warped_boxes_rotational(canvas: dict, R: np.ndarray, K: np.ndarray,
                            sizes: np.ndarray, n_boundary: int = 64,
                            k1: np.ndarray | None = None):
    """Project each image's boundary onto the panorama surface.

    Returns list of (n_pts, 2) float arrays in canvas pixel coords (NaN
    where invalid) plus (N, 2) centers."""
    mode = canvas["mode"]
    f_pan, x0, y0 = canvas["f_pan"], canvas["x0"], canvas["y0"]
    R_ref = torch.as_tensor(np.asarray(canvas["R_ref"], np.float32))
    boxes, centers = [], []
    for k in range(len(sizes)):
        h, w = int(sizes[k][0]), int(sizes[k][1])
        t = np.linspace(0, 1, n_boundary)
        xs = t * (w - 1)
        ys = t * (h - 1)
        bx = np.concatenate([xs, np.full_like(ys, w - 1.0), xs[::-1], np.zeros_like(ys)])
        by = np.concatenate([np.zeros_like(xs), ys, np.full_like(xs, h - 1.0), ys[::-1]])
        d = proj.camera_pixel_rays(
            geo.invert_K(torch.as_tensor(np.asarray(K[k], np.float32))),
            torch.as_tensor(np.asarray(R[k], np.float32)),
            torch.as_tensor(bx, dtype=torch.float32), torch.as_tensor(by, dtype=torch.float32),
            k1=None if k1 is None else float(k1[k]),
            cx=float(K[k][0, 2]), cy=float(K[k][1, 2]),
        )
        d = proj.normalize_rays(d)
        u, v, valid = proj.ray_to_pano(mode, d, R_ref)
        px = (u.numpy() - x0) * f_pan
        py = (v.numpy() - y0) * f_pan
        ok = valid.numpy()
        px[~ok] = np.nan
        py[~ok] = np.nan
        boxes.append(np.stack([px, py], -1))
        centers.append(np.nanmedian(np.stack([px, py], -1), axis=0))
    return boxes, np.stack(centers)


def warped_boxes_planar(H_abs: np.ndarray, sizes: np.ndarray, offset, scale: float,
                        n_boundary: int = 64):
    """Boundary polygons for the planar path (through absolute homographies)."""
    x0, y0 = offset
    boxes, centers = [], []
    for k in range(len(sizes)):
        h, w = int(sizes[k][0]), int(sizes[k][1])
        t = np.linspace(0, 1, n_boundary)
        xs = t * (w - 1)
        ys = t * (h - 1)
        bx = np.concatenate([xs, np.full_like(ys, w - 1.0), xs[::-1], np.zeros_like(ys)])
        by = np.concatenate([np.zeros_like(xs), ys, np.full_like(xs, h - 1.0), ys[::-1]])
        ph = np.stack([bx, by, np.ones_like(bx)], -1) @ H_abs[k].T
        z = ph[:, 2]
        ok = np.abs(z) > 1e-9
        px = np.where(ok, ph[:, 0] / np.where(ok, z, 1), np.nan) * scale - x0
        py = np.where(ok, ph[:, 1] / np.where(ok, z, 1), np.nan) * scale - y0
        boxes.append(np.stack([px, py], -1))
        centers.append(np.nanmedian(np.stack([px, py], -1), axis=0))
    return boxes, np.stack(centers)


def _to_pil(img: np.ndarray):
    from PIL import Image

    return Image.fromarray(img if img.dtype == np.uint8 else
                           (np.clip(img, 0, 1) * 255).astype(np.uint8))


def draw_keypoints(image: np.ndarray, xy: np.ndarray, mask: np.ndarray,
                   scale: np.ndarray | None = None) -> np.ndarray:
    """Keypoint overlay (reference `showKeypointsPlot`, `inputs.m:119`):
    a circle per keypoint, radius = detected scale when given."""
    from PIL import ImageDraw

    img = _to_pil(image)
    draw = ImageDraw.Draw(img)
    xy = np.asarray(xy)[np.asarray(mask)]
    r = (3.0 * np.asarray(scale)[np.asarray(mask)]
         if scale is not None else np.full(len(xy), 3.0))
    for (x, y), rad in zip(xy, r):
        rad = float(min(max(rad, 2.0), 40.0))
        draw.ellipse([x - rad, y - rad, x + rad, y + rad],
                     outline=(0, 255, 0), width=1)
    return np.asarray(img)


def draw_matches(img_i: np.ndarray, img_j: np.ndarray, xy_i: np.ndarray,
                 xy_j: np.ndarray, inlier: np.ndarray | None = None) -> np.ndarray:
    """Side-by-side correspondence plot (reference `showMatchedFeatures`
    montage in `imageMatching.m:257-270`): inliers green, outliers red."""
    from PIL import ImageDraw

    a, b = _to_pil(img_i), _to_pil(img_j)
    H = max(a.height, b.height)
    canvas = np.zeros((H, a.width + b.width, 3), np.uint8)
    canvas[: a.height, : a.width] = np.asarray(a)
    canvas[: b.height, a.width :] = np.asarray(b)
    img = _to_pil(canvas)
    draw = ImageDraw.Draw(img)
    xy_i = np.asarray(xy_i)
    xy_j = np.asarray(xy_j) + np.array([a.width, 0.0])
    if inlier is None:
        inlier = np.ones(len(xy_i), bool)
    for (p, q, ok) in zip(xy_i, xy_j, np.asarray(inlier)):
        color = (0, 220, 0) if ok else (230, 40, 40)
        draw.line([tuple(p), tuple(q)], fill=color, width=1)
        draw.ellipse([p[0] - 2, p[1] - 2, p[0] + 2, p[1] + 2], outline=color)
        draw.ellipse([q[0] - 2, q[1] - 2, q[0] + 2, q[1] + 2], outline=color)
    return np.asarray(img)


def draw_adjacency_graph(pairs: np.ndarray, accepted: np.ndarray,
                         num_inliers: np.ndarray, n_images: int,
                         components: np.ndarray | None = None,
                         size: int = 640) -> np.ndarray:
    """Image-match adjacency graph plot (reference `recognizePanoramas.m
    showAdjacencyGraph :180-237`): nodes on a circle colored by panorama
    component, accepted edges weighted by inlier count."""
    from PIL import ImageDraw

    img = _to_pil(np.full((size, size, 3), 255, np.uint8))
    draw = ImageDraw.Draw(img)
    cx = cy = size / 2.0
    rad = size * 0.42
    ang = 2 * np.pi * np.arange(n_images) / max(n_images, 1)
    px = cx + rad * np.cos(ang)
    py = cy + rad * np.sin(ang)
    if components is None:
        components = np.zeros(n_images, np.int64)
    comp_ids = {c: k for k, c in enumerate(np.unique(components))}
    colors = bright_colors(len(comp_ids), seed=3)
    wmax = max(int(np.max(num_inliers[accepted])) if np.any(accepted) else 1, 1)
    for p, (i, j) in enumerate(np.asarray(pairs)):
        if not accepted[p]:
            continue
        w = 1 + int(4 * num_inliers[p] / wmax)
        draw.line([(px[i], py[i]), (px[j], py[j])], fill=(120, 120, 120), width=w)
    r = max(size // 80, 4)
    for k in range(n_images):
        c = tuple(int(v) for v in colors[comp_ids[int(components[k])]])
        draw.ellipse([px[k] - r, py[k] - r, px[k] + r, py[k] + r],
                     fill=c, outline=(0, 0, 0))
        draw.text((px[k] + r + 2, py[k] - r), str(k), fill=(0, 0, 0))
    return np.asarray(img)


def draw_annotations(pano: np.ndarray, boxes, centers, labels=None, crop_rect=None):
    """Draw polygons + labels (+ crop box) on a uint8 panorama copy."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(pano if pano.dtype == np.uint8 else
                          (np.clip(pano, 0, 1) * 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    colors = bright_colors(len(boxes))
    for k, box in enumerate(boxes):
        pts = box[np.isfinite(box).all(axis=1)]
        if len(pts) < 3:
            continue
        draw.line([tuple(p) for p in pts] + [tuple(pts[0])],
                  fill=tuple(int(c) for c in colors[k]), width=2)
        if np.isfinite(centers[k]).all():
            label = str(labels[k]) if labels is not None else str(k)
            draw.text(tuple(centers[k]), label, fill=(255, 255, 255))
    if crop_rect is not None:
        r0, r1, c0, c1 = crop_rect
        draw.rectangle([c0, r0, c1 - 1, r1 - 1], outline=(255, 0, 0), width=2)
    return np.asarray(img)
