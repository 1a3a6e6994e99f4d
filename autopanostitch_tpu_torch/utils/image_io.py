"""Image loading & resizing (host-side, numpy/PIL).

TPU-native equivalent of `imageProcessing/loadImages.m` and
`resizeImagesToLimits.m`: EXIF auto-rotation, gray->RGB promotion, aspect
preserving 'fit' resize into the (height_limit, width_limit) box, and
stage-2 padding of the whole set to one common static shape so the stack is
a single (N, H, W, 3) tensor for vmapped feature extraction.

Unlike the reference (which UPSCALES all images to the common max size,
`resizeImagesToLimits.m:44-107`), we pad with zeros and carry per-image
valid sizes — cheaper, and the static shape is what TPU wants.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image, ImageOps

    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


@dataclasses.dataclass
class ImageSet:
    """A loaded dataset: one padded stack + per-image metadata.

    images may be uint8 (preferred: 4x cheaper host->device upload) or
    float32 in [0, 1]; the pipeline converts on device.

    originals (optional) keeps the pre-resize full-resolution images so the
    per-component second matching pass can re-resize and re-extract
    (reference `imageMatchingPanoramaConComps.m:48-78`); paths allows lazy
    reloading instead when memory matters."""

    images: np.ndarray  # (N, H, W, 3) uint8 or float32 [0,1], zero-padded
    sizes: np.ndarray  # (N, 2) int32 valid (h, w) per image
    names: List[str]
    originals: list | None = None  # [N] full-res (h, w, 3) float32 arrays
    paths: List[str] | None = None  # source files (lazy reload fallback)

    @property
    def n(self) -> int:
        return self.images.shape[0]

    def original(self, k: int) -> np.ndarray | None:
        """Full-resolution image k, from memory or lazily from disk."""
        if self.originals is not None:
            return self.originals[k]
        if self.paths is not None:
            return load_image(self.paths[k])
        return None


def load_image(path: str) -> np.ndarray:
    """Read one image with EXIF auto-rotation (reference `imreadAutoRotate`,
    `loadImages.m:183-219`) and gray->RGB promotion (`loadImages.m:103-124`).
    Returns (H, W, 3) float32 in [0, 1]."""
    if not _HAS_PIL:
        raise RuntimeError("PIL is required for image loading")
    im = Image.open(path)
    im = ImageOps.exif_transpose(im)
    im = im.convert("RGB")
    return np.asarray(im, np.float32) / 255.0


def resize_fit(img: np.ndarray, height_limit: int, width_limit: int) -> np.ndarray:
    """Aspect-preserving resize into the box (the reference's 'fit' mode,
    `resizeImagesToLimits.m:49-68`). Never upscales."""
    h, w = img.shape[:2]
    scale = min(height_limit / h, width_limit / w, 1.0)
    if scale >= 1.0:
        return img
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    im = im.resize((nw, nh), Image.LANCZOS)
    return np.asarray(im, np.float32) / 255.0


def resize_pad(img: np.ndarray, height_limit: int, width_limit: int) -> np.ndarray:
    """'pad' mode (`resizeImagesToLimits.m`): fit-resize then zero-pad to the
    exact box."""
    im = resize_fit(img, height_limit, width_limit)
    out = np.zeros((height_limit, width_limit, 3), np.float32)
    out[: im.shape[0], : im.shape[1]] = im
    return out


def resize_fillcrop(img: np.ndarray, height_limit: int, width_limit: int) -> np.ndarray:
    """'fillcrop' mode (`resizeImagesToLimits.m`): scale so the box is fully
    covered, then center-crop to it."""
    h, w = img.shape[:2]
    scale = max(height_limit / h, width_limit / w)
    nh, nw = max(height_limit, round(h * scale)), max(width_limit, round(w * scale))
    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    im = np.asarray(im.resize((nw, nh), Image.LANCZOS), np.float32) / 255.0
    y0 = (nh - height_limit) // 2
    x0 = (nw - width_limit) // 2
    return im[y0 : y0 + height_limit, x0 : x0 + width_limit]


_RESIZE_MODES = {"fit": resize_fit, "pad": resize_pad, "fillcrop": resize_fillcrop}


def _pad_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w, 3), np.uint8)
    out[: img.shape[0], : img.shape[1]] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return out


def load_image_set(
    paths: Sequence[str],
    height_limit: int = 800,
    width_limit: int = 800,
    pad_multiple: int = 32,
    mode: str = "fit",
    keep_originals: bool = False,
) -> ImageSet:
    """Load, EXIF-rotate, resize ('fit' | 'pad' | 'fillcrop', reference
    `resizeImagesToLimits.m`) and zero-pad a set of images into one
    static-shape stack (reference: `loadImages.m:56-80`).

    pad_multiple rounds the common shape up so a handful of datasets share
    one compiled executable shape. keep_originals retains the pre-resize
    images for the per-component second matching pass.
    """
    originals = [load_image(p) for p in paths]
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    return image_set_from_arrays(
        originals, height_limit, width_limit, pad_multiple=pad_multiple,
        mode=mode, names=names,
        keep_originals=keep_originals, paths=list(paths),
    )


def image_set_from_arrays(
    originals: Sequence[np.ndarray],
    height_limit: int = 800,
    width_limit: int = 800,
    pad_multiple: int = 32,
    mode: str = "fit",
    names: Optional[Sequence[str]] = None,
    keep_originals: bool = False,
    paths: Optional[Sequence[str]] = None,
) -> ImageSet:
    """Build an ImageSet from in-memory images (HxWx3 float [0,1] or uint8);
    same resize/pad semantics as :func:`load_image_set`."""
    resize = _RESIZE_MODES[mode]
    originals = [
        im.astype(np.float32) / 255.0 if im.dtype == np.uint8 else im
        for im in originals
    ]
    imgs = [resize(im, height_limit, width_limit) for im in originals]
    sizes = np.array([im.shape[:2] for im in imgs], np.int32)
    H = int(np.ceil(sizes[:, 0].max() / pad_multiple) * pad_multiple)
    W = int(np.ceil(sizes[:, 1].max() / pad_multiple) * pad_multiple)
    stack = np.stack([_pad_to(im, H, W) for im in imgs])
    if names is None:
        names = [f"img_{k:03d}" for k in range(len(imgs))]
    return ImageSet(
        images=stack,
        sizes=sizes,
        names=list(names),
        originals=list(originals) if keep_originals else None,
        paths=list(paths) if paths is not None else None,
    )


def list_dataset(folder: str) -> List[str]:
    """Image files in a dataset folder, sorted (reference `imageDatastore`)."""
    out = [
        os.path.join(folder, f)
        for f in sorted(os.listdir(folder))
        if f.lower().endswith(IMAGE_EXTENSIONS)
    ]
    return out


def save_image(path: str, img: np.ndarray) -> None:
    """Write a float [0,1] or uint8 RGB image as PNG (reference
    `cropNsavePanorama.m:121-208`)."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img).save(path)
