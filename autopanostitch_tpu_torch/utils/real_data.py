"""Real-photograph datasets recovered from the reference's sample sheets
(the port's own copy of the JAX package's `utils/real_data.py`).

The reference repository ships contact sheets of its benchmark capture sets
(`assets/dataset_samples_*.png`, referenced from the reference README's
dataset table): each sheet is a rows x cols montage of real photographs from
one capture rig — CMU0 (yaw ring), Grand Canyon / Yellowstone (multi-row
rigs), Rio / Shanghai (wide rings, grayscale), UCSB4. Slicing the montage
grid recovers genuine multi-view photo sets with real exposure variation,
parallax, JPEG noise and moving subjects — the evidence base the synthetic
environments cannot provide.

Unfilled montage slots are blank (white) and are trimmed automatically.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from autopanostitch_tpu_torch.utils import image_io

REFERENCE_ASSETS = "/root/reference/assets"

# sheet -> (rows, cols); tile counts are recovered by blank-slot trimming
MONTAGES: Dict[str, Tuple[int, int]] = {
    "CMU0": (8, 5),
    "grandcanyon": (7, 5),
    "rio": (12, 5),
    "shanghai": (6, 5),
    "ucsb4": (3, 5),
    "yellowstone": (5, 5),
}


def montage_path(name: str, assets_dir: str = REFERENCE_ASSETS) -> str:
    return os.path.join(assets_dir, f"dataset_samples_{name}.png")


def have_reference_assets(assets_dir: str = REFERENCE_ASSETS) -> bool:
    return os.path.isdir(assets_dir) and os.path.exists(montage_path("CMU0", assets_dir))


def load_montage_tiles(
    name: str,
    assets_dir: str = REFERENCE_ASSETS,
    trim_blank: bool = True,
) -> List[np.ndarray]:
    """Slice a dataset sample sheet into its member photographs.

    Returns a list of HxWx3 uint8 arrays in sheet order (row-major, the
    capture order the reference sheets use). Blank filler slots (white,
    near-zero variance) are dropped when `trim_blank`.
    """
    from PIL import Image

    rows, cols = MONTAGES[name]
    im = np.asarray(Image.open(montage_path(name, assets_dir)).convert("RGB"))
    H, W, _ = im.shape
    ys = np.linspace(0, H, rows + 1).round().astype(int)
    xs = np.linspace(0, W, cols + 1).round().astype(int)
    tiles = []
    for r in range(rows):
        for c in range(cols):
            t = im[ys[r] : ys[r + 1], xs[c] : xs[c + 1]]
            # Unfilled white slot. The mean test also drops slots that are
            # blank except for a sliver of a neighbouring photo bleeding
            # across the grid line (rio/yellowstone each have one at mean
            # ~254; every real photograph across all six sheets is < 200).
            if trim_blank and t.mean() > 240:
                continue
            tiles.append(t)
    return tiles


def church_paths(assets_dir: str = REFERENCE_ASSETS) -> List[str]:
    """The three overlapping church renderings shipped by the reference
    (`assets/church_01..03.jpeg`) — real photographic content with exposure
    differences and drawn annotations; they overlap and stitch into one
    panorama."""
    return [os.path.join(assets_dir, f"church_0{i}.jpeg") for i in (1, 2, 3)]


def image_set_from_arrays(tiles: List[np.ndarray], height_limit: int, width_limit: int):
    """Build an :class:`ImageSet` from in-memory photographs (same fit/pad
    semantics as `load_image_set`, reference `loadImages.m` + resize rules)."""
    return image_io.image_set_from_arrays(tiles, height_limit, width_limit)
