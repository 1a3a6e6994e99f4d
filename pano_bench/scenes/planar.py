"""Folders of a planar scan: a grid of crops of `synth.texture` that
overlap by a share of their size in each direction
(`chip_smoke.planar_scene`), each folder with its own texture.

Traffic keys: content_seed, rows, cols, width, height, overlap."""

from __future__ import annotations

import numpy as np
import torch

from pano_bench.scenes import Folder, folder_rng, stitch_seed, synth


def make(traffic: dict, seed: int, index: int, device) -> Folder:
    from autopanostitch_tpu_torch.api import ImageSet

    rng = folder_rng(traffic["content_seed"], index)
    rows, cols = int(traffic["rows"]), int(traffic["cols"])
    w, h, overlap = int(traffic["width"]), int(traffic["height"]), float(traffic["overlap"])
    tex = int(rng.integers(0, 2**31))
    sx, sy = round(w * (1 - overlap)), round(h * (1 - overlap))
    env = synth.texture(tex, h + (rows - 1) * sy, w + (cols - 1) * sx)
    offs = np.array([(c * sx, r * sy) for r in range(rows) for c in range(cols)], np.float64)
    views = [env[int(y):int(y) + h, int(x):int(x) + w] for x, y in offs]
    stack = (np.stack(views) * 255 + 0.5).astype(np.uint8)
    sizes = np.tile(np.array([h, w], np.int32), (len(views), 1))
    iset = ImageSet(images=stack, sizes=sizes, names=[f"p{k:03d}" for k in range(len(views))])
    truth = {"kind": "planar", "env": torch.as_tensor(env, device=device), "offsets": offs,
             "width": w, "height": h, "views": len(views)}
    return Folder(iset=iset, stitch_seed=stitch_seed(seed, index), truth=truth)
