"""Folders of 360-degree yaw rings of pinhole views, interleaved, and
distractor views: `chip_smoke.ring_scene` (one ring) and
`chip_smoke.multipano_scene` (two rings and a distractor, ingested at a
smaller box with the originals kept), each folder with its own textures and
yaw offsets.

Traffic keys: content_seed, views (a ring), rings, distractors, distractor_pitch (rad),
width, height, focal_px, env ([h, w] of each environment), cutoff (the
texture's low-pass), ingest_limit (null: the views as they are, uint8)."""

from __future__ import annotations

import numpy as np
import torch

from pano_bench.scenes import Folder, folder_rng, stitch_seed, synth


def make(traffic: dict, seed: int, index: int, device) -> Folder:
    from autopanostitch_tpu_torch.api import ImageSet, image_set_from_arrays

    rng = folder_rng(traffic["content_seed"], index)
    n, n_rings = int(traffic["views"]), int(traffic.get("rings", 1))
    n_dis = int(traffic.get("distractors", 0))
    w, h, f = int(traffic["width"]), int(traffic["height"]), float(traffic["focal_px"])
    eh, ew = traffic["env"]
    cutoff = float(traffic.get("cutoff", 0.08))
    tex = rng.integers(0, 2**31, size=n_rings + n_dis)
    yaw0 = rng.uniform(0.0, 2 * np.pi / n, size=n_rings)
    views = [None] * (n * n_rings)
    rings = []
    for r in range(n_rings):
        env = synth.smooth_texture(int(tex[r]), eh, ew, cutoff, device)
        Rs = np.stack([synth.rot_y(yaw0[r] + i * 2 * np.pi / n).T for i in range(n)])
        ring = synth.render_pinhole(env, Rs, f, w, h)
        for i in range(n):
            views[i * n_rings + r] = ring[i]
        rings.append({"members": np.arange(r, n * n_rings, n_rings), "env": env, "R": Rs})
    pitch = float(traffic.get("distractor_pitch", 0.4))
    for k in range(n_dis):
        env = synth.smooth_texture(int(tex[n_rings + k]), eh, ew, cutoff, device)
        views.append(synth.render_pinhole(env, synth.rot_x(pitch).T[None], f, w, h)[0])
    stack = torch.stack(views)
    limit = traffic.get("ingest_limit")
    names = [f"v{k:03d}" for k in range(len(views))]
    if limit is None:
        u8 = (stack * 255).to(torch.uint8).cpu().numpy()
        sizes = np.tile(np.array([h, w], np.int32), (len(views), 1))
        iset = ImageSet(images=u8, sizes=sizes, names=names)
    else:
        iset = image_set_from_arrays(list(stack.cpu().numpy()), height_limit=int(limit),
                                     width_limit=int(limit), names=names, keep_originals=True)
    truth = {"kind": "rotational", "focal_px": f, "rings": rings,
             "views": len(views)}
    return Folder(iset=iset, stitch_seed=stitch_seed(seed, index), truth=truth)
