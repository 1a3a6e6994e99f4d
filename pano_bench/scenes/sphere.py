"""Folders of a full 360x180 sphere of pinhole views, shot from a level
panoramic head in rows of fixed pitch, zenith and nadir included: what a
virtual-tour photographer hands over for an equirectangular export.

The rig is `rows`, a list of [pitch_deg, views] (pitch positive up, roll 0);
a row's views are spaced evenly in yaw from an offset drawn from the
folder's content seed. Every view is rendered with `synth.render_pinhole`
from one environment.

The environment's texture is defined on the sphere, not in equirectangular
pixels: each colour channel is

    t_c(d) = sum_k cos(2 pi w_ck . d + p_ck),   k = 1 .. WAVES,

a sum of WAVES plane waves of 3-D space evaluated along the unit direction
d, with p_ck uniform in [0, 2 pi), w_ck in a uniform direction and |w_ck| <=
focal_px / period_px (cycles per unit length), drawn so that a wave's
projection on the sphere's tangent plane falls uniformly in the disk of
that radius: at every point the texture's local spectrum is flat in a
disk, as `synth.smooth_texture`'s is. A wave's local period is at least
1 / |w| radians, so the finest detail is period_px view pixels at the
image centre wherever the view looks: the texture is band-limited on the
sphere itself, with no pole singularity (`synth.smooth_texture`,
band-limited in equirectangular pixels, is far finer near the poles than
at the equator). period_px = 23 at focal_px = 1000 is a finest period of
1.3 degrees, as the rings' cutoff of 0.08 cycles a pixel of a 2048-wide
environment is 23 px at f = 600. The texture is rasterised into the equirectangular `env` (h, w, 3) that
`synth.env_lookup` samples, the views and the reference alike, each
channel scaled to [0, 1] by its least and largest values.

Traffic keys: content_seed, rows, width, height, focal_px, env ([h, w]),
period_px. The views are handed over as they are, uint8."""

from __future__ import annotations

import numpy as np
import torch

from pano_bench.scenes import Folder, folder_rng, stitch_seed, synth

WAVES = 1024  # plane waves a channel
_CHUNK = 1 << 25  # direction x wave products evaluated at once


def sphere_texture(seed: int, h: int, w: int, cycles: float, device="cpu") -> torch.Tensor:
    """The texture of the module's docstring, with |w| <= cycles, rasterised
    on the equirectangular grid of `synth.env_lookup` (row i at latitude
    -pi/2 + pi i / (h - 1), column j at azimuth -pi + 2 pi j / (w - 1)):
    float32 (h, w, 3) in [0, 1] on `device`, computed in float64."""
    r = np.random.default_rng(seed)
    g = r.standard_normal((3 * WAVES, 3))
    # |w| = cycles sin(a), a in [0, pi/2] with density (4 / pi) sin^2 a (its
    # CDF (2a - sin 2a) / pi inverted on a grid): a wave's projection on the
    # tangent plane then falls uniformly in the disk of radius cycles
    grid = np.linspace(0.0, np.pi / 2, 4097)
    a = np.interp(r.uniform(size=(3 * WAVES, 1)), (2 * grid - np.sin(2 * grid)) / np.pi, grid)
    freq = g / np.linalg.norm(g, axis=1, keepdims=True) * (cycles * np.sin(a))
    phase = r.uniform(0.0, 2 * np.pi, size=3 * WAVES)
    dev = torch.device(device)
    wt = torch.as_tensor(2 * np.pi * freq.T, device=dev)  # (3, 3 WAVES)
    ph = torch.as_tensor(phase, device=dev)
    lat = torch.linspace(-np.pi / 2, np.pi / 2, h, dtype=torch.float64, device=dev)
    az = torch.linspace(-np.pi, np.pi, w, dtype=torch.float64, device=dev)
    out = torch.empty((h, w, 3), dtype=torch.float64, device=dev)
    step = max(1, _CHUNK // (w * 3 * WAVES))
    for i in range(0, h, step):
        la = lat[i:i + step, None]
        d = torch.stack([torch.cos(la) * torch.sin(az), torch.sin(la).expand(-1, w),
                         torch.cos(la) * torch.cos(az)], -1)  # (rows, w, 3)
        waves = torch.cos(d @ wt + ph)  # (rows, w, 3 WAVES)
        out[i:i + step] = waves.view(*waves.shape[:2], 3, WAVES).sum(-1)
    lo = out.amin(dim=(0, 1))
    out = (out - lo) / (out.amax(dim=(0, 1)) - lo)
    return out.float()


def make(traffic: dict, seed: int, index: int, device) -> Folder:
    from autopanostitch_tpu_torch.api import ImageSet

    rng = folder_rng(traffic["content_seed"], index)
    rows = traffic["rows"]
    w, h, f = int(traffic["width"]), int(traffic["height"]), float(traffic["focal_px"])
    eh, ew = traffic["env"]
    tex = int(rng.integers(0, 2**31))
    yaw0 = rng.uniform(0.0, 2 * np.pi, size=len(rows))
    env = sphere_texture(tex, int(eh), int(ew), f / float(traffic["period_px"]), device)
    Rs = []
    for (pitch, n), off in zip(rows, yaw0):
        for i in range(int(n)):
            cam_to_world = synth.rot_y(off + i * 2 * np.pi / int(n)) @ synth.rot_x(
                np.radians(float(pitch)))
            Rs.append(cam_to_world.T)
    Rs = np.stack(Rs)
    n = len(Rs)
    u8 = (synth.render_pinhole(env, Rs, f, w, h) * 255).to(torch.uint8).cpu().numpy()
    iset = ImageSet(images=u8, sizes=np.tile(np.array([h, w], np.int32), (n, 1)),
                    names=[f"s{k:03d}" for k in range(n)])
    truth = {"kind": "rotational", "focal_px": f, "views": n,
             "rings": [{"members": np.arange(n), "env": env, "R": Rs}]}
    return Folder(iset=iset, stitch_seed=stitch_seed(seed, index), truth=truth)
