"""Rotational panorama renderer: tiled inverse-map compositing (port of
`models/render.py`), in every projection, blend and interpolation of the
reference.

Host control plane as in the reference: camera bounds on the surface
(sampled on the device), reference-camera choice and canvas sizing, and
per-tile contributor selection. The tiles render on `kernels/render.py`
(hand kernels on the card), as many a launch as the card's memory allows:
per tile, canvas pixel -> world ray -> every contributor's camera ->
sampling (nearest, bilinear, bicubic, or bilinear taps on the 2x bicubic
upsample) -> multiband (`ops/blend`), linear or none-* blend -> uint8; the
canvas is assembled on the device and copied to the host once.

The bicubic2x upsample (Keys a = -0.5, `jax.image.resize` semantics, see
`ops/sampling.py`) runs ONCE per image here, where the reference resizes
each tile's gathered contributors inside the tile kernel
(`render.py:350`). Resizing is per image, so upsampling every image once
gives the same numbers as upsampling a tile's subset each time.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from autopanostitch_tpu_torch.config import RenderConfig
from autopanostitch_tpu_torch.kernels import render as render_kernels
from autopanostitch_tpu_torch.ops import blend as blend_ops
from autopanostitch_tpu_torch.ops import geometry as geo
from autopanostitch_tpu_torch.ops import projections as proj
from autopanostitch_tpu_torch.ops import sampling as samp
from autopanostitch_tpu_torch.utils import trace


def _bounds_per_camera(R, K, sizes, mode: str, R_ref, uv_abs_cap: float, k1=None,
                       nx: int = 48, ny: int = 32, pct=(1.0, 99.0)):
    """(N, 4) [umin, umax, vmin, vmax] per camera on the surface (tensors in,
    tensor out): each camera's pixel grid pushed to the surface. Angular
    modes measure azimuth relative to each camera's centre, so seam cameras
    keep FOV-wide bounds; planar and stereographic clip to +-uv_abs_cap and
    take the pct percentiles of the valid samples (robust extents)."""
    proj.check_mode(mode)
    dev = R.device
    N = R.shape[0]
    tx = torch.linspace(0.0, 1.0, nx, device=dev)
    ty = torch.linspace(0.0, 1.0, ny, device=dev)
    gy, gx = torch.meshgrid(ty, tx, indexing="ij")
    h = sizes[:, 0].float()[:, None] - 1.0
    w = sizes[:, 1].float()[:, None] - 1.0
    xp = gx.reshape(1, -1) * w
    yp = gy.reshape(1, -1) * h
    cx = K[:, 0, 2][:, None]
    cy = K[:, 1, 2][:, None]
    k1a = torch.zeros((N, 1), device=dev) if k1 is None else k1[:, None]
    d = proj.normalize_rays(proj.camera_pixel_rays(geo.invert_K(K), R, xp, yp, k1a, cx, cy))
    u, v, valid = proj.ray_to_pano(mode, d, R_ref)
    if mode in proj.REF_FRAME:
        nan = torch.full_like(u, float("nan"))
        un = torch.where(valid, torch.clamp(u, -uv_abs_cap, uv_abs_cap), nan)
        vn = torch.where(valid, torch.clamp(v, -uv_abs_cap, uv_abs_cap), nan)
        q = torch.tensor([pct[0] / 100.0, pct[1] / 100.0], device=dev)
        bu = torch.nanquantile(un, q, dim=1)  # (2, N)
        bv = torch.nanquantile(vn, q, dim=1)
        return torch.stack([bu[0], bu[1], bv[0], bv[1]], -1)
    big = torch.full_like(u, 1e9)
    fwd = proj.normalize_rays(R[:, 2, :])
    u_cen, _, _ = proj.ray_to_pano(mode, fwd, R_ref)
    du = torch.remainder(u - u_cen[:, None] + np.pi, 2 * np.pi) - np.pi
    return torch.stack([u_cen + torch.where(valid, du, big).min(1).values,
                        u_cen + torch.where(valid, du, -big).max(1).values,
                        torch.where(valid, v, big).min(1).values,
                        torch.where(valid, v, -big).max(1).values], -1)


def _auto_ref_areas(R, K, sizes, mode: str, uv_abs_cap: float, k1=None, pct=(1.0, 99.0)):
    """(N,) canvas area du * dv with camera n as the reference frame (the
    reference's autoRef search, `renderPanorama.m:84-122`)."""
    areas = []
    for n in range(R.shape[0]):
        b = _bounds_per_camera(R, K, sizes, mode, R[n], uv_abs_cap, k1=k1, pct=pct)
        areas.append((b[:, 1].max() - b[:, 0].min()) * (b[:, 3].max() - b[:, 2].min()))
    return torch.stack(areas)


def _memory_fit_pixels(device, margin_bytes: float = 256e6, frac: float = 0.8):
    """Canvas pixels that fit the device's free memory (None = the CPU)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return max(1e6, (free - margin_bytes) * frac / 4.0)


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _camera_bounds(R, K, sizes, mode, R_ref, uv_abs_cap, k1, pct, dev):
    return _bounds_per_camera(_t(R, dev), _t(K, dev), _t(sizes, dev, torch.int32), mode,
                              _t(R_ref, dev), uv_abs_cap,
                              k1=None if k1 is None else _t(k1, dev), pct=pct).cpu().numpy()


def compute_canvas(R, K, sizes, mode: str, cfg: RenderConfig = RenderConfig(),
                   ref_idx: int | None = None, k1=None, device=None):
    """Canvas geometry dict(f_pan, x0, y0, Hc, Wc, R_ref, ref_idx, mode,
    uv_abs_cap) (`renderPanorama.m:84-232`); R/K/sizes/k1 numpy. Planar and
    stereographic pick the reference camera that minimises the canvas area
    when cfg.auto_ref and ref_idx is None."""
    proj.check_mode(mode)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    R = np.asarray(R, np.float32)
    K = np.asarray(K, np.float32)
    pct = tuple(cfg.robust_pct)
    if mode in proj.REF_FRAME and cfg.auto_ref and ref_idx is None:
        areas = _auto_ref_areas(_t(R, dev), _t(K, dev), _t(sizes, dev, torch.int32), mode,
                                cfg.uv_abs_cap, None if k1 is None else _t(k1, dev),
                                pct).cpu().numpy()
        areas = np.where(np.isfinite(areas), areas, np.inf)
        ref_idx = int(np.argmin(areas)) if np.isfinite(areas).any() else 0
    if ref_idx is None:
        ref_idx = 0
    R_ref = R[ref_idx]
    f_pan = float(K[ref_idx][0, 0])
    b = _camera_bounds(R, K, sizes, mode, R_ref, cfg.uv_abs_cap, k1, pct, dev)
    u0, u1 = float(b[:, 0].min()), float(b[:, 1].max())
    v0, v1 = float(b[:, 2].min()), float(b[:, 3].max())
    if mode in proj.ANGULAR and u1 - u0 > 2 * np.pi:
        u0, u1 = -np.pi, np.pi
    if mode == "equirectangular":
        u0, u1 = max(u0, -np.pi), min(u1, np.pi)
        v0, v1 = max(v0, -np.pi / 2), min(v1, np.pi / 2)
    du, dv = u1 - u0, v1 - v0
    u0 -= cfg.margin * du
    u1 += cfg.margin * du
    v0 -= cfg.margin * dv
    v1 += cfg.margin * dv
    if mode == "stereographic":
        ext = max(abs(u0), abs(u1), abs(v0), abs(v1))
        u0, u1, v0, v1 = -ext, ext, -ext, ext
    if mode in proj.REF_FRAME:
        u0 -= cfg.pixel_pad / f_pan
        u1 += cfg.pixel_pad / f_pan
        v0 -= cfg.pixel_pad / f_pan
        v1 += cfg.pixel_pad / f_pan
    scale = 1.0
    Wc = max(1, int(np.ceil(f_pan * (u1 - u0))))
    Hc = max(1, int(np.ceil(f_pan * (v1 - v0))))
    cap = cfg.max_megapixel * 1e6
    mem_px = _memory_fit_pixels(dev)
    if mem_px is not None and mem_px < cap:
        warnings.warn(f"render: device memory limits the canvas to ~{mem_px / 1e6:.0f} MPix "
                      f"(configured cap {cfg.max_megapixel} MPix); downscaling", RuntimeWarning)
        cap = mem_px
    if Hc * Wc > cap:
        scale = float(np.sqrt(cap / (Hc * Wc)))
        Wc = max(1, int(np.ceil(Wc * scale)))
        Hc = max(1, int(np.ceil(Hc * scale)))
    return {
        "mode": mode, "f_pan": f_pan * scale, "x0": u0, "y0": v0, "Hc": Hc, "Wc": Wc,
        "R_ref": R_ref.astype(np.float32), "ref_idx": int(ref_idx),
        "uv_abs_cap": float(cfg.uv_abs_cap),
    }


def tile_contributors(canvas: dict, R, K, sizes, tile: tuple,
                      max_contributors: int | None = None, k1=None, device=None):
    """For every tile, the <= C images whose projected bounds intersect it
    (wrap-around aware); C sized automatically when max_contributors is
    None. Returns (sel (T, C) int32, sel_ok (T, C) bool, origins (T, 2))."""
    mode = canvas["mode"]
    Hc, Wc = canvas["Hc"], canvas["Wc"]
    th, tw = tile
    f_pan, x0, y0 = canvas["f_pan"], canvas["x0"], canvas["y0"]
    dev = torch.device(device) if device is not None else torch.device("cpu")
    b = _camera_bounds(R, K, sizes, mode, canvas["R_ref"], float(canvas.get("uv_abs_cap", 8.0)),
                       k1, (1.0, 99.0), dev)
    px = (b[:, :2] - x0) * f_pan
    py = (b[:, 2:] - y0) * f_pan

    r0s = np.arange(0, Hc, th, dtype=np.float64)
    c0s = np.arange(0, Wc, tw, dtype=np.float64)
    R0, C0 = np.meshgrid(r0s, c0s, indexing="ij")
    origins = np.stack([C0.ravel(), R0.ravel()], -1)
    wrap = 2 * np.pi * f_pan
    shifts = np.array([0.0, wrap, -wrap] if mode in proj.ANGULAR else [0.0])
    tx0 = origins[:, 0][:, None, None]
    ty0 = origins[:, 1][:, None, None]

    def seg_overlap(seg_x0, seg_w, seg_y0, seg_h):
        ox = np.minimum(px[None, :, 1, None] + shifts, seg_x0 + seg_w) - np.maximum(
            px[None, :, 0, None] + shifts, seg_x0)
        oy_s = np.minimum(py[None, :, 1, None], seg_y0 + seg_h) - np.maximum(
            py[None, :, 0, None], seg_y0)
        return (np.clip(ox, 0, None) * np.clip(oy_s, 0, None)).max(-1)

    areas = seg_overlap(tx0, tw, ty0, th)
    if max_contributors is None:
        fine = []
        fw, fh = tw / 4.0, th / 4.0
        for r in range(4):
            for c in range(4):
                o = seg_overlap(tx0 + c * fw, fw, ty0 + r * fh, fh)
                fine.append(np.where(o.max(1) > 0, np.argmax(o, 1), -1))
        fine = np.stack(fine, axis=1)
        need = max(int(len(set(row[row >= 0].tolist()))) for row in fine) if fine.size else 4
        wm = float(np.median(px[:, 1] - px[:, 0]))
        hm = float(np.median(py[:, 1] - py[:, 0]))
        need_h = int(np.ceil(tw / max(wm * 0.5, 1.0)))
        need_v = int(np.ceil(th / max(hm * 0.5, 1.0)))
        need = int(np.clip(max(need, need_h * need_v), 4, 16))
        max_contributors = next(c for c in (4, 6, 8, 12, 16) if c >= need)
    C = max_contributors
    sr = int(np.clip(round(np.sqrt(C * th / tw)), 1, C))
    while C % sr:
        sr -= 1
    sc = C // sr
    seg_w = tw / sc
    seg_h = th / sr
    seg_ov = [seg_overlap(tx0 + c * seg_w, seg_w, ty0 + r * seg_h, seg_h)
              for r in range(sr) for c in range(sc)]
    seg_best = np.stack([np.argmax(o, axis=1) for o in seg_ov], axis=1)
    seg_area = np.stack([o.max(axis=1) for o in seg_ov], axis=1)
    rank = np.argsort(-areas, axis=1)
    T = origins.shape[0]
    sel = np.zeros((T, C), np.int64)
    ok = np.zeros((T, C), bool)
    for t in range(T):
        chosen = []
        for s in range(C):
            cand = int(seg_best[t, s])
            if seg_area[t, s] > 0 and cand not in chosen:
                chosen.append(cand)
        for cand in rank[t]:
            if len(chosen) >= C:
                break
            cand = int(cand)
            if areas[t, cand] > 0 and cand not in chosen:
                chosen.append(cand)
        sel[t, : len(chosen)] = chosen
        ok[t, : len(chosen)] = True
    return sel.astype(np.int32), ok, origins.astype(np.float32)


BLENDS = tuple(render_kernels.BLENDS)
INTERPS = tuple(render_kernels.INTERPS)
_PLAIN_TILES_PER_BATCH = 8  # the CPU's batch: the plain versions' temporaries are large


def render_rotational(images, feathers, R, K, canvas: dict, gains=None,
                      blend_mode: str = "multiband", bands: int = 3, tile: tuple = (512, 512),
                      angle_power: float = 1.0, sizes=None, max_contributors=None,
                      interp: str = "bicubic2x", k1=None, tiles_per_batch: int | None = None):
    """Full rotational panorama: (panorama (Hc, Wc, 3) uint8, coverage (Hc,
    Wc) bool) numpy. images (N, H, W, 3) / feathers (N, H, W) tensors; R, K,
    gains, sizes, k1 numpy. blend_mode one of BLENDS, interp one of INTERPS.
    The canvas is assembled on the images' device and copied to the host
    once (`render_tile_list` for tiles_per_batch).

    The feather rides as a 4th channel so it shares the colour taps. With
    bicubic2x the 2x Keys upsample runs once per image here, where the
    reference resizes each tile's gathered contributors inside the tile
    kernel (`render.py:350`); resizing is per image, so the numbers are the
    same."""
    if blend_mode not in BLENDS:
        raise ValueError(f"unknown blend {blend_mode!r}; one of {BLENDS}")
    if interp not in INTERPS:
        raise ValueError(f"unknown interpolation {interp!r}; one of {INTERPS}")
    dev = images.device
    n = images.shape[0]
    th, tw = tile
    if gains is None:
        gains = np.ones((n, 3), np.float32)
    if sizes is None:
        sizes = np.tile(np.array(images.shape[1:3], np.int32), (n, 1))
    C_arg = None if max_contributors is None else min(max_contributors, n)
    with trace.span("render.contributors"):
        sel, sel_ok, origins = tile_contributors(canvas, R, K, sizes, (th, tw), C_arg, k1=k1,
                                                 device=dev)
    tiles, covs = render_tile_list(images, feathers, R, K, gains, k1, sel, sel_ok, origins, canvas,
                                   tile, blend_mode, bands, angle_power, interp, tiles_per_batch)
    with trace.span("render.assemble"):
        pano, cover = assemble_tiles(tiles, covs, origins, canvas["Hc"], canvas["Wc"])
        return pano.cpu().numpy(), cover.cpu().numpy()


def _tiles_per_launch(T: int, C: int, tile: tuple, blend_mode: str, device) -> int:
    """Tiles a launch: on the card as many as half its free memory holds
    (multiband's slots and pyramid, 4/3 of level 0's 16 bytes a slot and
    pixel, or the uint8 tile), on the CPU `_PLAIN_TILES_PER_BATCH`."""
    if device.type != "cuda":
        return _PLAIN_TILES_PER_BATCH
    px = tile[0] * tile[1]
    per_tile = C * px * 16 * 4 // 3 + px * 8 if blend_mode == "multiband" else px * 4
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(T, int(0.5 * (free - 256e6)) // per_tile))


def render_tile_list(images, feathers, R, K, gains, k1, sel, sel_ok, origins, canvas: dict,
                     tile: tuple, blend_mode: str, bands: int, angle_power: float, interp: str,
                     tiles_per_batch: int | None = None):
    """Render the tiles of a list (sel (T, C), sel_ok (T, C), origins (T, 2)
    numpy, as `tile_contributors` gives them): (uint8 (T, th, tw, 3),
    covered (T, th, tw)) tensors on the images' device. images (N, H, W, 3)
    / feathers (N, H, W) tensors; R, K, gains, k1 numpy. Each launch of
    `kernels.render` takes tiles_per_batch tiles (None: as many as the
    card's memory allows, `_PLAIN_TILES_PER_BATCH` on the CPU)."""
    dev = images.device
    th, tw = tile
    sel = np.asarray(sel, np.int32)
    T, C = sel.shape
    if T and (sel.min() < 0 or sel.max() >= images.shape[0]):
        raise ValueError("render_tile_list: a tile names an image outside the stack")
    with trace.span("render.upsample"):
        images4 = torch.cat([images, feathers[..., None]], dim=-1)
        fine4 = samp.upsample2x_cubic(images4) if interp == "bicubic2x" else None
    R_d, K_d, g_d = _t(R, dev), _t(K, dev), _t(gains, dev)
    k1_d = None if k1 is None else _t(k1, dev)
    sel_d, ok_d, org_d = _t(sel, dev, torch.int32), _t(sel_ok, dev, torch.bool), _t(origins, dev)
    tb = tiles_per_batch or _tiles_per_launch(T, C, tile, blend_mode, dev)
    tiles, covs = [], []
    for s in range(0, T, tb):
        e = s + tb
        with trace.span("render.batch"):
            out = render_kernels.render_sample(
                images4, fine4, R_d, K_d, g_d, k1_d, sel_d[s:e], ok_d[s:e], org_d[s:e], canvas,
                th, tw, blend_mode, angle_power, interp)
            if blend_mode == "multiband":
                out = blend_ops.multiband_blend(*out, bands=bands, to_u8=True)
            n = min(e, T) - s
            trace.count("render.tile_batches")
            trace.count("render.tiles", n)
            trace.count("render.slots", n * C)
            trace.count("render.slots_live", int(np.count_nonzero(sel_ok[s:e])))
        tiles.append(out[0])
        covs.append(out[1])
    if not tiles:
        return (torch.zeros((0, th, tw, 3), dtype=torch.uint8, device=dev),
                torch.zeros((0, th, tw), dtype=torch.bool, device=dev))
    return torch.cat(tiles), torch.cat(covs)


def assemble_tiles(tiles, covs, origins: np.ndarray, Hc: int, Wc: int):
    """Canvas assembly from the tile stack: (panorama (Hc, Wc, 3) uint8,
    coverage (Hc, Wc) bool), numpy from numpy tiles, on the tiles' device
    from tensors (one copy when the tiles are `tile_contributors`' whole
    grid in its order)."""
    th, tw = covs.shape[1:3]
    if torch.is_tensor(tiles):
        nr, nc = -(-Hc // th), -(-Wc // tw)
        R0, C0 = np.meshgrid(np.arange(nr) * th, np.arange(nc) * tw, indexing="ij")
        grid = np.stack([C0.ravel(), R0.ravel()], -1)
        if len(origins) == nr * nc and np.array_equal(np.asarray(origins), grid):
            pano = tiles.reshape(nr, nc, th, tw, 3).transpose(1, 2).reshape(nr * th, nc * tw, 3)
            cover = covs.reshape(nr, nc, th, tw).transpose(1, 2).reshape(nr * th, nc * tw)
            return pano[:Hc, :Wc].contiguous(), cover[:Hc, :Wc].contiguous()
        pano = torch.zeros((Hc, Wc, 3), dtype=torch.uint8, device=tiles.device)
        cover = torch.zeros((Hc, Wc), dtype=torch.bool, device=tiles.device)
    else:
        pano = np.zeros((Hc, Wc, 3), np.uint8)
        cover = np.zeros((Hc, Wc), bool)
    for t in range(len(origins)):
        ox, oy = int(origins[t, 0]), int(origins[t, 1])
        h = min(th, Hc - oy)
        w = min(tw, Wc - ox)
        if h <= 0 or w <= 0:
            continue
        pano[oy : oy + h, ox : ox + w] = tiles[t, :h, :w]
        cover[oy : oy + h, ox : ox + w] = covs[t, :h, :w]
    return pano, cover
