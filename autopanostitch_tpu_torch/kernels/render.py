"""The rotational render stage — CUDA kernel wrappers and plain versions.

`render_sample` computes what the JAX package's `_render_tile_impl`
(`autopanostitch_tpu/models/render.py:292`) computes before its blend, and
the blend itself unless it is multiband: for each canvas pixel of each tile
and each contributor slot, in order, the pixel's world ray
(`projections.pano_to_ray`, five projections), its pixel in the slot's
camera (`project_ray_to_camera`, k1 through `distort_pixels`), the sample
(nearest, bilinear, bicubic, bicubic2x), the feather and angle weight and
the gain. For multiband it returns every slot's colour (T, C, th, tw, 3) and
weight (T, C, th, tw); for linear and none-* it blends the slots in order
and returns the uint8 tile (T, th, tw, 3) and its coverage (T, th, tw).

`multiband` is the Burt-Adelson blend of `autopanostitch_tpu/ops/blend.py:80`
(its `_blur_nc`, `_down2`, `_up2`) over contributors stacked as (..., C, H,
W, 3) colours and (..., C, H, W) weights: `mb_reduce` builds the Gaussian
levels (blur and 2x down, one launch a level), `mb_collapse` blends and
collapses them (one launch a level), and the last step writes either the
float blend or, as the renderer finishes a tile, the uint8 tile and its
coverage (sum of weights > 1e-3).

Kernels: `csrc/render.cu` (`render_sample`, `mb_reduce`, `mb_collapse`).
CUDA tensors launch them or raise; CPU tensors take the plain versions
(`render_sample_plain`, `mb_reduce_plain`, `mb_collapse_plain`,
`multiband_plain`). The plain sampler's geometry is `ops/projections`',
written to round on the card as the kernel does (`render.cu` is compiled
without FMA contraction). This module imports only the leaf modules
`ops/projections` and `ops/sampling`, which import nothing of the package,
so the kernel and ops layers never import each other in a cycle.

Launch counting: `sample_launches`, `reduce_launches` and
`collapse_launches` count the kernels' launches; `plain_on_cuda` counts
the plain versions' calls on CUDA tensors (a comparison's, never the main
path's).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from autopanostitch_tpu_torch.kernels import _build
from autopanostitch_tpu_torch.ops import projections as proj  # leaf modules: they import
from autopanostitch_tpu_torch.ops import sampling as samp  # nothing of the package

sample_launches = 0
reduce_launches = 0
collapse_launches = 0
plain_on_cuda = 0  # plain-version calls on CUDA tensors

MODES = {"cylindrical": 0, "spherical": 1, "equirectangular": 1, "planar": 2, "perspective": 2,
         "stereographic": 3}
INTERPS = {"nearest": 0, "bilinear": 1, "bicubic": 2, "bicubic2x": 3}
BLENDS = {"multiband": 0, "linear": 1, "none-last": 2, "none-first": 3, "none-maxangle": 4}
_EPS = 1e-8
_COVERED = 1e-3  # a pixel is covered where its weights sum above this


def _device(x, name: str) -> bool:
    """True for a CPU tensor; raises for any device but the CPU and CUDA."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cpu"


def _count_plain(x) -> None:
    global plain_on_cuda
    if x.device.type == "cuda":
        plain_on_cuda += 1


# ------------------------------------------------------------------ sampler

def _blend_slots(cols, ws, blend_mode: str):
    """Blend (T, C, P, 3) colours with (T, C, P) weights over the slots in
    order (the reference's scans): (tile (T, P, 3), weight sum (T, P))."""
    acc = torch.zeros_like(cols[:, 0])
    wsum = torch.zeros_like(ws[:, 0])
    if blend_mode == "linear":
        for c in range(cols.shape[1]):
            acc = acc + cols[:, c] * ws[:, c, :, None]
            wsum = wsum + ws[:, c]
        return acc / torch.clamp(wsum, min=_EPS)[..., None], wsum
    policy = blend_mode.split("-")[1]  # none-last | none-first | none-maxangle
    best = torch.zeros_like(ws[:, 0])
    for c in range(cols.shape[1]):
        w = ws[:, c]
        valid = w > 1e-6
        if policy == "first":
            write = valid & (wsum <= 1e-6)
        elif policy == "maxangle":
            write = valid & (w > best)
        else:
            write = valid
        acc = torch.where(write[..., None], cols[:, c], acc)
        best = torch.where(write, w, best)
        wsum = wsum + w
    return acc, wsum


def to_uint8(tile, wsum):
    """The renderer's finish of a blended tile: zero where the weights sum
    to at most 1e-3, clamped, uint8. Returns (uint8 tile, covered)."""
    covered = wsum > _COVERED
    tile = tile * covered[..., None]
    return (torch.clamp(tile, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8), covered


def render_sample_plain(images4, fine4, R, K, gains, k1, sel, sel_ok, origins, canvas: dict,
                        tile_h: int, tile_w: int, blend_mode: str, angle_power: float,
                        interp: str):
    """Plain PyTorch version of `render_sample` (same arguments)."""
    _count_plain(images4)
    dev = images4.device
    T, C = sel.shape
    ty, tx = torch.meshgrid(torch.arange(tile_h, device=dev, dtype=torch.float32),
                            torch.arange(tile_w, device=dev, dtype=torch.float32), indexing="ij")
    xp = tx.reshape(1, -1) + origins[:, 0:1]
    yp = ty.reshape(1, -1) + origins[:, 1:2]
    d = proj.pano_to_ray(canvas["mode"], xp, yp, canvas["f_pan"], canvas["x0"], canvas["y0"],
                         canvas["R_ref"])  # (T, P, 3)
    sl = sel.long()
    okf = sel_ok.float()
    u, v, front, cosang = proj.project_ray_to_camera(d[:, None], R[sl], K[sl],
                                                     k1=None if k1 is None else k1[sl])
    col4, valid = samp.sample_indexed(interp, images4, sl, u, v, fine4)
    wf = torch.clamp(col4[..., 3], min=0.0)
    w_ang = torch.where(front, cosang, torch.zeros_like(cosang)) ** angle_power
    w = w_ang * torch.clamp(wf, min=1e-4) * valid * front * okf[..., None]
    col = col4[..., :3] * (gains[sl] * okf[..., None])[:, :, None, :]
    if blend_mode == "multiband":
        return col.reshape(T, C, tile_h, tile_w, 3), w.reshape(T, C, tile_h, tile_w)
    tile, wsum = _blend_slots(col, w, blend_mode)
    u8, covered = to_uint8(tile, wsum)
    return u8.reshape(T, tile_h, tile_w, 3), covered.reshape(T, tile_h, tile_w)


def _check_sample(images4, fine4, R, K, gains, k1, sel, sel_ok, origins, canvas, tile_h,
                  tile_w, blend_mode, interp):
    if canvas["mode"] not in MODES or blend_mode not in BLENDS or interp not in INTERPS:
        raise ValueError(f"render_sample: unknown mode, blend or interpolation "
                         f"{canvas['mode']!r}, {blend_mode!r}, {interp!r}")
    if images4.ndim != 4 or images4.shape[-1] != 4 or images4.dtype != torch.float32:
        raise ValueError("render_sample: images4 must be (N, H, W, 4) float32")
    N, H, W, _ = images4.shape
    if (interp == "bicubic2x") != (fine4 is not None) or (
            fine4 is not None and fine4.shape != (N, 2 * H, 2 * W, 4)):
        raise ValueError("render_sample: bicubic2x needs fine4 (N, 2H, 2W, 4), no other "
                         "interpolation takes it")
    T, C = sel.shape
    floats = [(R, (N, 3, 3)), (K, (N, 3, 3)), (gains, (N, 3)), (origins, (T, 2))] + (
        [] if k1 is None else [(k1, (N,))]) + ([] if fine4 is None else [(fine4, fine4.shape)])
    for t, shape in floats:
        if tuple(t.shape) != shape or t.device != images4.device or t.dtype != torch.float32:
            raise ValueError(f"render_sample: expected {shape} float32 on {images4.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if sel.dtype != torch.int32 or sel_ok.dtype != torch.bool or sel_ok.shape != (T, C) or \
            sel.device != images4.device or sel_ok.device != images4.device:
        raise ValueError("render_sample: sel must be (T, C) int32 and sel_ok (T, C) bool on the "
                         "images' device")
    if C < 1 or tile_h < 1 or tile_w < 1:
        raise ValueError("render_sample: needs at least one slot and a non-empty tile")


def render_sample(images4, fine4, R, K, gains, k1, sel, sel_ok, origins, canvas: dict,
                  tile_h: int, tile_w: int, blend_mode: str, angle_power: float, interp: str):
    """Sample (and, but for multiband, blend) T tiles of tile_h x tile_w
    canvas pixels. images4 (N, H, W, 4) RGB + feather; fine4 its 2x Keys
    upsample (`sampling.upsample2x_cubic`) for bicubic2x, else None; R, K
    (N, 3, 3), gains (N, 3), k1 (N,) or None (no distortion model), float32;
    sel (T, C) int32 image indices (< N; not checked on the card), sel_ok (T,
    C) bool, origins (T, 2) float32 [x, y] canvas pixels; canvas: mode,
    f_pan, x0, y0, R_ref (`models.render.compute_canvas`). Returns multiband:
    (col (T, C, th, tw, 3), w (T, C, th, tw)); else (uint8 (T, th, tw, 3),
    covered (T, th, tw) bool)."""
    global sample_launches
    _check_sample(images4, fine4, R, K, gains, k1, sel, sel_ok, origins, canvas, tile_h, tile_w,
                  blend_mode, interp)
    args = (images4, fine4, R, K, gains, k1, sel, sel_ok, origins, canvas, tile_h, tile_w,
            blend_mode, angle_power, interp)
    if _device(images4, "render_sample"):
        return render_sample_plain(*args)
    dev = images4.device
    N, H, W, _ = images4.shape
    T, C = sel.shape
    stack = (images4 if fine4 is None else fine4).contiguous()
    if stack.data_ptr() % 16:
        raise ValueError("render_sample: the image stack must be 16-byte aligned (float4 taps)")
    ins = [t.contiguous() for t in (R, K, gains, sel, sel_ok, origins)]
    k1c = None if k1 is None else k1.contiguous()
    if blend_mode == "multiband":
        outs = (torch.empty((T, C, tile_h, tile_w, 3), dtype=torch.float32, device=dev),
                torch.empty((T, C, tile_h, tile_w), dtype=torch.float32, device=dev))
        ptrs = [outs[0].data_ptr(), outs[1].data_ptr(), None, None]
    else:
        outs = (torch.empty((T, tile_h, tile_w, 3), dtype=torch.uint8, device=dev),
                torch.empty((T, tile_h, tile_w), dtype=torch.bool, device=dev))
        ptrs = [None, None, outs[0].data_ptr(), outs[1].data_ptr()]
    if T == 0:
        return outs
    r_ref = (ctypes.c_float * 9)(*np.asarray(canvas["R_ref"], np.float32).reshape(9).tolist())
    err = _build.library().apst_render_sample(
        stack.data_ptr(), N, stack.shape[1], stack.shape[2], H, W,
        *(t.data_ptr() for t in ins[:3]), None if k1c is None else k1c.data_ptr(),
        *(t.data_ptr() for t in ins[3:]), T, C, tile_h, tile_w, MODES[canvas["mode"]],
        INTERPS[interp], BLENDS[blend_mode], float(canvas["f_pan"]), float(canvas["x0"]),
        float(canvas["y0"]), ctypes.cast(r_ref, ctypes.c_void_p), float(angle_power), *ptrs,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "apst_render_sample")
    sample_launches += 1
    return outs


# ------------------------------------------------------------------ pyramid

class PyramidPlan(NamedTuple):
    """A multiband pyramid's shape: `bands` (capped as the reference caps
    it), `sigma`, level sizes [(h, w)], and per level l < bands - 1 the
    compact tap tables (`sampling.resize_taps`) of down (h_l -> h_l+1, w_l
    -> w_l+1) and up (h_l+1 -> h_l, w_l+1 -> w_l), as (first, taps, n)
    tensors on the device, and the blur's taps there."""
    bands: int
    sigma: float
    sizes: tuple
    down: tuple  # ((first_y, taps_y, n_y), (first_x, taps_x, n_x)) a level
    up: tuple
    blur: torch.Tensor


_OUT_TILE = (8, 32)  # `mb_reduce`'s block tile of the coarser level (kOY, kOX)
_MAX_DOWN_TAPS = 4
_MAX_RADIUS = 8


def _table(in_size: int, out_size: int, device, block: int = 0):
    first, taps = samp.resize_taps(in_size, out_size, "linear")
    n = taps.shape[1]
    if block:  # the source rows of a block's outputs must fit its shared tile
        ends = np.minimum(np.arange(0, out_size, block) + block, out_size) - 1
        span = first[ends] + n - first[np.arange(0, out_size, block)]
        if n > _MAX_DOWN_TAPS or span.max() > (block - 1) * 2 + _MAX_DOWN_TAPS:
            raise ValueError(f"multiband: a {in_size} -> {out_size} resize does not fit mb_reduce")
    return (torch.as_tensor(first, device=device), torch.as_tensor(taps, device=device), n)


@functools.lru_cache(maxsize=64)
def pyramid_plan(H: int, W: int, bands: int, sigma: float, device: torch.device) -> PyramidPlan:
    """The pyramid of an (H, W) blend, cached per shape and device."""
    max_levels = max(1, int(math.floor(math.log2(max(min(H, W), 2)))) - 1)
    bands = max(1, min(bands, max_levels))
    sizes = [(H, W)]
    for _ in range(bands - 1):
        h, w = sizes[-1]
        sizes.append(((h + 1) // 2, (w + 1) // 2))
    down = tuple((_table(a[0], b[0], device, _OUT_TILE[0]),
                   _table(a[1], b[1], device, _OUT_TILE[1]))
                 for a, b in zip(sizes, sizes[1:]))
    up = tuple((_table(b[0], a[0], device), _table(b[1], a[1], device))
               for a, b in zip(sizes, sizes[1:]))
    blur = samp.gaussian_kernel1d(sigma, device)
    if blur.shape[0] // 2 > _MAX_RADIUS:
        raise ValueError(f"multiband: sigma {sigma} needs a blur wider than mb_reduce takes")
    return PyramidPlan(bands, sigma, tuple(sizes), down, up, blur)


def _level0_plain(colors, weights):
    """Level 0 as (..., C, 4, H, W) planes: the colours and the weights
    normalised over the contributors."""
    ax = weights.ndim - 3
    wsum = weights.sum(ax, keepdim=True)
    wnorm = torch.where(wsum > _EPS, weights / torch.clamp(wsum, min=_EPS),
                        torch.zeros_like(weights))
    return torch.cat([torch.movedim(colors, -1, -3), wnorm.unsqueeze(-3)], -3)


def mb_reduce_plain(colors, weights, plan: PyramidPlan):
    """Plain PyTorch version of `mb_reduce`."""
    _count_plain(colors)
    g = _level0_plain(colors, weights)
    levels = []
    for _ in range(plan.bands - 1):
        g = samp.down2(samp.gaussian_blur(g, plan.sigma))
        levels.append(g)
    return levels


def mb_collapse_plain(colors, weights, levels, plan: PyramidPlan, to_u8: bool = False):
    """Plain PyTorch version of `mb_collapse`."""
    _count_plain(colors)
    pyr = [_level0_plain(colors, weights)] + list(levels)
    top = pyr[-1]
    out = (top[..., :3, :, :] * top[..., 3:, :, :]).sum(-4) / torch.clamp(
        top[..., 3:, :, :].sum(-4), min=_EPS)  # (..., 3, h, w)
    for lvl in range(plan.bands - 2, -1, -1):
        g = pyr[lvl]
        h, w = g.shape[-2:]
        lap = g[..., :3, :, :] - samp.up2(pyr[lvl + 1][..., :3, :, :], h, w)
        gw = g[..., 3:, :, :]
        num = (lap * gw).sum(-4) / torch.clamp(gw.sum(-4), min=_EPS)
        out = samp.up2(out, h, w) + num
    out = torch.movedim(out, -3, -1)
    wsum = weights.sum(weights.ndim - 3)
    out = torch.clamp(out, 0.0, 1.0) * (wsum > _EPS)[..., None]
    return to_uint8(out, wsum) if to_u8 else out


def _check_mb(colors, weights, name: str):
    if colors.ndim < 4 or colors.shape[-1] != 3 or weights.shape != colors.shape[:-1]:
        raise ValueError(f"{name}: colors must be (..., C, H, W, 3) and weights (..., C, H, W)")
    if colors.dtype != torch.float32 or weights.dtype != torch.float32 or \
            weights.device != colors.device:
        raise ValueError(f"{name}: colors and weights must be float32 on one device")


def mb_reduce(colors, weights, plan: PyramidPlan):
    """The Gaussian levels 1 .. bands - 1 of a multiband blend, each (..., C,
    4, h, w): R, G, B and the normalised weight, blurred and halved level by
    level (colors (..., C, H, W, 3), weights (..., C, H, W) float32)."""
    global reduce_launches
    _check_mb(colors, weights, "mb_reduce")
    if _device(colors, "mb_reduce"):
        return mb_reduce_plain(colors, weights, plan)
    lead = colors.shape[:-4]
    C, H, W = colors.shape[-4:-1]
    B = math.prod(lead)
    col, w = colors.contiguous(), weights.contiguous()
    src, levels = None, []
    stream = torch.cuda.current_stream(colors.device).cuda_stream
    for (h2, w2), ((fy, ty, ny), (fx, tx, nx)), (h, w_) in zip(plan.sizes[1:], plan.down,
                                                                plan.sizes):
        out = torch.empty(lead + (C, 4, h2, w2), dtype=torch.float32, device=colors.device)
        err = _build.library().apst_mb_reduce(
            None if src is not None else col.data_ptr(), None if src is not None else w.data_ptr(),
            None if src is None else src.data_ptr(), B, C, h, w_, h2, w2, fy.data_ptr(),
            ty.data_ptr(), ny, fx.data_ptr(), tx.data_ptr(), nx, plan.blur.data_ptr(),
            plan.blur.shape[0] // 2, out.data_ptr(), stream)
        _build.check(err, "apst_mb_reduce")
        reduce_launches += 1
        levels.append(out)
        src = out
    return levels


def mb_collapse(colors, weights, levels, plan: PyramidPlan, to_u8: bool = False):
    """Blend and collapse the pyramid (`mb_reduce`'s levels above the inputs'
    own): the float blend (..., H, W, 3), or with to_u8 the renderer's uint8
    tile (..., H, W, 3) and coverage (..., H, W) (`to_uint8`)."""
    global collapse_launches
    _check_mb(colors, weights, "mb_collapse")
    if _device(colors, "mb_collapse"):
        return mb_collapse_plain(colors, weights, levels, plan, to_u8)
    dev = colors.device
    lead = colors.shape[:-4]
    C, H, W = colors.shape[-4:-1]
    B = math.prod(lead)
    col, w = colors.contiguous(), weights.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    coarse_out = None
    for lvl in range(plan.bands - 1, -1, -1):
        h, w_ = plan.sizes[lvl]
        coarse = levels[lvl] if lvl < plan.bands - 1 else None
        (fy, ty, ny), (fx, tx, nx) = plan.up[lvl] if coarse is not None else ((None, None, 0),) * 2
        h2, w2 = plan.sizes[lvl + 1] if coarse is not None else (0, 0)
        out = u8 = covered = None
        if lvl > 0:
            kind, out = 0, torch.empty((B, 3, h, w_), dtype=torch.float32, device=dev)
        elif to_u8:
            kind = 2
            u8 = torch.empty(lead + (H, W, 3), dtype=torch.uint8, device=dev)
            covered = torch.empty(lead + (H, W), dtype=torch.bool, device=dev)
        else:
            kind, out = 1, torch.empty(lead + (H, W, 3), dtype=torch.float32, device=dev)
        err = _build.library().apst_mb_collapse(
            col.data_ptr() if lvl == 0 else None, w.data_ptr() if lvl == 0 else None,
            levels[lvl - 1].data_ptr() if lvl > 0 else None, B, C, h, w_,
            None if coarse is None else coarse.data_ptr(),
            None if coarse_out is None else coarse_out.data_ptr(), h2, w2,
            None if fy is None else fy.data_ptr(), None if ty is None else ty.data_ptr(), ny,
            None if fx is None else fx.data_ptr(), None if tx is None else tx.data_ptr(), nx,
            kind, None if out is None else out.data_ptr(), None if u8 is None else u8.data_ptr(),
            None if covered is None else covered.data_ptr(), stream)
        _build.check(err, "apst_mb_collapse")
        collapse_launches += 1
        coarse_out = out
    return (u8, covered) if to_u8 else out


def multiband_plain(colors, weights, bands: int = 3, sigma: float = 1.0, to_u8: bool = False):
    """Plain PyTorch version of `multiband`: the JAX package's
    `multiband_blend` (weights normalised over the contributors; per level a
    replicate-padded Gaussian blur, a 2x antialiased linear resize, the
    Laplacian blended by the level's weights; the coarsest level's Gaussian
    blended; collapsed by linear upsampling), over any leading dims."""
    plan = pyramid_plan(colors.shape[-3], colors.shape[-2], bands, sigma, colors.device)
    return mb_collapse_plain(colors, weights, mb_reduce_plain(colors, weights, plan), plan, to_u8)


def multiband(colors, weights, bands: int = 3, sigma: float = 1.0, to_u8: bool = False):
    """Multiband blend of contributors: colors (..., C, H, W, 3) in [0, 1],
    weights (..., C, H, W), float32, any H and W; bands capped at
    floor(log2(min(H, W))) - 1 as the reference caps them. Returns the blend
    (..., H, W, 3), clamped to [0, 1] and zero where no weight; with to_u8
    the uint8 tile and its coverage (`to_uint8`)."""
    _check_mb(colors, weights, "multiband")
    if _device(colors, "multiband"):
        return multiband_plain(colors, weights, bands, sigma, to_u8)
    plan = pyramid_plan(colors.shape[-3], colors.shape[-2], bands, sigma, colors.device)
    return mb_collapse(colors, weights, mb_reduce(colors, weights, plan), plan, to_u8)
