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
levels (the blur and the 2x down folded into one filter an axis,
`folded_taps`; one launch a level), `mb_collapse` blends and collapses every
level in one launch, tile by tile of level 0 (`collapse_regions`), and
writes either the float blend or, as the renderer finishes a tile, the
uint8 tile and its coverage (sum of weights > 1e-3). `pyramid_plan` builds
both kernels' tables and raises for a pyramid they cannot take.

Kernels: `csrc/render.cu` (`render_sample`) and `csrc/render_pyramid.cu`
(`mb_reduce`, `mb_collapse`). CUDA tensors launch them or raise; CPU tensors
take the plain versions (`render_sample_plain`, `mb_reduce_plain`,
`mb_collapse_plain`, `multiband_plain`). The plain sampler's geometry is
`ops/projections`', written to round on the card as the kernel does
(`render.cu` is compiled without FMA contraction; the pyramid's source is
not, and its plain versions are held within 1e-5). This module imports only the leaf modules
`ops/projections` and `ops/sampling`, which import nothing of the package,
so the kernel and ops layers never import each other in a cycle.

Launch counting: `sample_launches`, `reduce_launches` and
`collapse_launches` count the kernels' launches (`reduce_launch` and
`collapse_launch` launch uncounted, for the probe's variants);
`plain_on_cuda` counts the plain versions' calls on CUDA tensors (a
comparison's, never the main path's).
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

class ReduceLevel(NamedTuple):
    """`mb_reduce`'s tables for one level down: the folded blur-and-resize
    filters along each axis (`folded_taps`) as (first, taps, new, n) with
    the tables on the device (new: int32, 1 where an output's taps differ
    from the one before), and the largest source window (rows, columns) of
    a `_REDUCE_TILE` tile of the coarser level."""
    y: tuple
    x: tuple
    span: tuple


class PyramidPlan(NamedTuple):
    """A multiband pyramid's shape: `bands` (capped as the reference caps
    it), `sigma`, level sizes [(h, w)]; per level l < bands - 1
    `mb_reduce`'s tables down to level l + 1 (`ReduceLevel`) and the compact
    up tables (`sampling.resize_taps`) from level l + 1 back to l, as
    ((first_y, taps_y, n_y), (first_x, taps_x, n_x)) with the tables on the
    device; per level `mb_collapse`'s regions of its `_COLLAPSE_TILE` tiles
    of level 0 (`collapse_regions`), as (rows (tiles_y, 2), columns
    (tiles_x, 2)) int32 tensors on the device, and the largest region's
    (rows, columns)."""
    bands: int
    sigma: float
    sizes: tuple
    down: tuple
    up: tuple
    regions: tuple
    region_max: tuple


_REDUCE_TILE = (16, 32)  # `mb_reduce`'s tile of the coarser level (kRTY, kRTX)
_COLLAPSE_TILE = (16, 64)  # `mb_collapse`'s tile of level 0 (kCTY, kCTX)
_COLLAPSE_PIXELS = (1024, 512, 256)  # a region's pixels at levels 0, 1, 2+ (kCThreads x 4, 2, 1)
_MAX_LEVELS = 8  # kMaxLevels
_MAX_UP_TAPS = 2  # kMaxUp
_MAX_RADIUS = 8
_SMEM_BYTES = 232448  # a block's shared memory on an H100 (kSmemMax)


def folded_taps(in_size: int, out_size: int, sigma: float):
    """The Gaussian blur (`sampling.gaussian_blur`'s taps, replicate
    borders) followed by the 2x antialiased linear resize (`resize_taps`)
    along one axis, as one filter, in float64: (first (out,) int32, taps
    (out, n) float64) with out[j] = sum_t taps[j, t] x[first[j] + t]. The
    border indices fold into the edge pixel's tap, and each window lies
    inside [0, in_size)."""
    k = samp.gaussian_kernel1d(sigma).double().numpy()
    r = len(k) // 2
    first_d, taps_d = samp.resize_taps(in_size, out_size, "linear")
    n = taps_d.shape[1]
    idx = np.clip(first_d[:, None, None] + np.arange(n)[None, :, None]
                  + np.arange(-r, r + 1)[None, None, :], 0, in_size - 1)
    val = taps_d.astype(np.float64)[:, :, None] * k[None, None, :]
    lo, hi = idx.min((1, 2)), idx.max((1, 2))
    width = int((hi - lo + 1).max())
    first = np.minimum(lo, in_size - width).astype(np.int32)
    taps = np.zeros((out_size, width))
    np.add.at(taps, (np.arange(out_size)[:, None, None], idx - first[:, None, None]), val)
    return first, taps


def _window_span(first: np.ndarray, n: int, tile: int) -> int:
    """The most source rows a tile of `tile` outputs reads."""
    starts = np.arange(0, len(first), tile)
    ends = np.minimum(starts + tile, len(first)) - 1
    return int((first[ends] + n - first[starts]).max())


def reduce_smem_bytes(span_y: int, span_x: int, ny: int, nx: int) -> int:
    """`mb_reduce`'s shared memory for a span_y x span_x source window and
    ny x nx folded taps (`reduce_smem_floats` in `csrc/render_pyramid.cu`):
    two stage buffers (colour rows 3 span_x wide padded to 3 mod 32 floats,
    weight rows padded to an odd width, the tile's tables), the row pass's
    output (4 span_y rows of 33) and level 0's weight sums and their
    reciprocals."""
    pitch_c = 3 * span_x + (35 - 3 * span_x % 32) % 32
    pitch_w = span_x | 1
    ty, tx = _REDUCE_TILE
    tables = 2 * tx + tx * nx + 2 * ty + ty * ny
    return 4 * (2 * (span_y * (pitch_c + pitch_w) + tables) + 4 * span_y * (tx + 1)
                + 2 * span_y * pitch_w)


def _reduce_level(a: tuple, b: tuple, sigma: float, device) -> ReduceLevel:
    axes, spans = [], []
    for in_size, out_size, tile in zip(a, b, _REDUCE_TILE):
        first, taps = folded_taps(in_size, out_size, sigma)
        taps = taps.astype(np.float32)
        new = np.concatenate([[True], (taps[1:] != taps[:-1]).any(1)]).astype(np.int32)
        axes.append((torch.as_tensor(first, device=device), torch.as_tensor(taps, device=device),
                     torch.as_tensor(new, device=device), taps.shape[1]))
        spans.append(_window_span(first, taps.shape[1], tile))
    if reduce_smem_bytes(*spans, axes[0][3], axes[1][3]) > _SMEM_BYTES:
        raise ValueError(f"multiband: a {a} -> {b} level at sigma {sigma} does not fit mb_reduce")
    return ReduceLevel(axes[0], axes[1], tuple(spans))


def collapse_regions(sizes, tile: int):
    """Along one axis of the level sizes [n_0, n_1, ...]: per level an
    (tiles, 2) int32 array of each level-0 tile's region there (first
    index, count). Level 0's is the tile itself; level l + 1's holds every
    tap up2 (`resize_taps` from n_l+1 to n_l) reads for level l's region."""
    starts = np.arange(0, sizes[0], tile)
    regions = [np.stack([starts, np.minimum(tile, sizes[0] - starts)], 1)]
    for fine, coarse in zip(sizes, sizes[1:]):
        first, taps = samp.resize_taps(coarse, fine, "linear")
        s, c = regions[-1][:, 0], regions[-1][:, 1]
        lo = first[s]
        regions.append(np.stack([lo, first[s + c - 1] + taps.shape[1] - lo], 1))
    return [r.astype(np.int32) for r in regions]


def _up_table(in_size: int, out_size: int, device):
    first, taps = samp.resize_taps(in_size, out_size, "linear")
    if taps.shape[1] > _MAX_UP_TAPS:
        raise ValueError(f"multiband: a {in_size} -> {out_size} up2 does not fit mb_collapse")
    return (torch.as_tensor(first, device=device), torch.as_tensor(taps, device=device),
            taps.shape[1])


@functools.lru_cache(maxsize=64)
def pyramid_plan(H: int, W: int, bands: int, sigma: float, device: torch.device) -> PyramidPlan:
    """The pyramid of an (H, W) blend, cached per shape and device. Raises
    for one the kernels cannot take: more than 8 bands, a blur wider than
    17 taps."""
    max_levels = max(1, int(math.floor(math.log2(max(min(H, W), 2)))) - 1)
    bands = max(1, min(bands, max_levels))
    if bands > _MAX_LEVELS:
        raise ValueError(f"multiband: mb_collapse takes at most {_MAX_LEVELS} bands, not {bands}")
    if samp.gaussian_kernel1d(sigma).shape[0] // 2 > _MAX_RADIUS:
        raise ValueError(f"multiband: sigma {sigma} needs a blur wider than mb_reduce takes")
    sizes = [(H, W)]
    for _ in range(bands - 1):
        h, w = sizes[-1]
        sizes.append(((h + 1) // 2, (w + 1) // 2))
    down = tuple(_reduce_level(a, b, sigma, device) for a, b in zip(sizes, sizes[1:]))
    up = tuple((_up_table(b[0], a[0], device), _up_table(b[1], a[1], device))
               for a, b in zip(sizes, sizes[1:]))
    per_axis = [collapse_regions([s[ax] for s in sizes], _COLLAPSE_TILE[ax]) for ax in (0, 1)]
    region_max = tuple((int(ry[:, 1].max()), int(rx[:, 1].max())) for ry, rx in zip(*per_axis))
    if any(r * c > _COLLAPSE_PIXELS[min(lvl, 2)] for lvl, (r, c) in enumerate(region_max)):
        raise ValueError(f"multiband: an {H} x {W} pyramid's regions do not fit mb_collapse")
    regions = tuple((torch.as_tensor(ry, device=device), torch.as_tensor(rx, device=device))
                    for ry, rx in zip(*per_axis))
    return PyramidPlan(bands, sigma, tuple(sizes), down, up, regions, region_max)


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


def reduce_launch(colors, weights, plan: PyramidPlan, variant: int = 0):
    """`mb_reduce` on CUDA tensors, uncounted: one `apst_mb_reduce` launch a
    level. variant 0 is the kernel; 1 (its loads only) and 2 (its arithmetic
    only) are `tools/pyramid_probe.py`'s, whose levels hold no result."""
    lead = colors.shape[:-4]
    C, H, W = colors.shape[-4:-1]
    B = math.prod(lead)
    col, w = colors.contiguous(), weights.contiguous()
    src, levels = None, []
    stream = torch.cuda.current_stream(colors.device).cuda_stream
    for (h, w_), (h2, w2), lv in zip(plan.sizes, plan.sizes[1:], plan.down):
        out = torch.empty(lead + (C, 4, h2, w2), dtype=torch.float32, device=colors.device)
        err = _build.library().apst_mb_reduce(
            None if src is not None else col.data_ptr(), None if src is not None else w.data_ptr(),
            None if src is None else src.data_ptr(), B, C, h, w_, h2, w2,
            *(t.data_ptr() for t in lv.y[:3]), lv.y[3], *(t.data_ptr() for t in lv.x[:3]),
            lv.x[3], *lv.span, out.data_ptr(), variant, stream)
        _build.check(err, "apst_mb_reduce")
        levels.append(out)
        src = out
    return levels


def mb_reduce(colors, weights, plan: PyramidPlan):
    """The Gaussian levels 1 .. bands - 1 of a multiband blend, each (..., C,
    4, h, w): R, G, B and the normalised weight, blurred and halved level by
    level (colors (..., C, H, W, 3), weights (..., C, H, W) float32)."""
    global reduce_launches
    _check_mb(colors, weights, "mb_reduce")
    if _device(colors, "mb_reduce"):
        return mb_reduce_plain(colors, weights, plan)
    levels = reduce_launch(colors, weights, plan)
    reduce_launches += len(levels)
    return levels


def collapse_launch(colors, weights, levels, plan: PyramidPlan, to_u8: bool = False,
                    variant: int = 0):
    """`mb_collapse` on CUDA tensors, uncounted: one `apst_mb_collapse`
    launch for every level (variant as `reduce_launch`'s)."""
    dev = colors.device
    lead = colors.shape[:-4]
    C, H, W = colors.shape[-4:-1]
    if len(levels) != plan.bands - 1 or any(
            g.shape != lead + (C, 4) + s or not g.is_contiguous()
            for g, s in zip(levels, plan.sizes[1:])):
        raise ValueError("mb_collapse: levels must be mb_reduce's for this plan")
    col, w = colors.contiguous(), weights.contiguous()
    ptrs, ints = [], []
    for lvl, ((h, w_), (rows, cols), (mr, mc)) in enumerate(zip(plan.sizes, plan.regions,
                                                                plan.region_max)):
        coarsest = lvl == plan.bands - 1
        (fy, ty, ny), (fx, tx, nx) = ((None, None, 0),) * 2 if coarsest else plan.up[lvl]
        ptrs += [levels[lvl - 1].data_ptr() if lvl else None, rows.data_ptr(), cols.data_ptr()]
        ptrs += [None if t is None else t.data_ptr() for t in (fy, ty, fx, tx)]
        ints += [h, w_, ny, nx, mr, mc]
    if to_u8:
        u8 = torch.empty(lead + (H, W, 3), dtype=torch.uint8, device=dev)
        covered = torch.empty(lead + (H, W), dtype=torch.bool, device=dev)
        outs, kind = (None, u8.data_ptr(), covered.data_ptr()), 2
    else:
        out = torch.empty(lead + (H, W, 3), dtype=torch.float32, device=dev)
        outs, kind = (out.data_ptr(), None, None), 1
    err = _build.library().apst_mb_collapse(
        col.data_ptr(), w.data_ptr(), math.prod(lead), C, plan.bands,
        ctypes.cast((ctypes.c_void_p * len(ptrs))(*ptrs), ctypes.c_void_p),
        ctypes.cast((ctypes.c_int * len(ints))(*ints), ctypes.c_void_p), kind, *outs,
        variant, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "apst_mb_collapse")
    return (u8, covered) if to_u8 else out


def mb_collapse(colors, weights, levels, plan: PyramidPlan, to_u8: bool = False):
    """Blend and collapse the pyramid (`mb_reduce`'s levels above the inputs'
    own): the float blend (..., H, W, 3), or with to_u8 the renderer's uint8
    tile (..., H, W, 3) and coverage (..., H, W) (`to_uint8`)."""
    global collapse_launches
    _check_mb(colors, weights, "mb_collapse")
    if _device(colors, "mb_collapse"):
        return mb_collapse_plain(colors, weights, levels, plan, to_u8)
    out = collapse_launch(colors, weights, levels, plan, to_u8)
    collapse_launches += 1
    return out


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
