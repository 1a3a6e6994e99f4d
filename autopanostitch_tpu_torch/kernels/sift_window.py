"""B2, fused: SIFT's orientation histogram and descriptor straight from the
magnitude/angle stack — CUDA kernel wrappers and plain versions.

Port of `gather_windows` (`autopanostitch_tpu/ops/pallas/window_gather.py:78`)
together with the dense phases that consume its windows,
`_orientation_hist_dense` (`autopanostitch_tpu/ops/sift.py:329`) and
`_descriptor_dense` (`:388`). The kernels are `csrc/sift_window.cu`: each
reads a keypoint's window into shared memory (or, for a window too large
for two stages of it, straight from the stack) and bins it there, so
neither the windows nor the soft-bin tensors reach device memory, and all
keypoints of a call are one launch. The descriptor kernel takes d x d x
nbins grids with d <= 4 and nbins <= 16 (`check_grid`).

The plain versions are what the kernels replace: the window gather
(`window_gather.gather_windows_plain`) and the dense PyTorch binning,
`chunk` keypoints at a time. They run for CPU tensors; for CUDA tensors the
wrappers launch the kernels or raise.
"""

from __future__ import annotations

import math

import torch

from autopanostitch_tpu_torch.kernels import _build
from autopanostitch_tpu_torch.kernels.window_gather import gather_windows_plain
from autopanostitch_tpu_torch.utils import trace

ORI_BINS = 36
_ORI_SIGMA_FACTOR = 1.5
_ORI_RADIUS_FACTOR = 3.0
_DESC_SCALE_FACTOR = 3.0
_DESC_MAG_CLIP = 0.2

trace.declare_kernels("orient_hist", "descriptor")


def _bf16(x):
    """Round float32 to bfloat16 and back (the reference's operand rounding)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _soft_bins(vals, nb: int, circular: bool):
    """(K, P) bin coordinates -> (K, P, nb) linear soft-assignment weights."""
    v0 = torch.floor(vals)
    f = vals - v0
    i0 = v0.long()
    out = torch.zeros(vals.shape + (nb,), dtype=vals.dtype, device=vals.device)
    if circular:
        out.scatter_(-1, (i0 % nb)[..., None], (1 - f)[..., None])
        out.scatter_add_(-1, ((i0 % nb + 1) % nb)[..., None], f[..., None])
    else:
        in0 = ((i0 >= 0) & (i0 < nb)).to(vals.dtype)
        in1 = ((i0 + 1 >= 0) & (i0 + 1 < nb)).to(vals.dtype)
        out.scatter_(-1, i0.clamp(0, nb - 1)[..., None], ((1 - f) * in0)[..., None])
        out.scatter_add_(-1, (i0 + 1).clamp(0, nb - 1)[..., None], (f * in1)[..., None])
    return out


def _two_pi(like):
    """float32(2 pi) as a 0-dim tensor on `like`'s device. Dividing by it is
    a true division on every device, as in the reference; PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead, which
    can move a bin weight across a bf16 rounding boundary."""
    return torch.full((), 2 * math.pi, dtype=torch.float32, device=like.device)


def _window_grid(Hw: int, Ww: int, lx, ly):
    """(K, Hw, Ww) offsets of every window pixel from the keypoint."""
    dev = lx.device
    wy = torch.arange(Hw, dtype=torch.float32, device=dev)[None, :, None]
    wx = torch.arange(Ww, dtype=torch.float32, device=dev)[None, None, :]
    return wx - lx[:, None, None], wy - ly[:, None, None]


def orientation_hist_dense(wmag, wang, lx, ly, sigma_rel):
    """(K, Hw, Ww) magnitude/angle windows -> (K, 36) raw (unsmoothed)
    orientation histograms, by the reference's dense soft binning."""
    K, Hw, Ww = wmag.shape
    rx, ry = _window_grid(Hw, Ww, lx, ly)
    r2 = rx * rx + ry * ry
    sw = (_ORI_SIGMA_FACTOR * sigma_rel)[:, None, None]
    wgt = torch.exp(-r2 / (2 * sw * sw)) * (r2 <= (_ORI_RADIUS_FACTOR * sw) ** 2)
    contrib = (wmag * wgt).reshape(K, 1, -1)
    binf = ((wang / _two_pi(wang) * ORI_BINS) % ORI_BINS).reshape(K, -1)
    return torch.bmm(contrib, _soft_bins(binf, ORI_BINS, circular=True))[:, 0]


def smooth_hist(hist):
    """The reference's two circular (1, 1, 1) / 3 smoothing passes."""
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    return hist


def descriptor_dense(wmag, wang, lx, ly, sigma_rel, theta, d: int = 4, nbins: int = 8):
    """(K, Hw, Ww) windows -> (K, d*d*nbins) descriptors.

    The reference contracts bfloat16-rounded soft-bin weights with float32
    accumulation (`sift._descriptor_dense`); the same operands are rounded
    through bfloat16 here so both packages bin identical numbers, and the
    contraction accumulates in float32."""
    K, Hw, Ww = wmag.shape
    cell = (_DESC_SCALE_FACTOR * sigma_rel)[:, None, None]
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    rx, ry = _window_grid(Hw, Ww, lx, ly)
    u = (cos_t * rx + sin_t * ry) / cell
    v = (-sin_t * rx + cos_t * ry) / cell
    rbin = (v + d / 2.0 - 0.5).reshape(K, -1)
    cbin = (u + d / 2.0 - 0.5).reshape(K, -1)
    ang = wang - theta[:, None, None]
    obin = ((ang / _two_pi(ang) * nbins) % nbins).reshape(K, -1)
    wsig = 0.5 * d
    wgt = torch.exp(-(u * u + v * v) / (2 * wsig * wsig))
    contrib = (wmag * wgt).reshape(K, -1)

    R = _bf16(_soft_bins(rbin, d, circular=False))
    C = _bf16(_soft_bins(cbin, d, circular=False))
    O = _bf16(_soft_bins(obin, nbins, circular=True))
    cb = _bf16(contrib)
    Wrc = _bf16(_bf16(cb[..., None] * R)[..., :, None] * C[..., None, :]).reshape(K, -1, d * d)
    desc = torch.bmm(Wrc.transpose(1, 2), O).reshape(K, -1)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    desc = torch.clamp(desc, max=_DESC_MAG_CLIP)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    return desc


def _per_window(fn, src, lev, ys, xs, win: int, args, chunk: int, gather):
    """fn(wmag, wang, *args_chunk) over every keypoint's (win, win) window,
    fetched by `gather` `chunk` keypoints at a time; outputs concatenated."""
    outs = []
    for s in range(0, lev.shape[0], chunk):
        e = min(s + chunk, lev.shape[0])
        wins = gather(src, lev[s:e], ys[s:e], xs[s:e], win, win)
        outs.append(fn(wins[..., 0], wins[..., 1], *[a[s:e] for a in args]))
    return torch.cat(outs)


def orient_hist_plain(src, lev, ys, xs, lx, ly, sigma_rel, win: int, chunk: int = 256,
                      gather=gather_windows_plain):
    """Plain version of `orient_hist`: gathered windows, dense binning."""
    if lev.shape[0] == 0:
        return torch.zeros((0, ORI_BINS), dtype=torch.float32, device=src.device)
    return _per_window(orientation_hist_dense, src, lev, ys, xs, win, (lx, ly, sigma_rel), chunk,
                       gather)


def descriptor_plain(src, lev, ys, xs, lx, ly, sigma_rel, theta, win: int, d: int = 4,
                     nbins: int = 8, chunk: int = 256, gather=gather_windows_plain):
    """Plain version of `descriptor`: gathered windows, dense binning."""
    if lev.shape[0] == 0:
        return torch.zeros((0, d * d * nbins), dtype=torch.float32, device=src.device)

    def fn(wmag, wang, lxk, lyk, srel, th):
        return descriptor_dense(wmag, wang, lxk, lyk, srel, th, d, nbins)

    return _per_window(fn, src, lev, ys, xs, win, (lx, ly, sigma_rel, theta), chunk, gather)


# mirrors csrc/sift_window.cu: threads a block, the descriptor's pixels a
# lane, and the largest dynamic shared memory a block may ask for on sm_90
_ORI_NT, _DESC_NT, _DESC_PX = 128, 512, 2
_SMEM_MAX = 227 * 1024
MAX_WIN = 2048  # largest window the kernels take
MAX_GRID = (4, 16)  # largest descriptor_width and descriptor_bins the kernel takes


def _staged_smem(kernel: str, win: int, nbins: int) -> int:
    """Shared memory of `kernel` ("orient_hist" | "descriptor") with two
    window stages (csrc/sift_window.cu's orient_smem / desc_smem)."""
    stage = -(-win * (win + 2) * 8 // 128) * 128
    if kernel == "orient_hist":
        rest = ORI_BINS * _ORI_NT * 4
    else:
        row = 24 if nbins <= 8 else 40  # desc_row: 16 cells + 8 NT bins, an odd count of 16 B
        rest = _DESC_NT // 32 * (32 * _DESC_PX * row * 2 + 4)
    return 128 + 2 * stage + rest + 16


def copy_route(src, win: int, kernel: str = "orient_hist", nbins: int = 8) -> str:
    """How `kernel` brings windows of `src` to its binning: "tma" (a
    tensor-map box of win rows of win + 2 float2 from the even column at
    or left of the window: needs 16-byte row strides, i.e. an even W, an
    even win and a 16-byte aligned base), "cp.async" (8-byte copies into
    the same shared-memory stages), or "direct" (each thread reads the
    stack: for windows whose two stages do not fit in shared memory)."""
    if _staged_smem(kernel, win, nbins) > _SMEM_MAX:
        return "direct"
    W = src.shape[2]
    ok = W % 2 == 0 and win % 2 == 0 and win <= 126 and src.data_ptr() % 16 == 0
    return "tma" if ok else "cp.async"


_ROUTES = {"cp.async": 0, "tma": 1, "direct": 2}


def check_grid(d: int, nbins: int) -> None:
    """Raise ValueError unless the descriptor kernel takes a d x d x nbins
    grid (1 <= d <= 4, 1 <= nbins <= 16)."""
    if not (1 <= d <= MAX_GRID[0] and 1 <= nbins <= MAX_GRID[1]):
        raise ValueError(f"the descriptor kernel takes descriptor_width <= {MAX_GRID[0]} and "
                         f"descriptor_bins <= {MAX_GRID[1]}, got {d} and {nbins}")


def _check(name: str, src, lev, ys, xs, win: int, floats):
    """Validate the inputs; returns True when they lie on the CPU."""
    if src.ndim != 4 or src.shape[-1] != 2 or src.dtype != torch.float32:
        raise ValueError(f"{name}: src must be (S, H, W, 2) float32, got "
                         f"{tuple(src.shape)} {src.dtype}")
    K = lev.shape[0] if lev.ndim == 1 else -1
    for t in (lev, ys, xs):
        if t.dtype != torch.int32 or t.shape != (K,) or t.device != src.device:
            raise ValueError(f"{name}: lev/ys/xs must be (K,) int32 on src's device")
    for t in floats:
        if t.dtype != torch.float32 or t.shape != (K,) or t.device != src.device:
            raise ValueError(f"{name}: per-keypoint values must be (K,) float32 on src's device")
    S, H, W, _ = src.shape
    if not (0 < win <= min(H, W)):
        raise ValueError(f"{name}: window {win} exceeds source {H}x{W}")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {src.device}")
    if K and bool(((lev < 0) | (lev >= S) | (ys < 0) | (ys > H - win) | (xs < 0)
                   | (xs > W - win)).any()):
        raise ValueError(f"{name}: a window lies outside the source")
    if src.device.type == "cpu":
        return True
    if win > MAX_WIN:
        raise ValueError(f"{name} kernel: window {win} > {MAX_WIN}")
    if not all(t.is_contiguous() for t in (src, lev, ys, xs, *floats)):
        raise ValueError(f"{name} kernel: inputs must be contiguous")
    return False


def orient_hist(src, lev, ys, xs, lx, ly, sigma_rel, win: int, chunk: int = 256):
    """(K, 36) raw orientation histograms (before the smoothing passes) of
    the keypoints' windows src[lev[k], ys[k]:ys[k]+win, xs[k]:xs[k]+win],
    each keypoint at (lx[k], ly[k]) in its window with scale sigma_rel[k].

    src (S, H, W, 2) float32 magnitude/angle; lev/ys/xs (K,) int32 with
    every window inside src; lx/ly/sigma_rel (K,) float32. CUDA tensors
    launch the kernel, CPU tensors take the plain version (`chunk` windows
    at a time)."""
    if _check("orient_hist", src, lev, ys, xs, win, (lx, ly, sigma_rel)):
        return orient_hist_plain(src, lev, ys, xs, lx, ly, sigma_rel, win, chunk)
    K = lev.shape[0]
    out = torch.empty((K, ORI_BINS), dtype=torch.float32, device=src.device)
    if K == 0:
        return out
    S, H, W, _ = src.shape
    lib = _build.library()
    err = lib.apst_orient_hist(
        src.data_ptr(), S, H, W, lev.data_ptr(), ys.data_ptr(), xs.data_ptr(), lx.data_ptr(),
        ly.data_ptr(), sigma_rel.data_ptr(), K, win, _ROUTES[copy_route(src, win)],
        out.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(err, "apst_orient_hist")
    trace.launched("orient_hist")
    return out


def descriptor(src, lev, ys, xs, lx, ly, sigma_rel, theta, win: int, d: int = 4,
               nbins: int = 8, chunk: int = 256):
    """(K, d*d*nbins) SIFT descriptors (normalised, clipped at 0.2,
    renormalised) of the keypoints' windows, keypoint k at (lx[k], ly[k])
    with scale sigma_rel[k] and orientation theta[k]. Inputs as
    `orient_hist`; the kernel takes the grids of `check_grid`."""
    if _check("descriptor", src, lev, ys, xs, win, (lx, ly, sigma_rel, theta)):
        return descriptor_plain(src, lev, ys, xs, lx, ly, sigma_rel, theta, win, d, nbins, chunk)
    check_grid(d, nbins)
    K = lev.shape[0]
    out = torch.empty((K, d * d * nbins), dtype=torch.float32, device=src.device)
    if K == 0:
        return out
    S, H, W, _ = src.shape
    lib = _build.library()
    err = lib.apst_sift_descriptor(
        src.data_ptr(), S, H, W, lev.data_ptr(), ys.data_ptr(), xs.data_ptr(), lx.data_ptr(),
        ly.data_ptr(), sigma_rel.data_ptr(), theta.data_ptr(), K, win, d, nbins,
        _ROUTES[copy_route(src, win, "descriptor", nbins)], out.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(err, "apst_sift_descriptor")
    trace.launched("descriptor")
    return out
