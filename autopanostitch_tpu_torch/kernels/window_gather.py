"""B2: keypoint window gather — CUDA kernel wrapper and plain version.

Port of `gather_windows` (`autopanostitch_tpu/ops/pallas/window_gather.py:78`)
as SIFT's window phases use it (`sift._map_per_kp`). The kernel is
`csrc/window_gather.cu`; it takes EXACT window starts and the channel-last
(S, H, W, 2) magnitude/angle stack of the reference's XLA path.
"""

from __future__ import annotations

import torch

from autopanostitch_tpu_torch.kernels import _build
from autopanostitch_tpu_torch.utils import trace

trace.declare_kernels("window_gather")


def gather_windows_plain(src, lev, ys, xs, rows: int, cols: int):
    """Plain PyTorch version: advanced indexing. (K, rows, cols, C)."""
    dev = src.device
    r = torch.arange(rows, device=dev)
    c = torch.arange(cols, device=dev)
    L = lev.long()[:, None, None]
    Y = ys.long()[:, None, None] + r[None, :, None]
    X = xs.long()[:, None, None] + c[None, None, :]
    return src[L, Y, X]


def gather_windows(src, lev, ys, xs, rows: int, cols: int):
    """out[k] = src[lev[k], ys[k]:ys[k]+rows, xs[k]:xs[k]+cols, :].

    src (S, H, W, 2) float32 contiguous; lev/ys/xs (K,) int32 with windows
    inside the source (callers clip the starts). CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    if src.ndim != 4 or src.shape[-1] != 2 or src.dtype != torch.float32:
        raise ValueError(f"gather_windows: src must be (S, H, W, 2) float32, got "
                         f"{tuple(src.shape)} {src.dtype}")
    for t in (lev, ys, xs):
        if t.dtype != torch.int32 or t.ndim != 1 or t.device != src.device:
            raise ValueError("gather_windows: lev/ys/xs must be (K,) int32 on src's device")
    S, H, W, _ = src.shape
    if not (0 < rows <= H and 0 < cols <= W):
        raise ValueError(f"gather_windows: window {rows}x{cols} exceeds source {H}x{W}")
    if src.device.type == "cpu":
        return gather_windows_plain(src, lev, ys, xs, rows, cols)
    if src.device.type != "cuda":
        raise ValueError(f"gather_windows: unsupported device {src.device}")
    if not (src.is_contiguous() and lev.is_contiguous() and ys.is_contiguous()
            and xs.is_contiguous()):
        raise ValueError("gather_windows kernel: inputs must be contiguous")
    K = lev.shape[0]
    out = torch.empty((K, rows, cols, 2), dtype=torch.float32, device=src.device)
    if K == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.apst_gather_windows(
        src.data_ptr(), S, H, W, lev.data_ptr(), ys.data_ptr(), xs.data_ptr(),
        K, rows, cols, out.data_ptr(), stream,
    )
    _build.check(err, "apst_gather_windows")
    trace.launched("window_gather")
    return out
