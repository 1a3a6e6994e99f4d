"""Planar compositing: warp verified images onto a common canvas (port of
`models/planar.py`, the reference's non-rotational path
`renderPanorama.m pureNonRotationalPanoramas :519-822`).

Output limits over all images -> canvas extent -> per row band of the
canvas: inverse-map warp of every image with its feather as a 4th channel
-> linear, multiband or `none` blend -> uint8. The band split is kept from
the reference: multiband builds its pyramid per 512-row band, so pixels at
band edges only agree with the reference if the bands do.
"""

from __future__ import annotations

import numpy as np
import torch

from autopanostitch_tpu_torch.config import GainConfig
from autopanostitch_tpu_torch.ops import blend as blend_ops
from autopanostitch_tpu_torch.ops import sampling as samp
from autopanostitch_tpu_torch.utils import trace


def chain_to_anchor(pairs: np.ndarray, Hs: np.ndarray, n: int, anchor: int | None = None):
    """Chain pairwise homographies (Hs[p] maps pairs[p, 0] -> pairs[p, 1])
    to absolute ones by BFS from the anchor (default: the max-degree image).
    Returns (H_abs (n, 3, 3) float32 image k -> anchor frame, reachable (n,),
    anchor)."""
    deg = np.zeros(n, int)
    adj: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n)]
    for p, (i, j) in enumerate(pairs):
        H_ij = Hs[p]
        H_ji = np.linalg.inv(H_ij)
        H_ji /= H_ji[2, 2]
        adj[i].append((j, H_ji))
        adj[j].append((i, H_ij))
        deg[i] += 1
        deg[j] += 1
    if anchor is None:
        anchor = int(np.argmax(deg))
    H_abs = np.tile(np.eye(3, dtype=np.float64), (n, 1, 1))
    reachable = np.zeros(n, bool)
    reachable[anchor] = True
    queue = [anchor]
    while queue:
        u = queue.pop(0)
        for v, H_vu in adj[u]:
            if not reachable[v]:
                reachable[v] = True
                Hv = H_abs[u] @ H_vu
                H_abs[v] = Hv / Hv[2, 2]
                queue.append(v)
    return H_abs.astype(np.float32), reachable, anchor


def planar_canvas_bounds(H_abs: np.ndarray, sizes: np.ndarray, reachable: np.ndarray,
                         max_megapixel: float = 50.0, pad: int = 8, device="cuda"):
    """Canvas extent from the reachable images' output limits, with the MP
    cap (`renderPanorama.m:551-569`, `:167-176`). Returns (Hc, Wc, x0, y0,
    scale)."""
    lims = samp.output_limits_batch(
        torch.as_tensor(np.asarray(H_abs, np.float32), device=device),
        torch.as_tensor(np.asarray(sizes), dtype=torch.int32, device=device)).cpu().numpy()
    lims = lims[reachable]
    x0, x1 = lims[:, 0].min() - pad, lims[:, 1].max() + pad
    y0, y1 = lims[:, 2].min() - pad, lims[:, 3].max() + pad
    Wc = int(np.ceil(x1 - x0))
    Hc = int(np.ceil(y1 - y0))
    scale = 1.0
    cap = max_megapixel * 1e6
    if Hc * Wc > cap:
        scale = float(np.sqrt(cap / (Hc * Wc)))
        Hc = max(1, int(np.ceil(Hc * scale)))
        Wc = max(1, int(np.ceil(Wc * scale)))
    # Multiples of 128, as the reference rounds them (there to share XLA
    # programs). The port needs no shape buckets, but the canvas shape and
    # coverage are part of the recorded goldens, so it keeps the rounding;
    # the extra area stays uncovered and the border crop removes it.
    Hc = int(np.ceil(Hc / 128) * 128)
    Wc = int(np.ceil(Wc / 128) * 128)
    return Hc, Wc, float(x0), float(y0), scale


def warp_band(images, feathers, H_inv_canvas, valid, gains, band_h: int, out_w: int,
              x0: float, y0: float, interp: str = "bilinear"):
    """One canvas row band of band_h rows starting at world row y0, every
    image warped into it (gain applied, its feather the weight): colours
    (N, band_h, out_w, 3) and weights (N, band_h, out_w) tensors."""
    N = images.shape[0]
    dev = images.device
    okf = valid.float()
    img4 = torch.cat([images * gains[:, None, None, :], feathers[..., None]], -1)
    fine = samp.upsample2x_cubic(img4) if interp == "bicubic2x" else None
    xs, ys = samp.homography_coords(H_inv_canvas, band_h, out_w, x0, y0)  # (N, bh, w)
    col4, _ = samp.sample_indexed(interp, img4, torch.arange(N, device=dev)[:, None],
                                  xs, ys, fine)
    ws = torch.clamp(col4[..., 3], min=0.0) * okf[:, None, None]
    cols = col4[..., :3] * okf[:, None, None, None]
    return cols, ws


def composite_band(images, feathers, H_inv_canvas, valid, gains, band_h: int, out_w: int,
                   x0: float, y0: float, blend_mode: str = "linear", bands: int = 3,
                   interp: str = "bilinear"):
    """One canvas row band (`warp_band`), blended.
    Returns (uint8 (band_h, out_w, 3), covered (band_h, out_w)) tensors."""
    cols, ws = warp_band(images, feathers, H_inv_canvas, valid, gains, band_h, out_w, x0, y0,
                         interp)
    if blend_mode == "multiband":  # the render kernels' pyramid, uint8 finish included
        return blend_ops.multiband_blend(cols, ws, bands=bands, to_u8=True)
    band = torch.zeros_like(cols[0])
    wsum = torch.zeros_like(ws[0])
    for k in range(cols.shape[0]):  # in image order, as the reference's scan
        if blend_mode == "linear":
            band = band + cols[k] * ws[k][..., None]
        else:  # 'none': the last writer wins (composeNonePolicy 'last')
            band = torch.where((ws[k] > 0)[..., None], cols[k], band)
        wsum = wsum + ws[k]
    if blend_mode == "linear":
        band = band / torch.clamp(wsum, min=1e-8)[..., None]
    covered = wsum > 1e-3
    band = band * covered[..., None]
    return (torch.clamp(band, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8), covered


def composite_from_abs(images, feathers, sizes: np.ndarray, H_abs: np.ndarray,
                       reachable: np.ndarray, gains: np.ndarray | None = None,
                       blend_mode: str = "linear", bands: int = 3, max_megapixel: float = 50.0,
                       band_h: int = 512, gain_cfg: GainConfig | None = None,
                       interp: str = "bilinear"):
    """Composite images (N, H, W, 3) / feathers (N, H, W) tensors with
    absolute homographies H_abs (image k -> canvas frame), on the images'
    device. With gains None and gain_cfg enabled, the planar gains run first
    (reference `gainCompensationH.m`). bicubic2x becomes true bicubic, as in
    the reference: the band compositor warps every full image once per band.
    Returns dict(panorama, coverage, offset, scale, gains) (numpy)."""
    if blend_mode not in ("linear", "multiband", "none"):
        raise ValueError(f"unknown planar blend {blend_mode!r}")
    if interp == "bicubic2x":
        interp = "bicubic"
    dev = images.device
    n = len(sizes)
    Hc, Wc, x0, y0, scale = planar_canvas_bounds(H_abs, sizes, reachable, max_megapixel,
                                                 device=dev)
    S = np.diag([scale, scale, 1.0]).astype(np.float32)
    H_inv = np.stack([np.linalg.inv(S @ H_abs[k]) for k in range(n)])
    H_inv /= H_inv[:, 2:3, 2:3]
    x0s, y0s = x0 * scale, y0 * scale
    if gains is None and gain_cfg is not None and gain_cfg.enabled:
        from autopanostitch_tpu_torch.models import gain as gain_stage

        gains = gain_stage.compute_gains_planar(images, feathers, H_inv.astype(np.float32),
                                                x0s, y0s, (Hc, Wc), gain_cfg)
    if gains is None:
        gains = np.ones((n, 3), np.float32)
    Hi_d = torch.as_tensor(H_inv.astype(np.float32), device=dev)
    ok_d = torch.as_tensor(np.asarray(reachable), device=dev)
    g_d = torch.as_tensor(np.asarray(gains, np.float32), device=dev)
    pano = np.zeros((Hc, Wc, 3), np.uint8)
    cover = np.zeros((Hc, Wc), bool)
    for r0 in range(0, Hc, band_h):
        with trace.span("render.band"):
            band, cov = composite_band(images, feathers, Hi_d, ok_d, g_d, band_h, Wc, x0s,
                                       y0s + float(r0), blend_mode, bands, interp)
            h = min(band_h, Hc - r0)
            pano[r0 : r0 + h] = band[:h].cpu().numpy()
            cover[r0 : r0 + h] = cov[:h].cpu().numpy()
            trace.count("render.bands")
    return {"panorama": pano, "coverage": cover, "offset": (x0s, y0s), "scale": scale,
            "gains": gains}


def render_planar(images, sizes: np.ndarray, pairs: np.ndarray, Hs: np.ndarray, feathers=None,
                  gains: np.ndarray | None = None, blend_mode: str = "linear", bands: int = 3,
                  max_megapixel: float = 50.0, anchor: int | None = None):
    """Planar panorama from verified pairwise homographies, chained without
    joint refinement (`bundle_h.run_bundle_adjustment_h` is the refined
    path the pipeline takes). Returns dict(panorama, coverage, H_abs,
    reachable, anchor, offset, ...)."""
    n = images.shape[0]
    H_abs, reachable, anchor = chain_to_anchor(pairs, Hs, n, anchor)
    if feathers is None:
        feathers = samp.feather_stack(
            torch.as_tensor(np.asarray(sizes), dtype=torch.int32, device=images.device),
            images.shape[1], images.shape[2])
    out = composite_from_abs(images, feathers, sizes, H_abs, reachable, gains, blend_mode,
                             bands, max_megapixel)
    out.update({"H_abs": H_abs, "reachable": reachable, "anchor": anchor})
    return out
