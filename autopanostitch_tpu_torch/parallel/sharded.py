"""The pipeline's stages sharded over ranks (port of `parallel/sharded.py`).

Each rank runs the same call on the same inputs; a collective of
`parallel/mesh.py` stands where the reference's `shard_map` produced the
global array, so every rank returns the whole result. The reference's
parallelism (its `parfor`s) maps to the ranks as:
- images over ranks (`loadImages.m:82-99`): `sharded_extract` runs SIFT,
  kernel B2 included, on a rank's images, then gathers the features;
- the pooled kNN (`featureMatchingGlobal.m`): each rank queries its slice
  of the pool against the whole pool on kernel B1, then gathers the rows;
- pairs over ranks (`imageMatching.m:121-156`): `sharded_verify_pairs`;
- the gain statistics' reduction (`gainCompensationRKf.m:138-147`): grid
  chunks over ranks, partial sums all-reduced;
- canvas tiles over ranks: `sharded_render_tiles` (and full-width bands,
  `sharded_render_bands`).
"""

from __future__ import annotations

import numpy as np
import torch

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.kernels.knn import knn
from autopanostitch_tpu_torch.models import gain as gain_stage
from autopanostitch_tpu_torch.models import render as render_stage
from autopanostitch_tpu_torch.ops import ransac as rs
from autopanostitch_tpu_torch.ops import sift
from autopanostitch_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_sum, gather_rows, shard_bounds, shard_leading,
)


def _on(x, mesh: Mesh, dtype=None) -> torch.Tensor:
    """x (numpy or tensor) as a tensor on the mesh's device."""
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.to(device=mesh.device, dtype=dtype or x.dtype)


def sharded_extract(images, mesh: Mesh, cfg: DetectorConfig):
    """SIFT over images split across ranks (kernel B2's window phases on
    the card). images (N, H, W) gray; padded with zero images to a multiple
    of the mesh size. Returns the SiftFeatures of all N images."""
    imgs = _on(images, mesh, torch.float32)
    N = imgs.shape[0]
    feats = sift.extract_batch(shard_leading(imgs, mesh), cfg)
    return sift.SiftFeatures(*[gather_rows(f, mesh, N) for f in feats])


def sharded_global_knn(desc, mask, image_id, mesh: Mesh, k: int = 4):
    """Pooled kNN with the query axis split across ranks: each rank sends
    its padded slice of queries against the whole pool through kernel B1
    (exhaustive, float32 3xTF32, whatever the config's method and compute
    dtype, as the reference's sharded matcher computes `pairwise_sqdist` in
    float32). Same-image, invalid and self targets are masked; padded and
    invalid queries get the masked row the single-device `global_knn`
    gives them. Returns nn_idx (F, k) int32, nn_dist (F, k) float32."""
    d = _on(desc, mesh, torch.float32).contiguous()
    F = d.shape[0]
    valid = _on(mask, mesh, torch.bool)
    ids = torch.where(valid, _on(image_id, mesh, torch.int32),
                      torch.full((F,), -2, dtype=torch.int32, device=mesh.device)).contiguous()
    lo, _, per = shard_bounds(F, mesh)
    self_idx = torch.arange(lo, lo + per, dtype=torch.int32, device=mesh.device)
    idx, dist = knn(shard_leading(d, mesh), shard_leading(ids, mesh, value=-2), d, ids, k,
                    self_idx=self_idx)
    return gather_rows(idx, mesh, F), gather_rows(dist, mesh, F)


def sharded_verify_pairs(pair_src, pair_dst, pair_mask, generator: torch.Generator, mesh: Mesh,
                         model: str = "projective", batch: int = 512,
                         total: int | None = None, **kw):
    """RANSAC verification with the pair axis split across ranks. Every
    rank draws the minimal sets of ALL pairs from `generator` (seeded alike
    on every rank) in `verify_pairs`' order (`ransac.draw_minimal_sets`),
    so the result does not depend on the split and equals `verify_pairs`
    with the same generator. kw: `verify_pairs`' other options but
    `adaptive_first`, which this path does not take (as the reference's).
    Returns verify_pairs' dict of numpy arrays for all P pairs."""
    if "adaptive_first" in kw or "minimal_sets" in kw:
        raise TypeError("sharded_verify_pairs draws its own minimal sets for a fixed budget")
    mask = np.asarray(pair_mask, bool)
    P = mask.shape[0]
    sets = rs.draw_minimal_sets(mask, model, batch, total, generator, mesh.device)
    lo, hi, _ = shard_bounds(P, mesh)
    out = rs.verify_pairs(np.asarray(pair_src)[lo:hi], np.asarray(pair_dst)[lo:hi], mask[lo:hi],
                          model=model, batch=batch, total=total, minimal_sets=sets[lo:hi],
                          device=mesh.device, **kw)
    return {key: gather_rows(_on(v, mesh), mesh, P).cpu().numpy() for key, v in out.items()}


def multichip_pipeline_step(mesh: Mesh, cfg: DetectorConfig):
    """One sharded pipeline step: SIFT over the ranks' images, the pooled
    2-NN with sharded queries, RANSAC with sharded pairs, and the sum of
    gain statistics over ranks: the reference's `parfor` stages in one
    call, as the JAX package's jitted step.

    Returns step(images (N, H, W), pair_src, pair_dst, pair_mask, generator,
    gain_overlap, gain_colors) -> dict of n_keypoints, nn_idx, nn_dist, H,
    accepted, gain_overlap, gain_colors (each rank's partial statistics in,
    their sums out)."""

    def step(images, pair_src, pair_dst, pair_mask, generator, gain_overlap, gain_colors):
        feats = sharded_extract(images, mesh, cfg)
        N, K, D = feats.desc.shape
        ids = torch.arange(N, dtype=torch.int32, device=mesh.device).repeat_interleave(K)
        mask = feats.mask.reshape(N * K)
        nn_idx, nn_dist = sharded_global_knn(feats.desc.reshape(N * K, D), mask, ids, mesh, k=2)
        ver = sharded_verify_pairs(pair_src, pair_dst, pair_mask, generator, mesh)
        ov, cs = psum_gain_stats(gain_overlap, gain_colors, mesh)
        return {"n_keypoints": int(mask.sum()), "nn_idx": nn_idx, "nn_dist": nn_dist,
                "H": ver["H"], "accepted": ver["accepted"], "gain_overlap": ov,
                "gain_colors": cs}

    return step


def _gather_tiles(tiles, covs, T: int, mesh: Mesh):
    """Every rank's rendered tiles (rank d holds tiles d::size) back in
    tile order, tensors on the mesh's device."""
    per = -(-T // mesh.size)
    n_all = per * mesh.size
    t_all = gather_rows(_on(tiles, mesh), mesh, n_all)
    c_all = gather_rows(_on(covs, mesh), mesh, n_all)
    pos = np.arange(n_all)
    t_idx = pos // per + (pos % per) * mesh.size  # slot j of rank d holds tile d + j size
    ok = np.nonzero(t_idx < T)[0]
    idx = torch.as_tensor(ok[np.argsort(t_idx[ok])], device=mesh.device)
    return t_all[idx], c_all[idx]


def sharded_render_bands(images, feathers, R, K, gains, canvas: dict, mesh: Mesh,
                         blend_mode: str = "linear", bands: int = 3, angle_power: float = 1.0):
    """Rotational render with full-width canvas row bands split across
    ranks: each rank renders one band of ceil(Hc / size) rows (rounded up to
    8) with every image a contributor, bilinear; the bands are gathered.
    Returns (panorama (Hc_pad, Wc, 3) uint8, coverage) numpy with Hc_pad
    the band-aligned height (trim to canvas["Hc"])."""
    imgs = _on(images, mesh, torch.float32)
    N = imgs.shape[0]
    Wc = canvas["Wc"]
    band_h = -(-canvas["Hc"] // mesh.size)
    band_h = (band_h + 7) // 8 * 8
    sel = np.arange(N, dtype=np.int32)[None]
    origin = np.array([[0.0, mesh.rank * band_h]], np.float32)
    tile, cov = render_stage.render_tile_list(
        imgs, _on(feathers, mesh, torch.float32), np.asarray(R, np.float32).reshape(-1, 3, 3),
        np.asarray(K, np.float32).reshape(-1, 3, 3), np.asarray(gains, np.float32), None, sel,
        np.ones_like(sel, bool), origin, canvas, (band_h, Wc), blend_mode, bands, angle_power,
        "bilinear")
    n_rows = band_h * mesh.size
    pano = gather_rows(_on(tile[0], mesh), mesh, n_rows).cpu().numpy()
    cover = gather_rows(_on(cov[0], mesh), mesh, n_rows).cpu().numpy()
    return pano, cover


def sharded_render_tiles(images, feathers, R, K, canvas: dict, mesh: Mesh, gains=None,
                         blend_mode: str = "multiband", bands: int = 3, tile=(512, 512),
                         angle_power: float = 1.0, sizes=None, max_contributors=None,
                         interp: str = "bicubic", k1=None):
    """Rotational render with the canvas tiles split across ranks: the same
    tile grid and contributor culling as `render.render_rotational`, rank d
    rendering tiles d, d + size, d + 2 size, ... (neighbouring tiles on
    different ranks balance a busy region); the tiles are gathered and
    assembled on every rank. Returns (panorama (Hc, Wc, 3) uint8, coverage
    (Hc, Wc) bool) numpy, the single-device render's."""
    imgs = _on(images, mesh, torch.float32)
    N = imgs.shape[0]
    if gains is None:
        gains = np.ones((N, 3), np.float32)
    if sizes is None:
        sizes = np.tile(np.array(imgs.shape[1:3], np.int32), (N, 1))
    C_arg = None if max_contributors is None else min(max_contributors, N)
    sel, sel_ok, origins = render_stage.tile_contributors(canvas, R, K, sizes, tuple(tile), C_arg,
                                                          k1=k1, device=mesh.device)
    T = len(sel)
    mine = np.arange(mesh.rank, T, mesh.size)
    tiles, covs = render_stage.render_tile_list(
        imgs, _on(feathers, mesh, torch.float32), R, K, gains, k1, sel[mine], sel_ok[mine],
        origins[mine], canvas, tuple(tile), blend_mode, bands, angle_power, interp)
    tiles, covs = _gather_tiles(tiles, covs, T, mesh)
    pano, cover = render_stage.assemble_tiles(tiles, covs, origins, canvas["Hc"], canvas["Wc"])
    return pano.cpu().numpy(), cover.cpu().numpy()


def sharded_gain_stats_imagespace(images, feathers, sizes, R, K, mesh: Mesh, stride: int = 5,
                                  chunk: int = 512, k1=None):
    """Image-space gain statistics with the strided grid's points split
    across ranks: the points run in `chunk`-point chunks, their count
    padded to a multiple of the mesh size, a contiguous run of chunks a
    rank; each rank sums `gain.overlap_statistics_imagespace` over its
    points and the partial sums are all-reduced. Returns (Nij (N, N),
    sumC (N, N, 3)) tensors, the same on every rank, for `solve_gains`."""
    imgs = _on(images, mesh, torch.float32)
    _, H, W, _ = imgs.shape
    n_points = len(range(0, H, stride)) * len(range(0, W, stride))
    nchunks = -(-n_points // chunk)
    per = -(-nchunks // mesh.size) * chunk
    points = slice(mesh.rank * per, (mesh.rank + 1) * per)
    Nij, sumC = gain_stage.overlap_statistics_imagespace(
        imgs, _on(feathers, mesh, torch.float32), _on(sizes, mesh, torch.int32),
        _on(R, mesh, torch.float32), _on(K, mesh, torch.float32), stride,
        k1=None if k1 is None else _on(k1, mesh, torch.float32), points=points)
    return all_reduce_sum(Nij, mesh), all_reduce_sum(sumC, mesh)


def psum_gain_stats(local_overlap, local_colorsum, mesh: Mesh):
    """The sums over ranks of each rank's partial gain statistics ((N, N)
    overlap counts, (N, N, 3) colour sums), on every rank: the reference's
    parfor reduction (`gainCompensationRKf.m:138-147`)."""
    return (all_reduce_sum(_on(local_overlap, mesh), mesh),
            all_reduce_sum(_on(local_colorsum, mesh), mesh))
