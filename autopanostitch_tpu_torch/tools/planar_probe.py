#!/usr/bin/env python3
"""Which stage of the planar scan turns a ~1e-7 change of B1's distances
into decibels of PSNR.

    python3 autopanostitch_tpu_torch/tools/planar_probe.py [--seeds S] [--draws D]

Needs one CUDA GPU and nvcc. Stitches the 3x3 planar scan of chip_smoke.py
(800x600 crops of `synthdata.texture(5, ...)`, 35 % overlap,
`force_planar_scan`, linear blend) with RANSAC seeds 0..S-1 (default 2)
and three k-NN variants:
  rna    B1 as built: 3xTF32, hi of both operands rounded to nearest;
  rz     B1 with the target split truncating (hi = x truncated to TF32), a
         copy of csrc/knn.cu with that one change, built beside it;
  plain  the plain float32 version, on the card.
Then B1 as built again, seed 0, with D (default 4) fresh draws of the
homography BA's subsample of each pair's inliers (`max_matches` = 300 of
them, drawn by `bundle.stratified_subsample` from a generator seeded by the
pair): the same matches, another subset.
For each stitch it prints the candidate matches and how many differ from
the first stitch, the accepted pairs, the RANSAC inliers, the homography
BA's final cost, the registration error of H_abs against the true
translations (RMS and max over a 16 x 12 grid of each image), the
sub-pixel phase of the canvas origin, and the PSNR against the texture of
the pipeline's panorama and of four composites (estimated or true H_abs x
estimated or unit gains), each with the texture sampled bilinearly and with
the renderer's Keys bicubic. Last, the pooled matches of the scene's
features under B1 and plain float32, by the grid step they cross
(`neighbour_split`). Prints one JSON record a line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

W, H, OVERLAP = 800, 600, 0.35
ANCHOR = "// wgmma shared-memory descriptor"
RZ_SPLIT = """__device__ __forceinline__ void split_tf32_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

"""


def build_rz(work: pathlib.Path):
    """B1 with a truncating target split, built from a copy of csrc/."""
    from autopanostitch_tpu_torch.kernels import _build

    src = (_build.CSRC / "knn.cu").read_text()
    if src.count("split_tf32(x.") != 4 or ANCHOR not in src:
        raise RuntimeError("knn.cu: the target split is not where this probe expects it")
    src = src.replace("split_tf32(x.", "split_tf32_rz(x.").replace(ANCHOR, RZ_SPLIT + ANCHOR, 1)
    csrc = work / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    (csrc / "knn.cu").write_text(src)
    saved = _build.CSRC, _build.BUILD_DIR, _build._lib
    _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, work / "_build", None
    try:
        return _build.library()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = saved


def psnr(pano, cover, offset, scale, env, origin) -> dict:
    """{sampler: PSNR dB} of the covered canvas pixels against the texture
    at their positions, sampled bilinearly and with Keys bicubic."""
    import synthdata

    ys, xs = np.nonzero(cover)
    x = (xs + offset[0]) / scale + origin[0]
    y = (ys + offset[1]) / scale + origin[1]
    got = pano[ys, xs].astype(np.float64) / 255.0
    out = {}
    for name, fn in (("bilinear", synthdata._bilinear_np), ("bicubic", synthdata._bicubic_np)):
        e = got - fn(env, x, y)
        out[name] = round(float(10 * np.log10(1.0 / max(np.mean(e**2), 1e-12))), 3)
    return out


def registration(H_abs, offs, a: int):
    """(RMS, max) px of H_abs against the true translations over a grid."""
    gx, gy = np.meshgrid(np.linspace(0, W - 1, 16), np.linspace(0, H - 1, 12))
    p = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], 1)
    errs = []
    for k in range(len(offs)):
        q = p @ np.asarray(H_abs[k], np.float64).T
        errs.append(np.linalg.norm(q[:, :2] / q[:, 2:] - (p[:, :2] + offs[k] - offs[a]), axis=1))
    e = np.concatenate(errs)
    return round(float(np.sqrt(np.mean(e**2))), 5), round(float(e.max()), 5)


def redraw(subsample, draw: int):
    """`subsample` with each pair's generator replaced by one of `draw`."""
    if draw == 0:
        return subsample

    def sub(xy, size, M, mode, rng, **kw):
        return subsample(xy, size, M, mode,
                         np.random.default_rng([draw, int(rng.integers(1 << 62))]), **kw)

    return sub


def stitch_record(variant: str, seed: int, scene, cfg, dev, first):
    """One stitch and its record; returns (record, its candidate matches)."""
    from autopanostitch_tpu_torch import api
    from autopanostitch_tpu_torch.models import planar as planar_stage

    iset, env, offs, images, feathers = scene
    res = api.stitch(iset, cfg, seed=seed, device=str(dev))
    if len(res.panoramas) != 1 or list(res.panoramas[0]["members"]) != list(range(9)):
        raise AssertionError(f"{variant} seed {seed}: components {res.components}")
    pr, g = res.panoramas[0], res.graph
    acc = np.asarray(g.accepted, bool)
    matches = set()
    for p, (i, j) in enumerate(np.asarray(g.pairs)):
        for u, v in np.asarray(g.pair_idx[p])[np.asarray(g.pair_mask[p], bool)]:
            matches.add((int(i), int(j), int(u), int(v)))
    a = int(pr["anchor"])
    rec = dict(variant=variant, seed=seed, pairs=f"{int(acc.sum())}/{len(acc)}",
               matches=len(matches), matches_changed=len(matches ^ first) if first else 0,
               inliers=int(np.asarray(g.num_inliers)[acc].sum()),
               pairs_subsampled=int((np.asarray(g.num_inliers)[acc] > cfg.bundle.max_matches).sum()),
               ba_h_cost=float(pr["hba"]["final_cost"]), anchor=a)
    rec["reg_rms_px"], rec["reg_max_px"] = registration(pr["H_abs"], offs, a)
    gains = np.asarray(pr["gains"], np.float32)
    rec["gains_min_max"] = [round(float(gains.min()), 5), round(float(gains.max()), 5)]
    rec["psnr_pipeline"] = psnr(pr["projections"]["planar"], pr["coverage_by_mode"]["planar"],
                                pr["offset"], pr["scale"], env, offs[a])
    true_H = np.tile(np.eye(3, dtype=np.float32), (9, 1, 1))
    true_H[:, :2, 2] = offs - offs[a]
    for hname, Hs in (("est", np.asarray(pr["H_abs"], np.float32)), ("true", true_H)):
        for gname, gg in (("est", gains), ("unit", np.ones_like(gains))):
            c = planar_stage.composite_from_abs(
                images, feathers, iset.sizes, Hs, np.ones(9, bool), gains=gg, blend_mode="linear",
                bands=cfg.blend.bands, max_megapixel=cfg.render.max_megapixel,
                interp=cfg.render.interpolation)
            rec[f"psnr_H{hname}_g{gname}"] = psnr(c["panorama"], c["coverage"], c["offset"],
                                                 c["scale"], env, offs[a])
            if gname == "est":
                x0, y0 = (o / c["scale"] for o in c["offset"])
                rec[f"phase_H{hname}"] = [round(x0 - round(x0), 4), round(y0 - round(y0), 4)]
    return rec, matches


def neighbour_split(feats, variants: dict, matching) -> dict:
    """Pooled kNN + ratio test of one feature set under each k-NN variant:
    accepted matches by the grid step from the query's crop to its match's
    (h: beside, v: above or below, d: diagonal), and for the queries that
    match diagonally under plain float32 but not under B1, what B1 made of
    them and the two nearest distances of each."""
    N, K, _ = feats.desc.shape
    img = np.repeat(np.arange(N), K)
    out, got = {}, {}
    for name, fn in variants.items():
        matching.knn = fn
        _, nn_dist, best, acc = matching.global_match_stack(feats.desc, feats.mask, k=4)
        d, t, a = nn_dist.cpu().numpy(), img[np.clip(best.cpu().numpy(), 0, N * K - 1)], \
            acc.cpu().numpy()
        dr, dc = np.abs(img // 3 - t // 3), np.abs(img % 3 - t % 3)
        cls = np.where((dr == 0) & (dc == 1), "h", np.where((dr == 1) & (dc == 0), "v",
                       np.where((dr == 1) & (dc == 1), "d", "other")))
        cls = np.where(a, cls, "rejected")
        got[name] = (d, cls)
        out[name] = {c: int((cls == c).sum()) for c in ("h", "v", "d", "other", "rejected")}
    (dk, ck), (dp, cp) = got["rna"], got["plain"]
    rows = (cp == "d") & (ck != "d")
    med = lambda x: float(np.median(x)) if x.size else None  # noqa: E731
    out["diagonal_in_plain_only"] = dict(
        rows=int(rows.sum()), **{f"rna_{c}": int((ck[rows] == c).sum())
                                 for c in ("h", "v", "other", "rejected")},
        rna_d1_zero=int((dk[rows, 0] == 0).sum()), plain_d1_zero=int((dp[rows, 0] == 0).sum()),
        rna_d1_median=med(dk[rows, 0]), rna_d2_median=med(dk[rows, 1]),
        plain_d1_median=med(dp[rows, 0]), plain_d2_median=med(dp[rows, 1]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--draws", type=int, default=4)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("planar_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from autopanostitch_tpu_torch.api import BlendConfig, StitchConfig, StraightenConfig
    from autopanostitch_tpu_torch.kernels import _build
    from autopanostitch_tpu_torch.kernels import knn as K
    from autopanostitch_tpu_torch.models import bundle as bundle_stage
    from autopanostitch_tpu_torch.models import features as features_stage
    from autopanostitch_tpu_torch.models import pipeline
    from autopanostitch_tpu_torch.ops import matching

    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi(), flush=True)
    iset, env, offs = chip_smoke.planar_scene(W, H, OVERLAP)
    images = pipeline._upload(iset.images, dev)
    scene = (iset, env, offs, images, pipeline._feathers(iset.sizes, images))
    cfg = StitchConfig(straighten=StraightenConfig(force_planar_scan=True),
                       blend=BlendConfig(mode="linear"))
    shipped, kernel_knn = _build.library(), matching.knn
    subsample = bundle_stage.stratified_subsample
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    first = None
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        libs = {"rna": shipped, "rz": build_rz(pathlib.Path(work)), "plain": None}
        runs = [(v, seed, 0) for v in libs for seed in range(args.seeds)]
        runs[args.seeds:args.seeds] = [("rna", 0, d) for d in range(1, args.draws + 1)]
        for variant, seed, draw in runs:
            lib = libs[variant]
            _build._lib = lib if lib is not None else shipped
            matching.knn = kernel_knn if lib is not None else K.knn_plain
            bundle_stage.stratified_subsample = redraw(subsample, draw)
            before = K.launches
            rec, matches = stitch_record(variant, seed, scene, cfg, dev, first)
            rec.update(draw=draw, b1_launches=K.launches - before)
            first = first or matches
            print(json.dumps(rec), flush=True)
    _build._lib, matching.knn = shipped, kernel_knn
    bundle_stage.stratified_subsample = subsample
    feats = features_stage.extract_features(images, iset.sizes, cfg.detector)
    split = neighbour_split(feats, {"rna": kernel_knn, "plain": K.knn_plain}, matching)
    matching.knn = kernel_knn
    print(json.dumps({"neighbours": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
