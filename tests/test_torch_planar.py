"""The torch port's planar-scan path against the JAX package: point
samplers, homography warping and output limits, canvas bounds, planar
compositing and the chained planar render, planar gains, the homography
bundle adjustment with its closed-form Jacobians, and the
`config1_planar_pair` golden. The homography LM's graph-safe body (seed and
lambda0 as tensors) equals the first eager loop bit for bit, its bucketed,
padded problem gives the unpadded one's result within the JAX parity
tolerances, and on the CPU it runs eagerly (the card's graph replay:
`tests/test_torch_ba_normals.py`).

Tolerances: samplers, warps and limits atol 1e-5 (float32, same formulas); canvas
bounds equal; composites within one uint8 level (float32 sums in another
order before the rounding) with equal coverage; gains rtol / atol 0.01 and
H_abs rtol 0.02 / atol 0.05 (the golden tolerances); Jacobians against
`torch.func.jacrev` to 1e-4 of their largest entry.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_scenes
import synthdata
from autopanostitch_tpu.config import BundleConfig, GainConfig
from autopanostitch_tpu.models import bundle_h as jbh
from autopanostitch_tpu.models import gain as jgain
from autopanostitch_tpu.models import planar as jplanar
from autopanostitch_tpu.ops import sampling as jsamp
from autopanostitch_tpu_torch.models import bundle as tba
from autopanostitch_tpu_torch.models import bundle_h as tbh
from autopanostitch_tpu_torch.models import gain as tgain
from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.models import planar as tplanar
from autopanostitch_tpu_torch.ops import sampling as tsamp
from autopanostitch_tpu_torch.utils import trace
from autopanostitch_tpu_torch.utils.ba_scene import planar_scene
from test_torch_pipeline import REPO, _assert_golden, one_torch_thread  # noqa: F401

# image k -> anchor (image 0) frame of three 200 x 160 crops, near-translations
H_ABS = np.array([
    np.eye(3),
    [[1.0004, 0.0003, 121.5], [-0.0002, 0.9995, 18.25], [2e-7, 6e-7, 1.0]],
    [[0.9996, -0.0004, 57.75], [0.0003, 1.0003, 71.5], [-3e-7, 4e-7, 1.0]],
], np.float32)


def _views():
    env = synthdata.texture(11, 260, 340)
    views = synthdata.planar_crops(env, [(0, 0, 200, 160), (120, 18, 200, 160),
                                         (58, 72, 200, 160)])
    imgs = np.stack(views).astype(np.float32)
    imgs[1] *= 0.85  # an exposure step for the gains
    sizes = np.array([[160, 200], [150, 200], [160, 190]], np.int32)
    for k, (h, w) in enumerate(sizes):
        imgs[k, h:], imgs[k, :, w:] = 0, 0
    feathers = np.asarray(jsamp.feather_stack(jnp.asarray(sizes), 160, 200))
    return imgs, feathers, sizes


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic", "bicubic2x"])
def test_warp_homography_matches_jax(method):
    img = np.random.default_rng(0).uniform(size=(30, 40, 4)).astype(np.float32)
    H_inv = np.array([[0.9, 0.05, -3.25], [-0.04, 1.1, 2.5], [1e-3, -2e-3, 1.0]], np.float32)
    wj, vj = jsamp.warp_homography(jnp.asarray(img), jnp.asarray(H_inv), 36, 48, 1.5, -2.0,
                                   method=method)
    wt, vt = tsamp.warp_homography(torch.as_tensor(img), torch.as_tensor(H_inv), 36, 48, 1.5,
                                   -2.0, method=method)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-5)
    assert 0.2 < vt.float().mean() < 0.95


@pytest.mark.parametrize("method", ["nearest", "bicubic"])
def test_point_samplers_match_jax(method):
    """Single-image samplers, with half-pixel coordinates among the points
    (nearest rounds them half to even in both packages)."""
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(20, 30, 3)).astype(np.float32)
    x = np.r_[rng.uniform(-2, 32, 400), np.arange(-1, 31) + 0.5].astype(np.float32)
    y = np.r_[rng.uniform(-2, 22, 400), np.full(32, 7.5)].astype(np.float32)
    vj, okj = getattr(jsamp, f"sample_{method}")(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    vt, okt = getattr(tsamp, f"sample_{method}")(torch.as_tensor(img), torch.as_tensor(x),
                                                 torch.as_tensor(y))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-5)


def test_output_limits_and_canvas_bounds_match_jax():
    _, _, sizes = _views()
    Hs = H_ABS.copy()
    Hs[2, 2, 0] = -0.004  # a point of this image maps to infinity
    lj = np.asarray(jsamp.output_limits_batch(jnp.asarray(Hs), jnp.asarray(sizes)))
    lt = tsamp.output_limits_batch(torch.as_tensor(Hs), torch.as_tensor(sizes)).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
    one = tsamp.output_limits(torch.as_tensor(Hs[1]), 150, 200)
    np.testing.assert_allclose([float(v) for v in one], lt[1], rtol=1e-6)
    for reach in ([True, True, True], [True, False, True]):
        for cap in (50.0, 0.05):
            bj = jplanar.planar_canvas_bounds(H_ABS, sizes, np.array(reach), cap)
            bt = tplanar.planar_canvas_bounds(H_ABS, sizes, np.array(reach), cap, device="cpu")
            assert bt == bj


@pytest.mark.parametrize("blend,interp,gain", [("linear", "bilinear", True),
                                               ("multiband", "bicubic2x", False),
                                               ("none", "nearest", False)])
def test_composite_from_abs_matches_jax(blend, interp, gain):
    imgs, feathers, sizes = _views()
    reach = np.array([True, True, True])
    kw = dict(blend_mode=blend, bands=3, band_h=128, interp=interp,
              gain_cfg=GainConfig(grid_stride=3) if gain else None)
    oj = jplanar.composite_from_abs(jnp.asarray(imgs), jnp.asarray(feathers), sizes, H_ABS,
                                    reach, **kw)
    ot = tplanar.composite_from_abs(torch.as_tensor(imgs), torch.as_tensor(feathers), sizes,
                                    H_ABS, reach, **kw)
    assert ot["panorama"].shape == oj["panorama"].shape == (256, 384, 3)
    np.testing.assert_array_equal(ot["coverage"], oj["coverage"])
    diff = np.abs(ot["panorama"].astype(int) - oj["panorama"].astype(int))
    assert diff.max() <= 1, diff.max()
    np.testing.assert_allclose(ot["offset"], oj["offset"], rtol=1e-6)
    np.testing.assert_allclose(ot["gains"], oj["gains"], rtol=0.01, atol=0.01)
    if gain:
        assert ot["gains"][1].mean() > 1.05  # the dimmed image is brightened


def test_planar_gains_match_jax():
    imgs, feathers, sizes = _views()
    Hc, Wc, x0, y0, _ = jplanar.planar_canvas_bounds(H_ABS, sizes, np.ones(3, bool))
    H_inv = np.stack([np.linalg.inv(h) for h in H_ABS]).astype(np.float32)
    H_inv /= H_inv[:, 2:3, 2:3]
    cfg = GainConfig(grid_stride=4)
    gj = jgain.compute_gains_planar(jnp.asarray(imgs), jnp.asarray(feathers), H_inv, x0, y0,
                                    (Hc, Wc), cfg)
    gt = tgain.compute_gains_planar(torch.as_tensor(imgs), torch.as_tensor(feathers), H_inv,
                                    x0, y0, (Hc, Wc), cfg)
    np.testing.assert_allclose(gt, gj, rtol=0.01, atol=0.01)
    Nj, Cj = jgain.overlap_statistics_planar(jnp.asarray(imgs), jnp.asarray(feathers),
                                             jnp.asarray(H_inv), x0, y0, jnp.float32(4),
                                             Hc // 4, Wc // 4, chunk=1000)
    Nt, Ct = tgain.overlap_statistics_planar(torch.as_tensor(imgs), torch.as_tensor(feathers),
                                             torch.as_tensor(H_inv), x0, y0, 4, Hc // 4,
                                             Wc // 4, chunk=1000)
    np.testing.assert_allclose(Nt.numpy(), np.asarray(Nj), rtol=0, atol=2)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=1e-3, atol=300)


def _pair_coords(seed=0, M=120):
    """Noisy correspondences of the three crops (pairs 0-1, 1-2, 0-2) under
    H_ABS, padded per pair with zero weights."""
    rng = np.random.default_rng(seed)
    pairs = np.array([[0, 1], [1, 2], [0, 2]])
    u_i = np.zeros((3, M, 2), np.float32)
    u_j = np.zeros((3, M, 2), np.float32)
    w = np.zeros((3, M), np.float32)
    Hs = []
    for p, (i, j) in enumerate(pairs):
        H_ij = np.linalg.inv(H_ABS[j].astype(np.float64)) @ H_ABS[i]
        H_ij /= H_ij[2, 2]
        Hs.append(H_ij)
        pts = rng.uniform([0, 0], [199, 159], (4000, 2))
        q = np.c_[pts, np.ones(len(pts))] @ H_ij.T
        q = q[:, :2] / q[:, 2:]
        ok = (q[:, 0] > 0) & (q[:, 0] < 199) & (q[:, 1] > 0) & (q[:, 1] < 149)
        m = min(M - 10 * p, int(ok.sum()))
        u_i[p, :m] = pts[ok][:m]
        u_j[p, :m] = q[ok][:m] + rng.normal(0, 0.4, (m, 2))
        w[p, :m] = 1.0
    noise = np.eye(3) + np.array([[2e-3, 1e-3, 0.8], [-1e-3, 1e-3, -0.6], [1e-6, 0, 0]])
    return pairs, np.stack([h @ noise for h in Hs]).astype(np.float32), (u_i, u_j, w)


@pytest.mark.parametrize("keep_pairs", [[0, 1, 2], [0]])
def test_render_planar_matches_jax(keep_pairs):
    """Chained (unrefined) planar render; with pair 0-1 alone image 2 is
    unreachable and stays off the canvas."""
    imgs, _, sizes = _views()
    pairs, Hs, _ = _pair_coords()
    pairs, Hs = pairs[keep_pairs], Hs[keep_pairs]
    oj = jplanar.render_planar(jnp.asarray(imgs), sizes, pairs, Hs)
    ot = tplanar.render_planar(torch.as_tensor(imgs), sizes, pairs, Hs)
    assert ot["anchor"] == oj["anchor"]
    np.testing.assert_array_equal(ot["reachable"], oj["reachable"])
    assert ot["reachable"].sum() == (3 if len(keep_pairs) == 3 else 2)
    np.testing.assert_allclose(ot["H_abs"], oj["H_abs"], rtol=1e-6, atol=1e-5)
    assert ot["panorama"].shape == oj["panorama"].shape
    np.testing.assert_array_equal(ot["coverage"], oj["coverage"])
    diff = np.abs(ot["panorama"].astype(int) - oj["panorama"].astype(int))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("one_direction", [True, False])
def test_homography_ba_matches_jax(one_direction):
    pairs, Hs, coords = _pair_coords()
    cfg = BundleConfig(max_iter_lm=24, h_one_direction=one_direction)
    rj = jbh.run_bundle_adjustment_h(pairs, Hs, coords, 3, cfg)
    rt = tbh.run_bundle_adjustment_h(pairs, Hs, coords, 3, cfg, device="cpu")
    assert rt["anchor"] == rj["anchor"]
    np.testing.assert_array_equal(rt["reachable"], rj["reachable"])
    np.testing.assert_allclose(rt["H_init"], rj["H_init"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rt["H_abs"], rj["H_abs"], rtol=0.02, atol=0.05)
    assert rt["final_cost"] == pytest.approx(rj["final_cost"], rel=0.05)
    # the refinement removed the injected pairwise noise: the anchor frame's
    # offsets agree with the truth to well under a pixel
    G = np.linalg.inv(rt["H_abs"][rt["anchor"]]) @ rt["H_abs"]
    G /= G[:, 2:3, 2:3]
    truth = np.linalg.inv(H_ABS[rt["anchor"]]) @ H_ABS
    assert np.abs(G[:, :2, 2] - truth[:, :2, 2]).max() < 0.5


def _h_args(npairs: int, M: int = 120):
    """The homography LM's inputs on a 3 x 3 planar scan (`planar_scene`),
    its first `npairs` pairs."""
    sc = planar_scene(3, 3, M, seed=3)
    return (torch.as_tensor(sc["params0"]), torch.as_tensor(sc["pairs"][:npairs]),
            torch.as_tensor(sc["u_i"][:npairs]), torch.as_tensor(sc["u_j"][:npairs]),
            torch.as_tensor(sc["w"][:npairs]), torch.ones(npairs, dtype=torch.bool))


def _lm_at(args, nb, pb, seed, cfg, bidir):
    """`_lm_h` on the problem padded to nb cameras and pb pairs."""
    p0, pij, u_i, u_j, w, pv = args
    inp = tbh._lm_inputs(p0, pij, u_i, u_j, w * pv[:, None].to(w.dtype), seed,
                         float(cfg.lambda0), nb, pb)
    return tbh._lm_h(inp, cfg.max_iter_lm, float(cfg.sigma_huber),
                     float(np.sqrt(np.float32(cfg.reg_proj))),
                     float(np.sqrt(np.float32(cfg.reg_det))), bidir)


def _lm_as_first_ported(params0, pair_ij, u_i, u_j, w, pair_valid, seed_idx, cfg, bidir):
    """The eager LM loop as the port first wrote it: the gauge's mask from
    the Python seed index, lambda0 uploaded, no padding."""
    N = params0.shape[0]
    dt = params0.dtype
    sq_proj = float(np.sqrt(np.float32(cfg.reg_proj)))
    sq_det = float(np.sqrt(np.float32(cfg.reg_det)))
    wv = w * pair_valid[:, None].to(dt)
    col_mask = torch.ones(8 * N, dtype=dt)
    col_mask[seed_idx * 8 : seed_idx * 8 + 8] = 0.0
    seed_diag = torch.diag(1.0 - col_mask)
    params = params0
    lam = torch.tensor(cfg.lambda0, dtype=dt)
    cost_new = torch.zeros((), dtype=dt)
    args = (pair_ij, u_i, u_j, wv, cfg.sigma_huber, sq_proj, sq_det, bidir)
    for _ in range(cfg.max_iter_lm):
        H, g, cost = tbh._build(params, *args)
        H = H * col_mask[:, None] * col_mask[None, :]
        g = g * col_mask
        dH = torch.diagonal(H) + 1e-6
        Hd = H + torch.diag(lam * dH) + seed_diag
        L, info = torch.linalg.cholesky_ex(Hd)
        delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
        good = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(good, delta, torch.zeros_like(delta))
        cand = params + delta.reshape(N, 8)
        _, _, cost_new = tbh._build(cand, *args)
        pred = 0.5 * (lam * (delta * dH * delta).sum() - (delta * g).sum())
        rho = (cost - cost_new) / torch.clamp(pred, min=1e-12)
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        params = torch.where(accept, cand, params)
        lam = torch.where(accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                          lam * 4.0)
        lam = torch.clamp(lam, 1e-9, 1e6)
    return params, cost_new


@pytest.mark.parametrize("bidir", [False, True])
def test_graph_safe_lm_equals_the_first_eager_loop(bidir):
    """`_lm_h`, with the seed and lambda0 passed in as tensors and the
    problem unpadded, gives the first eager loop's result bit for bit."""
    args, cfg = _h_args(20), BundleConfig()
    got = _lm_at(args, 9, 20, 4, cfg, bidir)
    ref = _lm_as_first_ported(*args, 4, cfg, bidir)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("npairs", [20, 16])  # 20 pads to 32 pairs; 16 fills its bucket
def test_padded_homography_lm_matches_unpadded(bidir, npairs):
    """`bundle_adjust_h` pads the 9 cameras to 16 and the pairs to their
    bucket; it gives the unpadded problem's homographies and cost within
    `test_homography_ba_matches_jax`'s tolerances. The padded cameras stay
    the identity, and the seed its start, exactly."""
    args, cfg = _h_args(npairs), BundleConfig()
    params, cost = tbh.bundle_adjust_h(*args, 4, cfg=cfg, iters=cfg.max_iter_lm, bidir=bidir)
    ref_p, ref_c = _lm_at(args, 9, npairs, 4, cfg, bidir)
    assert params.shape == (9, 8)
    np.testing.assert_allclose(params.numpy(), ref_p.numpy(), rtol=0.02, atol=0.05)
    assert float(cost) == pytest.approx(float(ref_c), rel=0.05)
    padded, _ = _lm_at(args, 16, 32 if npairs == 20 else 16, 4, cfg, bidir)
    assert torch.equal(padded[:9], params)
    assert torch.equal(padded[9:], torch.eye(3).reshape(1, 9)[:, :8].expand(7, 8))
    assert torch.equal(padded[4], args[0][4])
    assert (params - args[0]).abs().max() > 0.1  # the other cameras moved


def test_homography_lm_runs_eagerly_on_the_cpu():
    """On the CPU `ba_h.lm` is tagged `eager`, and no graph is captured or
    replayed."""
    pairs, Hs, coords = _pair_coords()
    before = (tba.graph_captures, tba.graph_replays, len(tba._graphs))
    records = []
    undo = trace.subscribe(records.append)
    try:
        with trace.stitch(["a", "b", "c"], np.full((3, 2), 160, np.int32)):
            tbh.run_bundle_adjustment_h(pairs, Hs, coords, 3, BundleConfig(max_iter_lm=4),
                                        device="cpu")
    finally:
        undo()
    lm = [s for s in records[0].spans if s.name == "ba_h.lm"]
    assert len(lm) == 1 and lm[0].tags["ran"] == "eager"
    counters = records[0].counters
    assert counters["ba.lm_iterations"] == 4
    assert "ba.graph_captures" not in counters and "ba.graph_replays" not in counters
    assert (tba.graph_captures, tba.graph_replays, len(tba._graphs)) == before


@pytest.mark.parametrize("bidir", [False, True])
def test_closed_form_jacobians_match_jacrev(bidir):
    rng = np.random.default_rng(5)
    p_i = torch.as_tensor(np.eye(3).reshape(9)[:8] + rng.normal(0, [1e-2, 1e-2, 5, 1e-2, 1e-2, 5,
                                                                    1e-4, 1e-4], 8),
                          dtype=torch.float32)
    p_j = torch.as_tensor(np.eye(3).reshape(9)[:8] + rng.normal(0, [1e-2, 1e-2, 5, 1e-2, 1e-2, 5,
                                                                    1e-4, 1e-4], 8),
                          dtype=torch.float32)
    u = torch.as_tensor(rng.uniform(0, 300, (40, 2, 2)), dtype=torch.float32)
    r, J = tbh.match_residual_jac(p_i, p_j, u[:, 0], u[:, 1], bidir)
    for m in range(40):
        ref = torch.func.jacrev(
            lambda pp: tbh.match_residual(pp[:8], pp[8:], u[m, 0], u[m, 1], bidir))(
            torch.cat([p_i, p_j]))
        torch.testing.assert_close(J[m], ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
        torch.testing.assert_close(r[m], tbh.match_residual(p_i, p_j, u[m, 0], u[m, 1], bidir),
                                   rtol=1e-5, atol=1e-3)
    # the residual as the reference writes it
    fn = jbh._match_residual_bidir if bidir else jbh._match_residual_unidir
    ref = np.asarray(fn(jnp.asarray(p_i.numpy()), jnp.asarray(p_j.numpy()),
                        jnp.asarray(u[0, 0].numpy()), jnp.asarray(u[0, 1].numpy())))
    np.testing.assert_allclose(r[0].numpy(), ref, rtol=1e-4, atol=1e-3)
    ps = torch.stack([p_i, p_j])
    rr, Jr = tbh.reg_residual_jac(ps, 0.01, 0.3)
    for n in range(2):
        ref = torch.func.jacrev(lambda p: tbh.reg_residual(p, 0.01, 0.3))(ps[n])
        torch.testing.assert_close(Jr[n], ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
        np.testing.assert_allclose(
            rr[n].numpy(), np.asarray(jbh._reg_residual(jnp.asarray(ps[n].numpy()), 0.01, 0.3)),
            rtol=1e-5, atol=1e-7)


def test_config1_golden_parity():
    iset, cfg = parity_scenes.config1_planar_pair()
    timer = tpipe.StageTimer()
    res = tpipe.stitch(iset, cfg, seed=0, device="cpu", timer=timer)
    with np.load(os.path.join(REPO, "tests", "goldens", "config1_planar_pair.npz")) as z:
        golden = {k: z[k] for k in z.files}
    _assert_golden(parity_scenes.extract_artifacts(iset, res), golden)
    assert "bundle_adjustment_h" in timer.report()
    pano = res.panoramas[0]
    assert pano["projections_cropped"]["planar"].shape[0] < pano["panorama"].shape[0]
