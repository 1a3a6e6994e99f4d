"""Parity of the torch port's bundle adjustment with the JAX package.

The host helpers are numpy copies and must give identical results. The
device LM runs from the same match graph in both packages: focals agree to
rtol 0.005 and rotations to atol 0.01 (the golden tolerances of
tests/test_parity.py), float32 solves taking another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from autopanostitch_tpu.config import BundleConfig
from autopanostitch_tpu.models import bundle as jba
from autopanostitch_tpu_torch.models import bundle as tba
from test_torch_pipeline import one_torch_thread  # noqa: F401


def _ring_graph(n, f, size, yaw_step, n_matches=80, noise=0.3, seed=0, k1=0.0):
    """Rotational cameras (a yaw sweep, optionally a full ring) with noisy
    reprojected matches laid out as pipeline-level graph arrays."""
    rng = np.random.default_rng(seed)
    h, w = size
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1.0]])
    Rs = []
    for i in range(n):
        c, s = np.cos(i * yaw_step), np.sin(i * yaw_step)
        tilt = np.asarray(jba.geo.so3_exp(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32)))
        Rs.append(tilt @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]).T)
    pairs, Hs, u_is, u_js = [], [], [], []
    counts = np.zeros((n, n), int)
    M = 128
    for i in range(n):
        for j in range(i + 1, n):
            H = K @ Rs[j] @ Rs[i].T @ np.linalg.inv(K)
            pts = rng.uniform([8, 8], [w - 8, h - 8], size=(600, 2))
            ph = np.concatenate([pts, np.ones((600, 1))], -1) @ H.T
            q = ph[:, :2] / ph[:, 2:3]
            ok = (ph[:, 2] > 0) & (q[:, 0] > 5) & (q[:, 0] < w - 5) & (q[:, 1] > 5) & (q[:, 1] < h - 5)
            if ok.sum() < 15:
                continue
            sel = np.nonzero(ok)[0][:n_matches]
            ui = np.zeros((M, 2), np.float32)
            uj = np.zeros((M, 2), np.float32)
            ui[: len(sel)] = pts[sel]
            uj[: len(sel)] = q[sel] + noise * rng.normal(size=(len(sel), 2))
            pairs.append((i, j))
            Hs.append(H / H[2, 2])
            u_is.append(ui)
            u_js.append(uj)
            counts[i, j] = counts[j, i] = len(sel)
    pairs = np.array(pairs)
    P = len(pairs)
    mask = np.zeros((P, M), bool)
    xy = np.zeros((n, P * M, 2), np.float32)
    pair_idx = np.zeros((P, M, 2), np.int32)
    for p, (i, j) in enumerate(pairs):
        mask[p, : counts[i, j]] = True
        xy[i, p * M:(p + 1) * M] = u_is[p]
        xy[j, p * M:(p + 1) * M] = u_js[p]
        pair_idx[p, :, 0] = pair_idx[p, :, 1] = np.arange(p * M, (p + 1) * M)
    sizes = np.tile(np.array(size, np.int32), (n, 1))
    return dict(members=np.arange(n), pairs=pairs, pair_idx=pair_idx, pair_mask=mask,
                inliers=mask.copy(), Hs=np.stack(Hs).astype(np.float32), xy=xy, counts=counts,
                sizes=sizes)


def test_host_helpers_identical():
    g = _ring_graph(6, 300.0, (256, 320), 0.45, seed=1)
    for method in ("shumSzeliskiOneHPaper", "wConstraint"):
        assert tba.estimate_focal(g["pairs"], g["Hs"], g["sizes"], method) == \
            jba.estimate_focal(g["pairs"], g["Hs"], g["sizes"], method)
    tree = jba.max_spanning_tree(g["counts"])
    assert tba.max_spanning_tree(g["counts"]) == tree
    f0 = jba.estimate_focal(g["pairs"], g["Hs"], g["sizes"])
    pair_H = {(int(i), int(j)): g["Hs"][p] for p, (i, j) in enumerate(g["pairs"])}
    Rj = jba.propagate_rotations(6, tree, pair_H, g["sizes"], f0, 0)
    np.testing.assert_array_equal(tba.propagate_rotations(6, tree, pair_H, g["sizes"], f0, 0), Rj)
    assert tba.rotation_consistency(g["pairs"], g["Hs"], g["sizes"], Rj, f0) == \
        jba.rotation_consistency(g["pairs"], g["Hs"], g["sizes"], Rj, f0)
    assert tba.incremental_order(g["counts"], np.arange(6), 2) == \
        jba.incremental_order(g["counts"], np.arange(6), 2)
    pts = np.random.default_rng(0).uniform(0, 300, (200, 2))
    for mode in ("random", "grid", "polar"):
        a = tba.stratified_subsample(pts, (256, 320), 50, mode, np.random.default_rng(7))
        b = jba.stratified_subsample(pts, (256, 320), 50, mode, np.random.default_rng(7))
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        tba._cpinv_focal(np.array([0, 1, 3, 7]), 5.0, 2.0),
        jba._cpinv_focal(np.array([0, 1, 3, 7]), 8, 5.0, 2.0)[:4, :4], rtol=1e-6)


@pytest.mark.parametrize("scene,k1", [("ring", True), ("sweep", False)])
def test_run_bundle_adjustment_parity(scene, k1):
    if scene == "ring":  # full 360 degrees: rotations pass through pi
        g = _ring_graph(10, 300.0, (256, 320), 2 * np.pi / 10, seed=2)
    else:
        g = _ring_graph(5, 350.0, (256, 320), 0.4, seed=3)
    cfg = BundleConfig(incremental_lm_iters=8, max_iter_lm=24, estimate_distortion=k1)
    args = (g["members"], g["pairs"], g["pair_idx"], g["pair_mask"], g["inliers"], g["Hs"],
            g["xy"], g["counts"], g["sizes"], cfg)
    ref = jba.run_bundle_adjustment(*args)
    got = tba.run_bundle_adjustment(*args, device="cpu")
    for key in ("focal_init", "seed", "no_rotation"):
        assert got[key] == ref[key], key
    np.testing.assert_array_equal(got["pairs"], ref["pairs"])
    np.testing.assert_allclose(got["cameras"].f.numpy(), np.asarray(ref["cameras"].f), rtol=0.005)
    np.testing.assert_allclose(got["cameras"].R.numpy(), np.asarray(ref["cameras"].R), atol=0.01)
    assert (got["cameras"].k1 is None) == (ref["cameras"].k1 is None)
    if k1:
        np.testing.assert_allclose(got["cameras"].k1.numpy(), np.asarray(ref["cameras"].k1),
                                   atol=2e-3)
