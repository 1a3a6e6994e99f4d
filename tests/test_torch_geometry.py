"""Parity of the torch port's geometry and projections with the JAX package.

Same numpy inputs (from a seed) go through `autopanostitch_tpu.ops` and
`autopanostitch_tpu_torch.ops`; results agree to rtol/atol 1e-5 (float32
arithmetic in another order) unless a test states otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autopanostitch_tpu.ops import geometry as jgeo
from autopanostitch_tpu.ops import projections as jproj
from autopanostitch_tpu_torch.ops import geometry as tgeo
from autopanostitch_tpu_torch.ops import projections as tproj
from test_torch_pipeline import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _homographies(rng, n):
    H = np.eye(3, dtype=np.float32)[None] + 0.1 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    H[:, 2, :2] *= 0.01
    H[:, :2, 2] *= 300.0
    return H


def _matches(rng, M=40, noise=0.3):
    H = _homographies(rng, 1)[0]
    src = rng.uniform(0, 300, (M, 2)).astype(np.float32)
    ph = np.concatenate([src, np.ones((M, 1), np.float32)], 1) @ H.T
    dst = (ph[:, :2] / ph[:, 2:]).astype(np.float32) + noise * rng.standard_normal((M, 2)).astype(np.float32)
    return src, dst.astype(np.float32)


def test_homography_apply_inverse_and_validity():
    rng = np.random.default_rng(0)
    H = _homographies(rng, 16)
    pts = rng.uniform(0, 300, (16, 25, 2)).astype(np.float32)
    ref = np.stack([np.asarray(jgeo.homography_apply(jnp.asarray(H[i]), jnp.asarray(pts[i])))
                    for i in range(16)])
    np.testing.assert_allclose(tgeo.homography_apply(_t(H), _t(pts)).numpy(), ref, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tgeo.inv3x3(_t(H)).numpy(), np.asarray(jgeo.inv3x3(jnp.asarray(H))), **TOL)
    np.testing.assert_allclose(tgeo.homography_inverse(_t(H)).numpy(),
                               np.asarray(jgeo.homography_inverse(jnp.asarray(H))), **TOL)
    bad = H.copy()
    bad[3] = 0.0
    bad[5, 0, 0] = np.nan
    np.testing.assert_array_equal(tgeo.homography_is_valid(_t(bad)).numpy(),
                                  np.asarray(jgeo.homography_is_valid(jnp.asarray(bad))))


def test_hartley_and_dlt_fit():
    rng = np.random.default_rng(1)
    src, dst = _matches(rng)
    w = rng.uniform(0.2, 1.0, len(src)).astype(np.float32)
    n_j, T_j = jgeo.hartley_normalize(jnp.asarray(src), jnp.asarray(w))
    n_t, T_t = tgeo.hartley_normalize(_t(src), _t(w))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), **TOL)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=1e-5, atol=1e-4)
    H_j = np.asarray(jgeo.fit_homography_dlt(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    H_t = tgeo.fit_homography_dlt(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(H_t, H_j, rtol=1e-4, atol=1e-4)


def test_chol_solve_small_and_4pt():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((32, 8, 8)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 8 * np.eye(8, dtype=np.float32)
    b = rng.standard_normal((32, 8)).astype(np.float32)
    ref = np.asarray(jgeo.chol_solve_small(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(tgeo.chol_solve_small(_t(A), _t(b)).numpy(), ref, rtol=1e-4, atol=1e-5)
    src, dst = _matches(rng, M=4, noise=0.0)
    ref = np.asarray(jgeo.fit_homography_4pt(jnp.asarray(src), jnp.asarray(dst), jnp.ones(4)))
    np.testing.assert_allclose(tgeo.fit_homography_4pt(_t(src), _t(dst)).numpy(), ref,
                               rtol=1e-4, atol=1e-4)
    # degenerate (collinear) minimal set stays finite through the clamped pivot
    src[:, 1] = src[:, 0]
    assert np.isfinite(tgeo.fit_homography_4pt(_t(src), _t(dst)).numpy()).all()


def test_symmetric_transfer_error():
    rng = np.random.default_rng(3)
    src, dst = _matches(rng, M=50, noise=2.0)
    H = _homographies(rng, 1)[0]
    ref = np.asarray(jgeo.symmetric_transfer_error(jnp.asarray(H), jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(tgeo.symmetric_transfer_error(_t(H), _t(src), _t(dst)).numpy(),
                               ref, rtol=1e-5, atol=1e-3)


def test_so3_exp_log_project_build_K():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 3)).astype(np.float32)
    w[:8] *= 1e-5  # small-angle branch
    w[8:16] = w[8:16] / np.linalg.norm(w[8:16], axis=1, keepdims=True) * 3.1  # near pi
    Rj = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
    Rt = tgeo.so3_exp(_t(w)).numpy()
    np.testing.assert_allclose(Rt, Rj, **TOL)
    np.testing.assert_allclose(tgeo.so3_log(_t(Rj)).numpy(), np.asarray(jgeo.so3_log(jnp.asarray(Rj))),
                               rtol=1e-4, atol=1e-4)
    M = Rj + 0.01 * rng.standard_normal(Rj.shape).astype(np.float32)
    np.testing.assert_allclose(tgeo.project_to_so3(_t(M)).numpy(),
                               np.asarray(jgeo.project_to_so3(jnp.asarray(M))), **TOL)
    f = rng.uniform(200, 800, 5).astype(np.float32)
    np.testing.assert_allclose(tgeo.build_K(_t(f), 100.0, 80.0).numpy(),
                               np.asarray(jgeo.build_K(jnp.asarray(f), 100.0, 80.0)), **TOL)
    K = np.asarray(jgeo.build_K(jnp.asarray(f), 100.0, 80.0))
    np.testing.assert_allclose(tgeo.invert_K(_t(K)).numpy(), np.asarray(jgeo.invert_K(jnp.asarray(K))), **TOL)


@pytest.mark.parametrize("mode", ["spherical", "equirectangular"])
def test_pano_ray_roundtrip(mode):
    rng = np.random.default_rng(5)
    xp = rng.uniform(0, 900, (7, 11)).astype(np.float32)
    yp = rng.uniform(0, 300, (7, 11)).astype(np.float32)
    args = (350.0, -np.pi, -0.6)
    dj = np.asarray(jproj.pano_to_ray(mode, jnp.asarray(xp), jnp.asarray(yp), *args))
    dt = tproj.pano_to_ray(mode, _t(xp), _t(yp), *args).numpy()
    np.testing.assert_allclose(dt, dj, **TOL)
    uj, vj, _ = jproj.ray_to_pano(mode, jnp.asarray(dj))
    ut, vt, ok = tproj.ray_to_pano(mode, _t(dj))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)
    assert ok.all()


def test_distortion_and_camera_projection():
    rng = np.random.default_rng(6)
    u = rng.uniform(-50, 450, 200).astype(np.float32)
    v = rng.uniform(-50, 350, 200).astype(np.float32)
    k1, cx, cy = -0.05, 199.5, 149.5
    for jf, tf in ((jproj.undistort_pixels, tproj.undistort_pixels),
                   (jproj.distort_pixels, tproj.distort_pixels)):
        aj = jf(jnp.asarray(u), jnp.asarray(v), k1, cx, cy)
        at = tf(_t(u), _t(v), k1, cx, cy)
        for x, y in zip(at, aj):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-3)
    d = rng.standard_normal((30, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    R = np.asarray(jgeo.so3_exp(jnp.asarray([0.1, 0.3, -0.05], jnp.float32)))
    K = np.asarray(jgeo.build_K(300.0, cx, cy))
    for k in (None, 0.04):
        ref = jproj.project_ray_to_camera(jnp.asarray(d), jnp.asarray(R), jnp.asarray(K),
                                          k1=None if k is None else jnp.float32(k))
        out = tproj.project_ray_to_camera(_t(d), _t(R), _t(K),
                                          k1=None if k is None else torch.tensor(k))
        front = np.asarray(ref[2])
        np.testing.assert_array_equal(out[2].numpy(), front)
        for x, y in zip(out[:2], ref[:2]):
            np.testing.assert_allclose(x.numpy()[front], np.asarray(y)[front], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), **TOL)


def test_other_projections_raise():
    """The five projections of the reference are ported
    (tests/test_torch_projections.py); an unknown one raises."""
    with pytest.raises(ValueError, match="projection"):
        tproj.pano_to_ray("fisheye", torch.zeros(2), torch.zeros(2), 1.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="projection"):
        tproj.ray_to_pano("fisheye", torch.zeros(2, 3))


_FITS = ["affine", "similarity", "rigid", "translation"]
_MIN_PTS = {"affine": 3, "similarity": 2, "rigid": 2, "translation": 1}


def _affine_matches(rng, shape, noise=0.4):
    """(..., M, 2) src/dst of a random affine map with noise and 30 % outliers."""
    src = rng.uniform(0, 300, shape + (2,)).astype(np.float32)
    A = np.eye(2) + 0.1 * rng.standard_normal((2, 2))
    dst = src @ A.T.astype(np.float32) + rng.uniform(-60, 60, 2).astype(np.float32)
    dst = dst + noise * rng.standard_normal(dst.shape).astype(np.float32)
    bad = rng.random(shape) < 0.3
    dst[bad] = rng.uniform(0, 300, (int(bad.sum()), 2))
    return src, dst.astype(np.float32)


def _jax_fit(name, src, dst, w):
    """The JAX fit mapped over every leading axis."""
    import jax

    fn = getattr(jgeo, f"fit_{name}")
    for _ in range(src.ndim - 2):
        fn = jax.vmap(fn)
    return np.asarray(fn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))


@pytest.mark.parametrize("name", _FITS)
def test_non_projective_fits_match_jax(name):
    """Batched over leading axes: (P, B, p, 2) minimal sets with unit
    weights and (P, M, 2) weighted refits (0/1 and IRLS-like weights).
    Within 1e-5 of H's largest entry; translation exactly."""
    rng = np.random.default_rng(40 + _FITS.index(name))
    fn = getattr(tgeo, f"fit_{name}")
    p = _MIN_PTS[name]
    src_m, dst_m = _affine_matches(rng, (3, 16, p), noise=0.0)
    src_r, dst_r = _affine_matches(rng, (5, 60))
    w01 = (rng.random((5, 60)) < 0.7).astype(np.float32)
    w_irls = np.where(w01 > 0, 1.0 / np.maximum(rng.uniform(0, 1, (5, 60)), 0.5), 0.0)
    cases = [(src_m, dst_m, np.ones((3, 16, p), np.float32)), (src_r, dst_r, w01),
             (src_r, dst_r, w_irls.astype(np.float32))]
    for src, dst, w in cases:
        ref = _jax_fit(name, src, dst, w)
        got = fn(_t(src), _t(dst), _t(w)).numpy()
        assert got.shape == ref.shape
        if name == "translation":
            np.testing.assert_array_equal(got, ref)
        else:
            scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
            assert (np.abs(got - ref) <= 1e-5 * scale).all(), np.abs(got - ref).max()


def test_weighted_median_ties_and_zero_weights():
    """Stable sort + left-side search: equal values keep their order, zero
    weights are skipped, uniform weights give the lower median."""
    vals = np.array([[3.0, 1.0, 2.0, 2.0, 5.0, 4.0], [1.0, 1.0, 1.0, 0.0, 9.0, 9.0]], np.float32)
    w = np.array([[1, 1, 1, 1, 1, 1], [0, 0, 1, 1, 1, 0]], np.float32)
    ref = np.asarray(jnp.stack([jgeo._weighted_median(jnp.asarray(v), jnp.asarray(x))
                                for v, x in zip(vals, w)]))
    got = tgeo._weighted_median(_t(vals), _t(w)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [2.0, 1.0])


def test_singular_affine_system_stays_nonfinite_without_raising():
    """Coincident points make the 2x2 system singular up to its 1e-8 ridge:
    the fit returns what the solve gives and the validity check rejects it."""
    src = np.zeros((1, 3, 2), np.float32)
    dst = np.ones((1, 3, 2), np.float32)
    H = tgeo.fit_affine(_t(src), _t(dst), torch.ones(1, 3))
    ref = _jax_fit("affine", src, dst, np.ones((1, 3), np.float32))
    np.testing.assert_allclose(H.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_solve2x2_is_bit_exact_with_jnp_solve():
    """The affine fit's 2x2 solve rounds as `jnp.linalg.solve` does on the
    CPU, pivoting included, on systems across eight decades of scale."""
    import jax

    rng = np.random.default_rng(9)
    A = (rng.standard_normal((4000, 2, 2)) * rng.uniform(0.1, 1e4, (4000, 1, 1))).astype(np.float32)
    B = (100 * rng.standard_normal((4000, 2, 2))).astype(np.float32)
    ref = np.asarray(jax.vmap(jnp.linalg.solve)(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_array_equal(tgeo.solve2x2(_t(A), _t(B)).numpy(), ref)
