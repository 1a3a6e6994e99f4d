"""Parity of the torch port's detectors and binary matching with the JAX
package, on the same numpy images.

- Response maps (Harris, FAST, DoH, KAZE's sigma-sized DoH) within 1e-5 of
  each map's largest magnitude (float32 sums in another order).
- KAZE's nonlinear levels: FED's long explicit steps (tau up to 16.7
  against the 0.25 stability limit) amplify float32 rounding made in
  another order. Measured here: levels 0-3 within 1e-5, 4-5 within 3e-4,
  6 within 4e-2, and level 7 up to 0.5 apart, where the scheme is unstable
  in both packages (its range grows past level 6's). Levels 0-5 are held
  within 1e-3, level 6 within 0.1, level 7 within 1.0, and all to the
  conserved image mean (1e-5). KAZE's keypoints are held to >= 95 % at
  the same pixel and scale (measured 96-100 %) and its descriptors to
  1e-4 on >= 90 % of them (measured 92-94 %); those of keypoints on
  levels 0-5 all within 2e-3 (measured 8.3e-4), those on levels 6-7
  within 0.25 and at cosine >= 0.5 to the reference's (measured 0.23 and
  0.63 on the worst of 0-3 such keypoints an image).
- Keypoints: per-image counts within rtol 0.02 / atol 3 (tests/
  test_parity.py's tolerance) and >= 98 % of the reference's keypoints at
  the same pixel; binary descriptors of matched keypoints bit-equal on
  >= 99 % of them (an ulp of cos / sin can move a BRIEF sample across a
  pixel edge); float descriptors within 1e-4 on >= 99 % of matched
  keypoints and within 1e-3 (test_torch_sift.py's tolerance) on all: the
  descriptor rounds its soft-bin weights to bfloat16, as the reference
  does, and a level that differs from the reference's by an ulp (a float32
  convolution summed in another order) can move a weight across a bfloat16
  rounding edge. Measured here: 1 element of 32,640 off by 1.1e-4.
- Hamming: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthdata
from autopanostitch_tpu.config import DetectorConfig
from autopanostitch_tpu.models import features as jfeat
from autopanostitch_tpu.ops import corners as jcorners
from autopanostitch_tpu.ops import doh as jdoh
from autopanostitch_tpu.ops import hamming as jham
from autopanostitch_tpu.ops import kaze as jkaze
from autopanostitch_tpu.ops import sift as jsift
from autopanostitch_tpu_torch.models import features as tfeat
from autopanostitch_tpu_torch.ops import corners as tcorners
from autopanostitch_tpu_torch.ops import doh as tdoh
from autopanostitch_tpu_torch.ops import hamming as tham
from autopanostitch_tpu_torch.ops import kaze as tkaze
from test_torch_pipeline import one_torch_thread  # noqa: F401

CFG = DetectorConfig(max_keypoints=256)


def _views(n=2, size=(192, 144), seed=31):
    _, views, _, _ = synthdata.rotational_views(seed, n_views=n, f=200.0, size=size,
                                                yaw_step=0.42)
    rgb = np.stack(views).astype(np.float32)
    return rgb, np.asarray(jsift.rgb_to_gray(jnp.asarray(rgb)))


def _close_to_max(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= rel * scale, (np.abs(got - ref).max(), scale)


def _pixel_matches(fj, ft, i, with_scale=False):
    """Reference keypoints of image i found by the port at the same pixel
    (and scale): (fraction, reference indices, port indices)."""
    mj, mt = np.asarray(fj.mask[i]), ft.mask[i].numpy()
    kj = np.round(np.asarray(fj.xy[i])).astype(np.int64)
    kt = np.round(ft.xy[i].numpy()).astype(np.int64)
    if with_scale:
        kj = np.concatenate([kj, np.round(np.asarray(fj.scale[i]) * 1e4)[:, None]], 1)
        kt = np.concatenate([kt, np.round(ft.scale[i].numpy() * 1e4)[:, None]], 1)
    where = {tuple(k): t for t, k in enumerate(kt) if mt[t]}
    ij = [j for j in np.nonzero(mj)[0] if tuple(kj[j]) in where]
    it = [where[tuple(kj[j])] for j in ij]
    return len(ij) / max(int(mj.sum()), 1), np.asarray(ij, int), np.asarray(it, int)


def _assert_features(fj, ft, binary: bool, with_scale: bool = False, kaze: bool = False):
    np.testing.assert_allclose(ft.mask.numpy().sum(1), np.asarray(fj.mask).sum(1),
                               rtol=0.02, atol=3)
    for i in range(ft.mask.shape[0]):
        frac, ij, it = _pixel_matches(fj, ft, i, with_scale)
        assert frac >= (0.95 if kaze else 0.98), frac
        dj, dt = np.asarray(fj.desc[i])[ij], ft.desc[i].numpy()[it]
        if binary:
            same = (dj == dt).all(1).mean()
            assert same >= 0.99, same
            continue
        err = np.abs(dt - dj).max(1)
        within = (err <= 1e-4).mean()
        assert within >= (0.90 if kaze else 0.99), within
        if not kaze:
            assert err.max() <= 1e-3, err.max()
            continue
        # KAZE's level of each keypoint (its scale is the level's sigma)
        deep = np.round(2 * np.log2(np.asarray(fj.scale[i])[ij] / CFG.sigma)) >= 6
        assert err[~deep].max() <= 2e-3, err[~deep].max()
        if deep.any():
            cos = (dj * dt).sum(1) / (np.linalg.norm(dj, axis=1) * np.linalg.norm(dt, axis=1))
            assert err[deep].max() <= 0.25 and cos[deep].min() >= 0.5, (err[deep], cos[deep])


# ---------------------------------------------------------------------------
# corners
# ---------------------------------------------------------------------------

def test_corner_responses_and_nms_match_jax():
    _, gray = _views()
    g = torch.as_tensor(gray)
    for i in range(len(gray)):
        gj = jnp.asarray(gray[i])
        _close_to_max(tcorners.harris_response(g, 1.6)[i], jcorners.harris_response(gj, 1.6))
        fj = jcorners.fast_score(gj)
        ft = tcorners.fast_score(g)[i]
        _close_to_max(ft, fj)
        np.testing.assert_array_equal(ft.numpy() > 0, np.asarray(fj) > 0)
        np.testing.assert_array_equal(tcorners._nms(torch.as_tensor(np.asarray(fj))).numpy(),
                                      np.asarray(jcorners._nms(fj)))


def test_brief_pattern_is_the_references():
    np.testing.assert_array_equal(tcorners._PATTERN, np.asarray(jcorners._PATTERN))


@pytest.mark.parametrize("method", ["harris", "fast", "orb", "brisk"])
def test_corner_features_match_jax(method):
    _, gray = _views()
    fj = jcorners.extract_corners_batch(jnp.asarray(gray), CFG, method)
    ft = tcorners.extract_corners_batch(torch.as_tensor(gray), CFG, method)
    assert ft.desc.shape == (2, 256, 256)
    _assert_features(fj, ft, binary=True)
    for i in range(2):  # orientations of the keypoints found at the same pixel
        _, ij, it = _pixel_matches(fj, ft, i)
        np.testing.assert_allclose(ft.orientation[i].numpy()[it],
                                   np.asarray(fj.orientation[i])[ij], rtol=0, atol=1e-4)


def test_brief_samples_truncate_toward_zero_and_clip():
    """Keypoints at the image corner sample at negative offsets: the casts
    truncate toward zero before the clip, as the reference's astype."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (1, 40, 50)).astype(np.float32)
    x = np.array([[0.0, 49.0, 3.0, 20.0]], np.float32)
    y = np.array([[0.0, 39.0, 37.0, 2.0]], np.float32)
    th = np.array([[0.3, -2.0, 1.2, 3.0]], np.float32)
    ref = np.asarray(jcorners.rotated_brief(jnp.asarray(img[0]), jnp.asarray(x[0]),
                                            jnp.asarray(y[0]), jnp.asarray(th[0])))
    got = tcorners.rotated_brief(*(torch.as_tensor(a) for a in (img, x, y, th)))[0]
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_o = np.asarray(jcorners.intensity_centroid_orientation(
        jnp.asarray(img[0]), jnp.asarray(x[0]), jnp.asarray(y[0])))
    got_o = tcorners.intensity_centroid_orientation(*(torch.as_tensor(a) for a in (img, x, y)))
    np.testing.assert_allclose(got_o[0].numpy(), ref_o, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# DoH (SURF) and KAZE
# ---------------------------------------------------------------------------

def test_doh_response_matches_jax():
    _, gray = _views(1)
    for s in tdoh.doh_sigmas(CFG)[:3]:
        L = np.asarray(jsift.gaussian_blur(jnp.asarray(gray[0]), s))
        _close_to_max(tdoh.hessian_response(torch.as_tensor(L), s),
                      jdoh.hessian_response(jnp.asarray(L), s))
    assert tdoh.doh_sigmas(CFG) == jdoh.doh_sigmas(CFG)


def test_doh_features_match_jax():
    _, gray = _views()
    fj = jax.vmap(lambda im: jdoh.extract_doh(im, CFG))(jnp.asarray(gray))
    ft = tdoh.extract_doh_batch(torch.as_tensor(gray), CFG)
    assert ft.desc.shape == (2, 256, 128)
    _assert_features(fj, ft, binary=False, with_scale=True)


def test_kaze_scale_space_matches_jax():
    """Contrast factor (rtol 1e-6: a percentile of magnitudes summed in
    another order), FED steps (exact), the evolved levels (see the module
    doc), and the sigma-sized DoH of a level (within 1e-5 of its max)."""
    _, gray = _views(2)
    sig = tuple(tdoh.doh_sigmas(CFG))
    k_t = tkaze.contrast_k(torch.as_tensor(gray))
    for i in range(2):
        np.testing.assert_allclose(float(k_t[i]), float(jkaze.contrast_k(jnp.asarray(gray[i]))),
                                   rtol=1e-6)
    for T in (0.0, 0.3, 5.12, 80.0):
        assert tkaze.fed_cycles(T) == jkaze.fed_cycles(T)
    Lt = tkaze.nonlinear_scale_space(torch.as_tensor(gray), sig)
    for i in range(2):
        Lj = np.asarray(jkaze.nonlinear_scale_space(jnp.asarray(gray[i]), sig))
        np.testing.assert_allclose(Lt[i, :6].numpy(), Lj[:6], rtol=0, atol=1e-3)
        np.testing.assert_allclose(Lt[i, 6].numpy(), Lj[6], rtol=0, atol=0.1)
        np.testing.assert_allclose(Lt[i, 7].numpy(), Lj[7], rtol=0, atol=1.0)
        np.testing.assert_allclose(Lt[i].numpy().mean((1, 2)), Lj.mean((1, 2)), rtol=0, atol=1e-5)
        assert np.isfinite(Lt[i].numpy()).all()
    _close_to_max(tkaze.hessian_response_scharr(Lt[0, 3], sig[3]),
                  jkaze.hessian_response_scharr(jnp.asarray(Lt[0, 3].numpy()), sig[3]))


def test_kaze_features_match_jax():
    _, gray = _views()
    fj = jax.vmap(lambda im: jkaze.extract_kaze(im, CFG))(jnp.asarray(gray))
    ft = tkaze.extract_kaze_batch(torch.as_tensor(gray), CFG)
    _assert_features(fj, ft, binary=False, with_scale=True, kaze=True)


# ---------------------------------------------------------------------------
# the features stage's dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("detector,upsample", [("ORB", False), ("HARRIS", True),
                                                ("SURF", True), ("KAZE", False)])
def test_extract_features_dispatch_matches_jax(detector, upsample):
    """Every detector through `extract_features`: gray conversion, the
    optional 2x upsample and the border mask around the detector."""
    rgb, _ = _views(2, size=(128, 96) if upsample else (192, 144))
    sizes = np.array([rgb.shape[1:3], [rgb.shape[1] - 6, rgb.shape[2]]], np.int32)
    cfg = DetectorConfig(detector=detector, max_keypoints=256, upsample_input=upsample)
    fj = jfeat.extract_features(jnp.asarray(rgb), sizes, cfg)
    ft = tfeat.extract_features(torch.as_tensor(rgb), sizes, cfg)
    _assert_features(fj, ft, binary=detector in ("ORB", "HARRIS"),
                     with_scale=detector in ("SURF", "KAZE"), kaze=detector == "KAZE")


# ---------------------------------------------------------------------------
# Hamming
# ---------------------------------------------------------------------------

def _packed(rng, n, nbytes=32):
    return rng.integers(0, 256, (n, nbytes)).astype(np.uint8)


def test_bit_packing_and_hamming_distances_are_exact():
    rng = np.random.default_rng(0)
    p = _packed(rng, 40)
    bits_j = np.asarray(jham.unpack_bits(jnp.asarray(p)))
    bits_t = tham.unpack_bits(torch.as_tensor(p))
    np.testing.assert_array_equal(bits_t.numpy(), bits_j)
    np.testing.assert_array_equal(tham.pack_bits(bits_t).numpy(), p)
    odd = bits_j[:, :77]  # a width that is no multiple of 8
    np.testing.assert_array_equal(tham.pack_bits(torch.as_tensor(odd)).numpy(),
                                  np.asarray(jham.pack_bits(jnp.asarray(odd))))
    q = _packed(rng, 25)
    np.testing.assert_array_equal(
        tham.hamming_distance_matrix(tham.unpack_bits(torch.as_tensor(q)), bits_t).numpy(),
        np.asarray(jham.hamming_distance_matrix(jham.unpack_bits(jnp.asarray(q)),
                                                jnp.asarray(bits_j))))


def test_hamming_two_nn_and_pair_matching_are_exact():
    """Near-duplicate bit strings (so that ratios and ties both occur),
    invalid queries and targets, two set sizes."""
    rng = np.random.default_rng(1)
    a = _packed(rng, 120)
    b = a[rng.permutation(120)[:90]].copy()
    flips = rng.integers(0, 256, b.shape).astype(np.uint8) & (rng.random(b.shape) < 0.1)
    b ^= flips.astype(np.uint8)
    ma, mb = rng.random(120) > 0.1, rng.random(90) > 0.1
    args_j = [jnp.asarray(x) for x in (a, ma, b, mb)]
    args_t = [torch.as_tensor(x) for x in (a, ma, b, mb)]
    for got, ref in zip(tham.hamming_two_nn(*args_t), jham.hamming_two_nn(*args_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(tham.hamming_two_nn(*args_t[2:], *args_t[:2]),
                        jham.hamming_two_nn(*args_j[2:], *args_j[:2])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for ratio in (0.8, 0.95):
        got = tham.match_pair_hamming(*args_t, ratio=ratio, max_matches=64)
        ref = jham.match_pair_hamming(*args_j, ratio=ratio, max_matches=64)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert int(got[2]) > 10
