"""Parity of the torch port's SIFT (and kernel B2's plain version) with the
JAX package.

- B2 plain gather: bit-exact against the Pallas `gather_windows` in
  interpret mode (cropped at its aligned offset) and against the XLA
  dynamic_slice path of `sift._map_per_kp`.
- Pyramid: float32 convolutions in another order, atol 1e-5.
- Keypoints: >= 98% of the reference's keypoints found at the same position
  within 0.01 px and the same orientation, descriptors within atol 1e-3;
  per-image counts within the golden tolerance (rtol 0.02, atol 3) —
  borderline extrema may flip with summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthdata
from autopanostitch_tpu.config import DetectorConfig
from autopanostitch_tpu.models import features as jfeat
from autopanostitch_tpu.ops import sift as jsift
from autopanostitch_tpu.ops.pallas import window_gather as jwg
from autopanostitch_tpu_torch.kernels import window_gather as twg
from autopanostitch_tpu_torch.models import features as tfeat
from autopanostitch_tpu_torch.ops import sift as tsift
from test_torch_pipeline import one_torch_thread  # noqa: F401

CFG = DetectorConfig(max_keypoints=512, num_octaves=3)


def _windows_case(seed=3, S=5, H=64, W=128, win=16, K=1024):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(2, S, H, W)).astype(np.float32)  # Pallas layout (C, S, H, W)
    lev = rng.integers(0, S, K).astype(np.int32)
    ys = rng.integers(0, H - win, K).astype(np.int32)
    xs = rng.integers(0, W - win, K).astype(np.int32)
    return src, lev, ys, xs, win


def test_gather_plain_matches_pallas_interpret():
    src, lev, ys, xs, win = _windows_case()
    _, _, H, W = src.shape
    y8, x128, rows, cols = jwg.aligned_starts(jnp.asarray(ys), jnp.asarray(xs), win, H, W)
    out = np.asarray(jwg.gather_windows(jnp.asarray(src), jnp.asarray(lev), y8, x128, rows, cols,
                                        interpret=True))
    oy = ys - np.asarray(y8)
    ox = xs - np.asarray(x128)
    ref = np.stack([out[k, :, oy[k]:oy[k] + win, ox[k]:ox[k] + win] for k in range(len(lev))])
    src_cl = torch.as_tensor(np.ascontiguousarray(src.transpose(1, 2, 3, 0)))
    got = twg.gather_windows(src_cl, torch.as_tensor(lev), torch.as_tensor(ys),
                             torch.as_tensor(xs), win, win)
    np.testing.assert_array_equal(got.permute(0, 3, 1, 2).numpy(), ref)


def test_gather_plain_matches_dynamic_slice():
    src, lev, ys, xs, win = _windows_case(seed=4, win=40, H=96, W=160, K=300)
    src_cl = np.ascontiguousarray(src.transpose(1, 2, 3, 0))
    ref = np.asarray(jax.vmap(lambda l, y, x: jax.lax.dynamic_slice(
        jnp.asarray(src_cl), (l, y, x, 0), (1, win, win, 2))[0])(
        jnp.asarray(lev), jnp.asarray(ys), jnp.asarray(xs)))
    got = twg.gather_windows(torch.as_tensor(src_cl), torch.as_tensor(lev), torch.as_tensor(ys),
                             torch.as_tensor(xs), win, win)
    np.testing.assert_array_equal(got.numpy(), ref)


def _gray_views(n=2, size=(320, 256), seed=31):
    _, views, _, _ = synthdata.rotational_views(seed, n_views=n, f=280.0, size=size, yaw_step=0.42)
    rgb = np.stack(views).astype(np.float32)
    return rgb, np.asarray(jsift.rgb_to_gray(jnp.asarray(rgb)))


def test_pyramid_parity():
    _, gray = _gray_views(1)
    pj = jsift.build_pyramid(jnp.asarray(gray[0]), CFG)
    pt = tsift.build_pyramid(torch.as_tensor(gray), CFG)
    assert len(pj) == len(pt)
    for oj, ot in zip(pj, pt):
        np.testing.assert_allclose(ot["gauss"][0].numpy(), np.asarray(oj["gauss"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ot["dog"][0].numpy(), np.asarray(oj["dog"]), rtol=0, atol=1e-5)


def _match_keypoints(fj, ft, i):
    """Per reference keypoint: does the port have one at the same position
    (0.01 px) and orientation? Returns (fraction found, pairs (j_idx, t_idx))."""
    mj = np.asarray(fj.mask[i])
    mt_ = ft.mask[i].numpy()
    xj, tj = np.asarray(fj.xy[i])[mj], np.asarray(fj.orientation[i])[mj]
    xt, tt = ft.xy[i].numpy()[mt_], ft.orientation[i].numpy()[mt_]
    dpos = np.linalg.norm(xj[:, None] - xt[None], axis=-1)
    dang = np.abs((tj[:, None] - tt[None] + np.pi) % (2 * np.pi) - np.pi)
    cost = np.where(dang < 1e-3, dpos, np.inf)
    best = cost.argmin(1)
    ok = cost[np.arange(len(xj)), best] <= 0.01
    return ok.mean(), np.nonzero(mj)[0][ok], np.nonzero(mt_)[0][best[ok]]


def test_sift_extract_batch_parity():
    _, gray = _gray_views(2)
    fj = jsift.extract_batch(jnp.asarray(gray), CFG)
    ft = tsift.extract_batch(torch.as_tensor(gray), CFG)
    np.testing.assert_allclose(ft.mask.numpy().sum(1), np.asarray(fj.mask).sum(1), rtol=0.02, atol=3)
    for i in range(2):
        frac, ij, it = _match_keypoints(fj, ft, i)
        assert frac >= 0.98, frac
        np.testing.assert_allclose(ft.desc[i].numpy()[it], np.asarray(fj.desc[i])[ij], rtol=0, atol=1e-3)
        np.testing.assert_allclose(ft.scale[i].numpy()[it], np.asarray(fj.scale[i])[ij], rtol=1e-3)


def test_extract_features_with_upsample_level_parity():
    """Small images take Lowe's octave -1 (a linear 2x `jax.image.resize`
    upsample) and the border mask; the port must agree there too."""
    rgb, _ = _gray_views(2, size=(150, 120), seed=7)
    sizes = np.array([[120, 150], [110, 150]], np.int32)
    cfg = DetectorConfig(max_keypoints=256, num_octaves=3)
    assert tfeat.upsample_levels(cfg, sizes) == jfeat.upsample_levels(cfg, sizes) == 1
    fj = jfeat.extract_features(jnp.asarray(rgb), sizes, cfg)
    ft = tfeat.extract_features(torch.as_tensor(rgb), sizes, cfg)
    np.testing.assert_allclose(ft.mask.numpy().sum(1), np.asarray(fj.mask).sum(1), rtol=0.02, atol=3)
    for i in range(2):
        frac, ij, it = _match_keypoints(fj, ft, i)
        assert frac >= 0.98, frac
        np.testing.assert_allclose(ft.desc[i].numpy()[it], np.asarray(fj.desc[i])[ij], rtol=0, atol=1e-3)


def test_other_detectors_raise():
    """The other detectors are ported (tests/test_torch_detectors.py holds
    them against the JAX package): none raises, the corner detectors give
    256-bit {0,1} descriptors, SURF and KAZE d * d * nbins floats."""
    rgb, _ = _gray_views(1, size=(64, 64))
    for det, width in (("ORB", 256), ("FAST", 256), ("SURF", 128), ("KAZE", 128)):
        f = tfeat.extract_features(torch.as_tensor(rgb), np.array([[64, 64]]),
                                   DetectorConfig(detector=det, max_keypoints=64))
        assert f.desc.shape == (1, 64, width)
        if width == 256:
            assert set(np.unique(f.desc.numpy())) <= {0.0, 1.0}

