"""Parity of the torch port's resampling, blending, gain compensation and
spherical renderer with the JAX package.

- Resizes: the port's explicit separable weights against `jax.image.resize`
  itself, border rows included, atol 1e-5.
- `multiband_blend`: atol 1e-4.
- Gains: rtol 0.01, atol 0.01 (the golden tolerance).
- Canvas and tile contributors: identical; the rendered panorama within one
  uint8 level (float32 sums in another order before the rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthdata
from autopanostitch_tpu.config import GainConfig, RenderConfig
from autopanostitch_tpu.models import gain as jgain
from autopanostitch_tpu.models import render as jrender
from autopanostitch_tpu.ops import blend as jblend
from autopanostitch_tpu.ops import sampling as jsamp
from autopanostitch_tpu_torch.models import gain as tgain
from autopanostitch_tpu_torch.models import render as trender
from autopanostitch_tpu_torch.ops import blend as tblend
from autopanostitch_tpu_torch.ops import sampling as tsamp
from test_torch_pipeline import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape", [(2, 13, 17, 4), (1, 32, 48, 3)])
def test_cubic_upsample2x_matches_jax_resize(shape):
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    N, H, W, C = shape
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (N, 2 * H, 2 * W, C), "cubic"))
    got = tsamp.upsample2x_cubic(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the border rows/columns carry the renormalised taps
    np.testing.assert_allclose(got[:, [0, 1, -2, -1]], ref[:, [0, 1, -2, -1]], rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(24, 40), (23, 39), (7, 5)])
def test_down2_up2_match_jax(hw):
    x = np.random.default_rng(1).uniform(size=(3, 2) + hw).astype(np.float32)
    d_ref = np.asarray(jblend._down2(jnp.asarray(x)))
    d_got = tblend._down2(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(d_got, d_ref, rtol=0, atol=1e-5)
    u_ref = np.asarray(jblend._up2(jnp.asarray(d_ref), *hw))
    u_got = tblend._up2(torch.as_tensor(d_ref), *hw).numpy()
    np.testing.assert_allclose(u_got, u_ref, rtol=0, atol=1e-5)


def test_linear_upsample_matches_jax_resize():
    x = np.random.default_rng(2).uniform(size=(2, 19, 26)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 38, 52), "linear"))
    got = tsamp.resize(torch.as_tensor(x), (2, 38, 52), "linear").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_sampling_and_feathers_match_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(20, 30, 4)).astype(np.float32)
    x = rng.uniform(-2, 32, 500).astype(np.float32)
    y = rng.uniform(-2, 22, 500).astype(np.float32)
    vj, okj = jsamp.sample_bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    vt, okt = tsamp.sample_bilinear(torch.as_tensor(img), torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-6)
    vi, oki = tsamp.sample_bilinear_indexed(torch.as_tensor(np.stack([img * 0, img])),
                                            torch.tensor([1]), torch.as_tensor(x)[None],
                                            torch.as_tensor(y)[None])
    np.testing.assert_allclose(vi[0].numpy(), np.asarray(vj), rtol=0, atol=1e-6)
    sizes = np.array([[20, 30], [15, 22]], np.int32)
    np.testing.assert_allclose(
        tsamp.feather_stack(torch.as_tensor(sizes), 20, 30).numpy(),
        np.asarray(jsamp.feather_stack(jnp.asarray(sizes), 20, 30)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsamp.feather_weights(9, 14).numpy(),
                               np.asarray(jsamp.feather_weights(9, 14)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsamp._cubic_kernel(torch.linspace(-3, 3, 61)).numpy(),
                               np.asarray(jsamp._cubic_kernel(jnp.linspace(-3, 3, 61))), atol=1e-6)


def test_multiband_blend_matches_jax():
    rng = np.random.default_rng(4)
    cols = rng.uniform(size=(4, 48, 64, 3)).astype(np.float32)
    w = rng.uniform(size=(4, 48, 64)).astype(np.float32) * (rng.uniform(size=(4, 48, 64)) > 0.3)
    ref = np.asarray(jblend.multiband_blend(jnp.asarray(cols), jnp.asarray(w), bands=3))
    got = tblend.multiband_blend(torch.as_tensor(cols), torch.as_tensor(w), bands=3).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # leading batch dims (tiles) blend independently
    two = tblend.multiband_blend(torch.as_tensor(np.stack([cols, cols[::-1]])),
                                 torch.as_tensor(np.stack([w, w[::-1]])), bands=3).numpy()
    np.testing.assert_allclose(two[0], got, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tblend.linear_blend(torch.as_tensor(cols), torch.as_tensor(w)).numpy(),
        np.asarray(jblend.linear_blend(jnp.asarray(cols), jnp.asarray(w))), rtol=0, atol=1e-6)


def _scene(n=4, size=(200, 160), f=190.0, seed=21):
    env, views, Rs, _ = synthdata.rotational_views(seed, n_views=n, f=f, size=size, yaw_step=0.55)
    dims = np.linspace(0.8, 1.1, n)
    imgs = np.stack([np.clip(v * d, 0, 1) for v, d in zip(views, dims)]).astype(np.float32)
    w, h = size
    sizes = np.array([[h, w]] * n, np.int32)
    sizes[1] = [h - 8, w - 12]  # a smaller image in the padded stack
    K = np.tile(np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]], np.float32), (n, 1, 1))
    K[1, 0, 2], K[1, 1, 2] = (w - 13) / 2, (h - 9) / 2
    k1 = np.array([0.0, 0.01, -0.02, 0.015], np.float32)[:n]
    feathers = np.asarray(jsamp.feather_stack(jnp.asarray(sizes), h, w))
    return imgs, feathers, Rs.astype(np.float32), K, sizes, k1


@pytest.mark.parametrize("use_k1", [False, True])
def test_gains_match_jax(use_k1):
    imgs, feathers, R, K, sizes, k1 = _scene()
    k = k1 if use_k1 else None
    ref = jgain.compute_gains_rotational(jnp.asarray(imgs), jnp.asarray(feathers), R, K, sizes,
                                         GainConfig(grid_stride=3), k1=k)
    got = tgain.compute_gains_rotational(torch.as_tensor(imgs), torch.as_tensor(feathers), R, K,
                                         sizes, GainConfig(grid_stride=3), k1=k)
    assert not np.allclose(ref, 1.0)
    np.testing.assert_allclose(got, ref, rtol=0.01, atol=0.01)
    Nj, Cj = jgain.overlap_statistics_imagespace(
        jnp.asarray(imgs), jnp.asarray(feathers), jnp.asarray(sizes), jnp.asarray(R),
        jnp.asarray(K), 3, k1=None if k is None else jnp.asarray(k))
    Nt, Ct = tgain.overlap_statistics_imagespace(
        torch.as_tensor(imgs), torch.as_tensor(feathers), torch.as_tensor(sizes),
        torch.as_tensor(R), torch.as_tensor(K), 3, k1=None if k is None else torch.as_tensor(k),
        max_elems=4096)  # several grid chunks
    np.testing.assert_allclose(Nt.numpy(), np.asarray(Nj), rtol=0.002, atol=2)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=0.002, atol=600)


def test_canvas_contributors_and_render_match_jax():
    imgs, feathers, R, K, sizes, k1 = _scene()
    cfg = RenderConfig(tile=(64, 128))
    gains = np.array([[1.2, 1.1, 1.0], [1.0, 1.0, 1.0], [0.9, 0.95, 1.0], [0.85, 0.9, 0.9]],
                     np.float32)
    cj = jrender.compute_canvas(R, K, sizes, "spherical", cfg, k1=k1)
    ct = trender.compute_canvas(R, K, sizes, "spherical", cfg, k1=k1)
    for key in ("Hc", "Wc", "ref_idx", "mode"):
        assert ct[key] == cj[key], key
    for key in ("f_pan", "x0", "y0"):
        assert ct[key] == pytest.approx(cj[key], rel=1e-5, abs=1e-5), key
    for a, b in zip(trender.tile_contributors(ct, R, K, sizes, cfg.tile, k1=k1),
                    jrender.tile_contributors(cj, R, K, sizes, cfg.tile, k1=k1)):
        np.testing.assert_array_equal(a, b)
    pj, cvj = jrender.render_rotational(jnp.asarray(imgs), jnp.asarray(feathers), R, K, cj,
                                        gains=gains, tile=cfg.tile, sizes=sizes,
                                        interp="bicubic2x", k1=k1)
    pt, cvt = trender.render_rotational(torch.as_tensor(imgs), torch.as_tensor(feathers), R, K,
                                        ct, gains=gains, tile=cfg.tile, sizes=sizes,
                                        interp="bicubic2x", k1=k1, tiles_per_batch=3)
    assert pt.shape == pj.shape and pt.dtype == np.uint8
    np.testing.assert_array_equal(cvt, cvj)
    diff = np.abs(pt.astype(int) - pj.astype(int))
    assert diff.max() <= 1, diff.max()
    assert cvt.mean() > 0.5


def test_unported_render_options_raise():
    """Every projection, blend and interpolation of the reference is ported
    (tests/test_torch_projections.py); names the reference does not know
    raise."""
    imgs, feathers, R, K, sizes, _ = _scene()
    with pytest.raises(ValueError, match="projection"):
        trender.compute_canvas(R, K, sizes, "fisheye")
    canvas = trender.compute_canvas(R, K, sizes, "cylindrical")
    for kw in ({"blend_mode": "feather"}, {"interp": "lanczos"}):
        with pytest.raises(ValueError):
            trender.render_rotational(torch.as_tensor(imgs), torch.as_tensor(feathers), R, K,
                                      canvas, **kw)
