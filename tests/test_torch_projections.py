"""The torch port's projections and rotational renderer in every mode,
blend and interpolation, against the JAX package, and the
`config2_cylindrical6` golden.

Tolerances: rays and surface coordinates atol 1e-6 (float32, same
formulas); canvases equal in size and reference camera, origins within
1e-5; panoramas within one uint8 level (float32 sums in another order
before the rounding) with equal coverage.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_scenes
from autopanostitch_tpu.config import RenderConfig
from autopanostitch_tpu.models import render as jrender
from autopanostitch_tpu.ops import geometry as jgeo
from autopanostitch_tpu.ops import projections as jproj
from autopanostitch_tpu_torch import convert
from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.models import render as trender
from autopanostitch_tpu_torch.ops import projections as tproj
from test_torch_pipeline import REPO, _assert_golden, one_torch_thread  # noqa: F401
from test_torch_render import _scene

MODES = ("planar", "cylindrical", "spherical", "equirectangular", "stereographic")


@pytest.mark.parametrize("mode", MODES)
def test_rays_and_surface_coordinates_match_jax(mode):
    rng = np.random.default_rng(0)
    R_ref = np.asarray(jgeo.so3_exp(jnp.asarray([0.05, -0.2, 0.03], jnp.float32)))
    xp = rng.uniform(0, 400, 300).astype(np.float32)
    yp = rng.uniform(0, 200, 300).astype(np.float32)
    args = (250.0, -0.7, -0.4)
    dj = np.asarray(jproj.pano_to_ray(mode, jnp.asarray(xp), jnp.asarray(yp), *args,
                                      jnp.asarray(R_ref)))
    dt = tproj.pano_to_ray(mode, torch.as_tensor(xp), torch.as_tensor(yp), *args,
                           torch.as_tensor(R_ref)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-6)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) * np.where(np.arange(300) % 5 == 0, -1, 1)  # some behind
    uj, vj, okj = map(np.asarray, jproj.ray_to_pano(mode, jnp.asarray(d), jnp.asarray(R_ref)))
    ut, vt, okt = (x.numpy() for x in tproj.ray_to_pano(mode, torch.as_tensor(d),
                                                         torch.as_tensor(R_ref)))
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_allclose(ut[okj], uj[okj], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt[okj], vj[okj], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_compute_canvas_matches_jax(mode):
    imgs, feathers, R, K, sizes, k1 = _scene()
    cfg = RenderConfig(tile=(64, 128))
    for ref_idx, kk in ((None, k1), (2, None)):
        cj = jrender.compute_canvas(R, K, sizes, mode, cfg, ref_idx=ref_idx, k1=kk)
        ct = trender.compute_canvas(R, K, sizes, mode, cfg, ref_idx=ref_idx, k1=kk)
        for key in ("Hc", "Wc", "ref_idx", "mode"):
            assert ct[key] == cj[key], (key, ct[key], cj[key])
        for key in ("f_pan", "x0", "y0"):
            assert ct[key] == pytest.approx(cj[key], rel=1e-5, abs=1e-5), key
        np.testing.assert_array_equal(ct["R_ref"], cj["R_ref"])
        conv = convert.canvas(cj)
        assert conv["R_ref"].dtype == np.float32 and conv["Hc"] == ct["Hc"]
    if mode in ("planar", "stereographic"):
        assert ct["x0"] < 0 < ct["x0"] + ct["Wc"] / ct["f_pan"]


@pytest.mark.parametrize("mode,blend,interp", [
    ("cylindrical", "none-maxangle", "bicubic"),
    ("planar", "linear", "bilinear"),
    ("stereographic", "none-first", "nearest"),
    ("spherical", "none-last", "bicubic2x"),
    ("equirectangular", "multiband", "nearest"),
])
def test_render_blends_and_interpolations_match_jax(mode, blend, interp):
    imgs, feathers, R, K, sizes, k1 = _scene()
    cfg = RenderConfig(tile=(64, 128))
    gains = np.array([[1.2, 1.1, 1.0], [1.0, 1.0, 1.0], [0.9, 0.95, 1.0], [0.85, 0.9, 0.9]],
                     np.float32)
    cj = jrender.compute_canvas(R, K, sizes, mode, cfg, k1=k1)
    ct = convert.canvas(cj)
    for a, b in zip(trender.tile_contributors(ct, R, K, sizes, cfg.tile, k1=k1),
                    jrender.tile_contributors(cj, R, K, sizes, cfg.tile, k1=k1)):
        np.testing.assert_array_equal(a, b)
    kw = dict(gains=gains, blend_mode=blend, tile=cfg.tile, sizes=sizes, interp=interp, k1=k1)
    pj, cvj = jrender.render_rotational(jnp.asarray(imgs), jnp.asarray(feathers), R, K, cj, **kw)
    pt, cvt = trender.render_rotational(torch.as_tensor(imgs), torch.as_tensor(feathers), R, K,
                                        ct, tiles_per_batch=5, **kw)
    assert pt.shape == pj.shape and pt.dtype == np.uint8
    np.testing.assert_array_equal(cvt, cvj)
    diff = np.abs(pt.astype(int) - pj.astype(int))
    assert diff.max() <= 1, diff.max()
    assert cvt.mean() > 0.1


def test_config2_golden_parity():
    iset, cfg = parity_scenes.config2_cylindrical6()
    res = tpipe.stitch(iset, cfg, seed=0, device="cpu")
    with np.load(os.path.join(REPO, "tests", "goldens", "config2_cylindrical6.npz")) as z:
        golden = {k: z[k] for k in z.files}
    _assert_golden(parity_scenes.extract_artifacts(iset, res), golden)
