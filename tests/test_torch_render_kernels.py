"""The render stage's kernels (`kernels/render.py`; `csrc/render.cu`,
`csrc/render_pyramid.cu`): the tile sampler `render_sample` and the
multiband pyramid (`mb_reduce`, `mb_collapse`), and the tables they read.

On the CPU:
- `render_sample_plain` (with `multiband_plain` for multiband) against the
  JAX package's `_render_tile_impl` on the same tiles, in every projection,
  interpolation and blend kind (multiband, linear, none-maxangle), with and
  without k1: coverage equal, uint8 within one level (float32 sums in
  another order before the rounding, as `test_torch_render.py` holds the
  panorama);
- `multiband_plain` against the JAX package's `multiband_blend` at odd
  sizes and 1-4 bands: atol 1e-4 (`test_torch_render.py`'s tolerance);
- `sampling.resize_taps` expanded back to dense equal to
  `resize_weights` exactly; `mb_reduce`'s folded blur-and-resize tables
  equal to the blur then the 2x down in float64, and every level size's
  fitting its shared memory; `mb_collapse`'s regions holding every tap up2
  reads, for every level size and band count; `pyramid_plan` raising for
  what the kernels cannot take; the cached `resize_axis` equal to the
  uncached product;
- the renderer's batching and the device form of `assemble_tiles`;
- the planar band compositor's multiband (`models/planar.composite_band`,
  (N, H, W) contributors with no leading dims) against the JAX package's at
  an odd band size: coverage equal, uint8 within one level;
- every wrapper raises on a tensor that is neither on the CPU nor CUDA;
- `kernels/render.py` reads only leaf modules of `ops` (they import
  nothing of the package), so the two layers never import each other.

On the card (`cuda`-marked, skipped here): each kernel against its plain
version: the sampler's colours and weights within 1e-5, its uint8 tiles at
most one level apart on at most 0.1 % of covered pixels with equal
coverage; the pyramid's levels within 1e-5 and its uint8 output under the
same gate, also at the planar band's rank and shape (N, 512, odd width)
and with 40 contributors; a repeat launch bit-identical and a tile's result
independent of the other tiles of its launch:

    python -m pytest --noconftest -m cuda tests/test_torch_render_kernels.py -q
"""

import numpy as np
import pytest
import torch

import synthdata
from autopanostitch_tpu_torch.config import RenderConfig
from autopanostitch_tpu_torch.kernels import render as kr
from autopanostitch_tpu_torch.models import planar as tplanar
from autopanostitch_tpu_torch.models import render as trender
from autopanostitch_tpu_torch.ops import sampling as tsamp

try:  # jax-free runs on the card skip the fixture with the jax imports beside it
    from test_torch_pipeline import one_torch_thread  # noqa: F401
except ImportError:
    pass

MODES = ("planar", "cylindrical", "spherical", "equirectangular", "stereographic")
INTERPS = ("nearest", "bilinear", "bicubic", "bicubic2x")
BLENDS = ("multiband", "linear", "none-maxangle")
TILE = (24, 40)
GAINS = np.array([[1.2, 1.1, 1.0], [1.0, 1.0, 1.0], [0.9, 0.95, 1.0], [0.85, 0.9, 0.9]],
                 np.float32)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_render_kernels.py on the card")
    return torch.device("cuda")


def _scene(n=4, size=(200, 160), f=190.0, seed=21):
    """`test_torch_render._scene` without the JAX package: four views of a
    rotating camera, one of them smaller in its padded slot, with k1."""
    _, views, Rs, _ = synthdata.rotational_views(seed, n_views=n, f=f, size=size, yaw_step=0.55)
    dims = np.linspace(0.8, 1.1, n)
    imgs = np.stack([np.clip(v * d, 0, 1) for v, d in zip(views, dims)]).astype(np.float32)
    w, h = size
    sizes = np.array([[h, w]] * n, np.int32)
    sizes[1] = [h - 8, w - 12]
    K = np.tile(np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]], np.float32),
                (n, 1, 1))
    K[1, 0, 2], K[1, 1, 2] = (w - 13) / 2, (h - 9) / 2
    k1 = np.array([0.0, 0.01, -0.02, 0.015], np.float32)[:n]
    feathers = tsamp.feather_stack(torch.as_tensor(sizes), h, w).numpy()
    return imgs, feathers, Rs.astype(np.float32), K, sizes, k1


def _tiles(mode, sc, tile=TILE, n_tiles=3):
    """A canvas in `mode` and the `n_tiles` tiles nearest its centre:
    (canvas, sel, sel_ok, origins)."""
    imgs, feathers, R, K, sizes, k1 = sc
    canvas = trender.compute_canvas(R, K, sizes, mode, RenderConfig(tile=tile), k1=k1)
    sel, ok, org = trender.tile_contributors(canvas, R, K, sizes, tile, k1=k1)
    centre = np.array([canvas["Wc"] - tile[1], canvas["Hc"] - tile[0]]) / 2
    pick = np.argsort(np.abs(org - centre).sum(1), kind="stable")[:n_tiles]
    return canvas, sel[pick], ok[pick], org[pick]


def _sample_args(sc, mode, interp, blend, use_k1, dev, tile=TILE, n_tiles=3):
    imgs, feathers, R, K, sizes, k1 = sc
    canvas, sel, ok, org = _tiles(mode, sc, tile, n_tiles)
    t = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    images4 = torch.cat([t(imgs), t(feathers)[..., None]], -1)
    fine4 = tsamp.upsample2x_cubic(images4) if interp == "bicubic2x" else None
    return (images4, fine4, t(R), t(K), t(GAINS), t(k1) if use_k1 else None, t(sel, torch.int32),
            t(ok, torch.bool), t(org), canvas, tile[0], tile[1], blend, 1.0, interp)


def _band_args(dev, n=5, hw=(48, 64), band=(61, 157), seed=13):
    """`composite_band`'s arguments for n views of a planar scan, each
    shifted 27 px right and 9 px down of the last (one of them invalid), in
    a band of odd size: (images, feathers, H_inv, valid, gains, band_h,
    out_w, x0, y0)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    base = rng.uniform(size=(h + 9 * n, w + 27 * n, 3)).astype(np.float32)
    imgs = np.stack([base[9 * k: 9 * k + h, 27 * k: 27 * k + w] for k in range(n)])
    feathers = np.stack([tsamp.feather_weights(h, w).numpy()] * n)
    H_inv = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))  # canvas -> image k
    H_inv[:, 0, 2] = -27.0 * np.arange(n)
    H_inv[:, 1, 2] = -9.0 * np.arange(n)
    valid = np.arange(n) != 2
    gains = np.resize(GAINS, (n, 3)).astype(np.float32)
    t = lambda a, dtype=torch.float32: torch.as_tensor(a, dtype=dtype, device=dev)
    return (t(imgs), t(feathers), t(H_inv), t(valid, torch.bool), t(gains), *band, -3.0, -5.0)


def _finish(out, blend):
    """uint8 tiles and coverage from `render_sample`'s output."""
    if blend == "multiband":
        return kr.multiband(*out, bands=3, to_u8=True)
    return out


@pytest.mark.parametrize("use_k1", [False, True])
@pytest.mark.parametrize("blend", BLENDS)
@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("mode", MODES)
def test_render_sample_plain_matches_jax(mode, interp, blend, use_k1):
    import jax
    import jax.numpy as jnp

    from autopanostitch_tpu.models import render as jrender

    sc = _scene()
    args = _sample_args(sc, mode, interp, blend, use_k1, "cpu")
    u8, cov = (x.numpy() for x in _finish(kr.render_sample_plain(*args), blend))
    images4, _, R, K, gains, k1, sel, ok, org, canvas = (
        x.numpy() if torch.is_tensor(x) else x for x in args[:10])
    tile = jax.jit(jrender._render_tile_impl, static_argnames=(
        "mode", "tile_h", "tile_w", "blend_mode", "bands", "interp"))
    for t in range(len(sel)):
        uj, cj = tile(jnp.asarray(images4), jnp.asarray(R), jnp.asarray(K), jnp.asarray(gains),
                      jnp.asarray(sel[t]), jnp.asarray(ok[t]), jnp.asarray(org[t]),
                      canvas["f_pan"], canvas["x0"], canvas["y0"], jnp.asarray(canvas["R_ref"]),
                      mode=mode, tile_h=TILE[0], tile_w=TILE[1], blend_mode=blend, bands=3,
                      angle_power=1.0, interp=interp, k1=None if k1 is None else jnp.asarray(k1))
        np.testing.assert_array_equal(cov[t], np.asarray(cj))
        diff = np.abs(u8[t].astype(int) - np.asarray(uj).astype(int))
        assert diff.max() <= 1, (t, diff.max())
    assert cov.mean() > 0.2


@pytest.mark.parametrize("bands", [1, 2, 3, 4])
@pytest.mark.parametrize("hw", [(37, 53), (48, 64), (21, 30)])
def test_multiband_plain_matches_jax(hw, bands):
    import jax.numpy as jnp

    from autopanostitch_tpu.ops import blend as jblend

    rng = np.random.default_rng(7)
    cols = rng.uniform(size=(3,) + hw + (3,)).astype(np.float32)
    w = (rng.uniform(size=(3,) + hw) * (rng.uniform(size=(3,) + hw) > 0.3)).astype(np.float32)
    w[:, : hw[0] // 3, : hw[1] // 4] = 0.0  # an uncovered corner
    ref = np.asarray(jblend.multiband_blend(jnp.asarray(cols), jnp.asarray(w), bands=bands))
    got = kr.multiband_plain(torch.as_tensor(cols), torch.as_tensor(w), bands=bands)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    u8, cov = kr.multiband_plain(torch.as_tensor(cols), torch.as_tensor(w), bands=bands,
                                 to_u8=True)
    wsum = torch.as_tensor(w).sum(0)
    exp_u8, exp_cov = kr.to_uint8(got, wsum)
    assert torch.equal(u8, exp_u8) and torch.equal(cov, exp_cov)
    assert 0 < cov.float().mean() < 1


@pytest.mark.parametrize("in_size,out_size", [(96, 48), (384, 192), (48, 24), (7, 4), (5, 3),
                                              (3, 2), (2, 1), (23, 12), (1, 1), (48, 96),
                                              (4, 7), (12, 23), (600, 1200)])
def test_resize_taps_expand_to_resize_weights(in_size, out_size):
    first, taps = tsamp.resize_taps(in_size, out_size, "linear")
    assert first.dtype == np.int32 and taps.dtype == np.float32
    assert (first >= 0).all() and (first + taps.shape[1] <= in_size).all()
    dense = np.zeros((in_size, out_size), np.float32)
    for j in range(out_size):
        dense[first[j]: first[j] + taps.shape[1], j] = taps[j]
    np.testing.assert_array_equal(dense, tsamp.resize_weights(in_size, out_size, "linear"))


def test_every_pyramid_fits_mb_reduce():
    """`pyramid_plan` accepts every level size from 2 to 1,100 px and the
    planar bands' 1,920 px: at sigma 1 and 2 the folded tables' source
    window of any `mb_reduce` tile fits its shared memory (and spans no more
    than the tile's own rows and the filter's taps). It caps the bands as the
    reference does."""
    for sigma in (1.0, 2.0):
        for n in list(range(2, 1101)) + [1920]:
            first, taps = kr.folded_taps(n, (n + 1) // 2, sigma)
            width = taps.shape[1]
            spans = [kr._window_span(first, width, t) for t in kr._REDUCE_TILE]
            for span, t in zip(spans, kr._REDUCE_TILE):
                assert span <= min(n, 2 * (t - 1) + width + 1), (n, sigma, span)
            assert kr.reduce_smem_bytes(*spans, width, width) <= kr._SMEM_BYTES, (n, sigma, spans)
    plan = kr.pyramid_plan(96, 384, 3, 1.0, torch.device("cpu"))
    assert plan.sizes == ((96, 384), (48, 192), (24, 96))
    assert [lv.span for lv in plan.down] == [(40, 72), (36, 72)]
    assert kr.pyramid_plan(5, 9, 4, 1.0, torch.device("cpu")).bands == 1
    assert kr.pyramid_plan(8, 9, 4, 1.0, torch.device("cpu")).bands == 2


def test_pyramid_plan_raises_where_the_kernels_cannot_take_it():
    """Nine bands (mb_collapse holds eight) and a blur of radius 9 (mb_reduce
    takes 8) raise in `pyramid_plan`, before any launch."""
    cpu = torch.device("cpu")
    assert kr.pyramid_plan(1024, 1024, 8, 1.0, cpu).bands == 8
    with pytest.raises(ValueError, match="at most 8 bands"):
        kr.pyramid_plan(1024, 1024, 9, 1.0, cpu)
    with pytest.raises(ValueError, match="wider than mb_reduce"):
        kr.pyramid_plan(96, 384, 3, 3.0, cpu)


@pytest.mark.parametrize("sigma", [1.0, 2.0])
@pytest.mark.parametrize("n", [2, 3, 5, 7, 21, 37, 53, 301, 1003, 1920])
def test_folded_taps_match_blur_then_down2(n, sigma):
    """`mb_reduce`'s folded table along one axis, applied to random rows in
    float64, equals the Gaussian blur (replicate borders) then the 2x
    antialiased linear resize, both in float64 from the same float32 taps
    and weights."""
    import torch.nn.functional as F

    first, taps = kr.folded_taps(n, (n + 1) // 2, sigma)
    assert first.dtype == np.int32 and taps.dtype == np.float64
    assert (first >= 0).all() and (first + taps.shape[1] <= n).all()
    x = np.random.default_rng(n).uniform(size=(5, n))
    k = tsamp.gaussian_kernel1d(sigma).double()
    r = k.shape[0] // 2
    blurred = F.conv1d(F.pad(torch.as_tensor(x)[:, None], (r, r), mode="replicate"),
                       k[None, None])[:, 0].numpy()
    ref = blurred @ tsamp.resize_weights(n, (n + 1) // 2, "linear").astype(np.float64)
    got = (x[:, first[:, None] + np.arange(taps.shape[1])] * taps).sum(-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("bands", [1, 2, 3, 4])
def test_collapse_regions_cover_up2_taps(bands, monkeypatch):
    """For every tile of every level-0 size from 2 to 1,100 px along either
    axis, `collapse_regions` tiles level 0 exactly and each coarser level's
    region holds every tap that up2 reads for the finer level's region."""
    import functools

    monkeypatch.setattr(tsamp, "resize_taps", functools.lru_cache(None)(tsamp.resize_taps))
    for tile in kr._COLLAPSE_TILE:
        for n in range(2, 1101):
            sizes = [n]
            for _ in range(bands - 1):
                sizes.append((sizes[-1] + 1) // 2)
            regs = kr.collapse_regions(sizes, tile)
            assert len(regs) == bands
            start, count = regs[0][:, 0], regs[0][:, 1]
            assert start[0] == 0 and (start[1:] == start[:-1] + count[:-1]).all()
            assert start[-1] + count[-1] == n and count.max() <= tile
            for fine, coarse, rf, rc in zip(sizes, sizes[1:], regs, regs[1:]):
                first, taps = tsamp.resize_taps(coarse, fine, "linear")
                assert taps.shape[1] <= kr._MAX_UP_TAPS
                # every row of each tile's finer region, tile after tile
                rows = np.concatenate([np.arange(s, s + c) for s, c in rf])
                at = np.concatenate([[0], np.cumsum(rf[:, 1])[:-1]])
                lo = np.minimum.reduceat(first[rows], at)
                hi = np.maximum.reduceat(first[rows], at) + taps.shape[1]
                assert (lo >= rc[:, 0]).all() and (hi <= rc.sum(1)).all(), (n, tile, bands)
                assert (rc[:, 0] >= 0).all() and (rc.sum(1) <= coarse).all()


def test_cached_resize_axis_matches_uncached():
    x = torch.as_tensor(np.random.default_rng(3).uniform(size=(2, 19, 26)).astype(np.float32))
    for axis, n in ((1, 10), (2, 52), (1, 38)):
        dense = torch.as_tensor(tsamp.resize_weights(x.shape[axis], n, "linear"))
        ref = torch.movedim(torch.movedim(x, axis, -1) @ dense, -1, axis)
        assert torch.equal(tsamp.resize_axis(x, axis, n, "linear"), ref)
        assert torch.equal(tsamp.resize_axis(x, axis, n, "linear"), ref)  # from the cache
    w = tsamp._weights_on(19, 10, "linear", torch.device("cpu"))
    assert w is tsamp._weights_on(19, 10, "linear", torch.device("cpu"))


def test_batches_and_device_assembly_match():
    """The tiles render the same one a launch as all at once, and the device
    form of `assemble_tiles` gives the host form's canvas (also for tiles
    off the grid)."""
    imgs, feathers, R, K, sizes, k1 = sc = _scene()
    canvas = trender.compute_canvas(R, K, sizes, "cylindrical", RenderConfig(tile=TILE), k1=k1)
    sel, ok, org = trender.tile_contributors(canvas, R, K, sizes, TILE, k1=k1)
    run = lambda tb: trender.render_tile_list(
        torch.as_tensor(imgs), torch.as_tensor(feathers), R, K, GAINS, k1, sel, ok, org, canvas,
        TILE, "multiband", 3, 1.0, "bicubic", tiles_per_batch=tb)
    tiles, covs = run(None)
    one = run(1)
    assert torch.equal(tiles, one[0]) and torch.equal(covs, one[1])
    Hc, Wc = canvas["Hc"], canvas["Wc"]
    pano, cover = trender.assemble_tiles(tiles, covs, org, Hc, Wc)
    ref = trender.assemble_tiles(tiles.numpy(), covs.numpy(), org, Hc, Wc)
    np.testing.assert_array_equal(pano.numpy(), ref[0])
    np.testing.assert_array_equal(cover.numpy(), ref[1])
    sub = slice(1, None, 3)  # a subset: the slice-by-slice path
    pano, cover = trender.assemble_tiles(tiles[sub], covs[sub], org[sub], Hc, Wc)
    ref = trender.assemble_tiles(tiles.numpy()[sub], covs.numpy()[sub], org[sub], Hc, Wc)
    np.testing.assert_array_equal(pano.numpy(), ref[0])
    np.testing.assert_array_equal(cover.numpy(), ref[1])
    assert sc is not None and cover.any()


@pytest.mark.parametrize("interp", ["bilinear", "bicubic2x"])
@pytest.mark.parametrize("bands", [1, 3, 4])
def test_planar_band_multiband_matches_jax(bands, interp):
    """`composite_band`'s multiband over (N, H, W) contributors, as the
    planar path calls the render kernels' pyramid, at an odd band size."""
    import jax.numpy as jnp

    from autopanostitch_tpu.models import planar as jplanar

    args = _band_args("cpu")
    u8, cov = tplanar.composite_band(*args, "multiband", bands, interp)
    ref_u8, ref_cov = map(np.asarray, jplanar.composite_band(
        *(jnp.asarray(a.numpy()) for a in args[:5]), *args[5:], "multiband", bands, interp))
    assert u8.shape == ref_u8.shape == (61, 157, 3)
    np.testing.assert_array_equal(cov.numpy(), ref_cov)
    assert np.abs(u8.numpy().astype(int) - ref_u8.astype(int)).max() <= 1
    assert 0.3 < ref_cov.mean() < 1  # part of the band is covered, part is not
    cols, ws = tplanar.warp_band(*args, interp)
    got = kr.multiband_plain(cols, ws, bands, to_u8=True)
    assert torch.equal(got[0], u8) and torch.equal(got[1], cov)


@pytest.mark.parametrize("name", ["projections", "sampling"])
def test_render_kernels_read_only_leaf_ops_modules(name):
    """`kernels/render.py` imports these two `ops` modules and no other, and
    they import nothing of the package: `ops/sift` and `ops/blend` import
    `kernels`, so any other import there would close a cycle."""
    import ast
    import pathlib

    pkg = pathlib.Path(kr.__file__).parents[1]
    tree = ast.parse((pkg / "kernels" / "render.py").read_text())
    ops = {a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
           and node.module == "autopanostitch_tpu_torch.ops" for a in node.names}
    assert ops == {"projections", "sampling"}
    tree = ast.parse((pkg / "ops" / f"{name}.py").read_text())
    mods = [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    mods += [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    assert not [m for m in mods if m.startswith("autopanostitch_tpu")], mods


def test_wrappers_raise_on_other_devices():
    sc = _scene(size=(40, 32), f=40.0)
    args = _sample_args(sc, "spherical", "bilinear", "linear", True, "cpu", tile=(8, 8))
    meta = tuple(x.to("meta") if torch.is_tensor(x) else x for x in args)
    with pytest.raises(ValueError, match="unsupported device"):
        kr.render_sample(*meta)
    cols = torch.zeros((2, 8, 9, 3), device="meta")
    w = torch.zeros((2, 8, 9), device="meta")
    plan = kr.pyramid_plan(8, 9, 2, 1.0, torch.device("cpu"))
    for fn, extra in ((kr.multiband, ()), (kr.mb_reduce, (plan,)), (kr.mb_collapse, ([], plan))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(cols, w, *extra)
    with pytest.raises(ValueError, match="fine4"):
        kr.render_sample(*args[:1], None, *args[2:13], 1.0, "bicubic2x")


# ---------------------------------------------------------------- on the card

def _u8_gate(u8_k, cov_k, u8_p, cov_p):
    """Coverage equal; uint8 at most one level apart on at most 0.1 % of the
    covered pixels."""
    assert torch.equal(cov_k, cov_p)
    diff = (u8_k.int() - u8_p.int()).abs()
    assert int(diff.max()) <= 1
    off = int((diff.amax(-1) > 0).sum())
    assert off <= 1e-3 * max(int(cov_p.sum()), 1), off


@pytest.mark.cuda
@pytest.mark.parametrize("use_k1", [False, True])
@pytest.mark.parametrize("blend", BLENDS)
@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("mode", MODES)
def test_render_sample_kernel_matches_plain_on_card(mode, interp, blend, use_k1):
    dev = _cuda()
    args = _sample_args(_scene(), mode, interp, blend, use_k1, dev, n_tiles=6)
    before = kr.sample_launches
    got = kr.render_sample(*args)
    ref = kr.render_sample_plain(*args)
    torch.cuda.synchronize()
    assert kr.sample_launches == before + 1
    if blend == "multiband":
        for a, b in zip(got, ref):
            assert float((a - b).abs().max()) <= 1e-5
        _u8_gate(*kr.multiband(*got, to_u8=True), *kr.multiband_plain(*ref, to_u8=True))
    else:
        _u8_gate(*got, *ref)
    again = kr.render_sample(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # a tile's result does not depend on the other tiles of its launch
    part = kr.render_sample(*args[:6], *(x[2:4] for x in args[6:9]), *args[9:])
    assert all(torch.equal(a[2:4], b) for a, b in zip(got, part))


def _pyramid_inputs(shape, dev, seed=11):
    """Random colours and weights of (..., C, H, W) contributors, a third of
    the weights zero and an uncovered corner."""
    rng = np.random.default_rng(seed)
    H, W = shape[-2:]
    cols = torch.as_tensor(rng.uniform(size=shape + (3,)).astype(np.float32), device=dev)
    w = rng.uniform(size=shape) * (rng.uniform(size=shape) > 0.3)
    w[..., : H // 3, : W // 4] = 0.0
    return cols, torch.as_tensor(w.astype(np.float32), device=dev)


def _pyramid_kernels_match_plain(cols, w, bands):
    """Levels within 1e-5 of the plain version's, the float blend from the
    same levels within 1e-5, the uint8 gate, a repeat launch equal."""
    plan = kr.pyramid_plan(*cols.shape[-3:-1], bands, 1.0, cols.device)
    levels = kr.mb_reduce(cols, w, plan)
    ref_levels = kr.mb_reduce_plain(cols, w, plan)
    assert len(levels) == plan.bands - 1
    for a, b in zip(levels, ref_levels):
        assert a.shape == b.shape and float((a - b).abs().max()) <= 1e-5
    got = kr.mb_collapse(cols, w, levels, plan)
    ref = kr.mb_collapse_plain(cols, w, ref_levels, plan)
    assert float((got - ref).abs().max()) <= 1e-5
    _u8_gate(*kr.multiband(cols, w, bands, to_u8=True),
             *kr.multiband_plain(cols, w, bands, to_u8=True))
    assert torch.equal(kr.multiband(cols, w, bands), kr.multiband(cols, w, bands))


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 5, 37, 53), (1, 9, 96, 384), (3, 4, 21, 30),
                                   (9, 512, 1003), (6, 301, 257)])
def test_multiband_kernels_match_plain_on_card(shape, bands):
    """(T, C, H, W) tiles of the rotational path and (N, H, W) bands of the
    planar path (every image a contributor, no leading dims)."""
    _pyramid_kernels_match_plain(*_pyramid_inputs(shape, _cuda()), bands)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 40, 96, 384), (40, 512, 257)])
def test_multiband_kernels_match_plain_with_40_contributors_on_card(shape):
    """Nothing caps the contributors: 40 at a rotational tile and at a
    planar band (one an image), under the gates above."""
    _pyramid_kernels_match_plain(*_pyramid_inputs(shape, _cuda(), seed=40), 3)


@pytest.mark.cuda
def test_multiband_tile_independent_of_its_batch_on_card():
    """A tile blended alone and inside a batch of 66 (the ring's canvas)
    gives the same bytes: its levels, its float blend, its uint8 tile and
    coverage."""
    cols, w = _pyramid_inputs((66, 6, 96, 384), _cuda(), seed=66)
    one = slice(17, 18)
    plan = kr.pyramid_plan(96, 384, 3, 1.0, cols.device)
    for a, b in zip(kr.mb_reduce(cols, w, plan), kr.mb_reduce(cols[one], w[one], plan)):
        assert torch.equal(a[one], b)
    assert torch.equal(kr.multiband(cols, w)[one], kr.multiband(cols[one], w[one]))
    for a, b in zip(kr.multiband(cols, w, to_u8=True), kr.multiband(cols[one], w[one], to_u8=True)):
        assert torch.equal(a[one], b)


@pytest.mark.cuda
def test_rendered_panorama_matches_plain_on_card():
    """The whole renderer on the card (kernels) against the same call on the
    CPU (plain versions): coverage equal, uint8 within one level."""
    dev = _cuda()
    imgs, feathers, R, K, sizes, k1 = _scene()
    canvas = trender.compute_canvas(R, K, sizes, "spherical", RenderConfig(tile=TILE), k1=k1)
    out = {}
    for d in (dev, torch.device("cpu")):
        kr.sample_launches = kr.reduce_launches = kr.collapse_launches = kr.plain_on_cuda = 0
        out[d.type] = trender.render_rotational(
            torch.as_tensor(imgs, device=d), torch.as_tensor(feathers, device=d), R, K, canvas,
            gains=GAINS, tile=TILE, sizes=sizes, k1=k1)
        if d.type == "cuda":
            assert kr.sample_launches and kr.reduce_launches and kr.collapse_launches
            assert kr.plain_on_cuda == 0
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    assert np.abs(out["cuda"][0].astype(int) - out["cpu"][0].astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("interp", ["bilinear", "bicubic2x"])
def test_planar_band_multiband_kernels_on_card(interp):
    """`composite_band`'s multiband on the card at the planar path's band
    shape (9 contributors, 512 rows, an odd width) launches the pyramid's
    kernels, no plain version, and agrees with the plain multiband of the
    same warped band (coverage equal, uint8 gate)."""
    dev = _cuda()
    args = _band_args(dev, n=9, hw=(300, 400), band=(512, 1003))
    before = (kr.reduce_launches, kr.collapse_launches, kr.plain_on_cuda)
    u8, cov = tplanar.composite_band(*args, "multiband", 3, interp)
    torch.cuda.synchronize()
    assert (kr.reduce_launches - before[0], kr.collapse_launches - before[1],
            kr.plain_on_cuda - before[2]) == (2, 1, 0)
    cols, ws = tplanar.warp_band(*args, interp)
    _u8_gate(u8, cov, *kr.multiband_plain(cols, ws, 3, to_u8=True))
    assert 0.3 < float(cov.float().mean()) < 1
