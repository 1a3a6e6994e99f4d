"""The render stage's kernels (`kernels/render.py`; `csrc/render.cu`,
`csrc/render_pyramid.cu`): the tile sampler `render_sample`, the planar
band warp `planar_warp`, the multiband pyramid (`mb_reduce`, `mb_collapse`),
and the tables they read.

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
- bicubic2x's upsample: `resize_taps(n, 2n, "cubic")` at most 4 taps,
  expanding back to `resize_weights` exactly and fitting `upsample2x`'s
  tiles; a plain 4-tap formulation (H then W, as the kernel runs) within
  1e-6 of the dense `upsample2x_cubic`; `upsample2x` on a CPU tensor the
  dense version bit for bit, with no launch counted;
- the renderer's batching and the device form of `assemble_tiles`;
- the planar band compositor's multiband (`models/planar.composite_band`,
  (N, H, W) contributors with no leading dims) against the JAX package's at
  an odd band size: coverage equal, uint8 within one level;
- `planar_warp` on CPU tensors: its plain version, no launch counted; it
  raises on a wrong dtype, shape or interpolation;
- every wrapper raises on a tensor that is neither on the CPU nor CUDA;
- `kernels/render.py` reads only leaf modules of `ops` (they import
  nothing of the package), so the two layers never import each other.

On the card (`cuda`-marked, skipped here): each kernel against its plain
version: the sampler's colours and weights within 1e-5, its uint8 tiles at
most one level apart on at most 0.1 % of covered pixels with equal
coverage; the pyramid's levels within 1e-5 and its uint8 output under the
same gate, also at the planar band's rank and shape (N, 512, odd width)
and with 40 contributors; a repeat launch bit-identical and a tile's result
independent of the other tiles of its launch; `planar_warp` equal to its
plain version (`torch.equal`) in every interpolation, at a first band and
a last band past the images, with gains, an invalid image and images cut
by the canvas edge, and a whole multiband `composite_from_abs` scan on it
equal to the same scan on the plain warp; `upsample2x` within 2e-6 of
the dense products at the 38- and 102-view stacks and an odd one, and a
38-view ring rendered through it against the same render on the dense
upsample:

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
from autopanostitch_tpu_torch.utils import trace

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


@pytest.mark.parametrize("n", [1, 2, 3, 5, 301, 600, 601, 800])
def test_cubic_2x_taps_expand_to_resize_weights(n):
    """bicubic2x's tables: at most 4 taps, exactly the dense weights, and
    every tile of `upsample2x` along either axis fits its window."""
    first, taps = tsamp.resize_taps(n, 2 * n, "cubic")
    assert taps.shape == (2 * n, min(n, 4)) and (first >= 0).all()
    assert (first + taps.shape[1] <= n).all()
    dense = np.zeros((n, 2 * n), np.float32)
    for j in range(2 * n):
        dense[first[j]: first[j] + taps.shape[1], j] = taps[j]
    np.testing.assert_array_equal(dense, tsamp.resize_weights(n, 2 * n, "cubic"))
    for tile in kr._UPSAMPLE_TILE:
        f_d, t_d, t = kr.upsample_tables(n, tile, torch.device("cpu"))
        assert t == taps.shape[1] and np.array_equal(f_d.numpy(), first)
        assert np.array_equal(t_d.numpy(), taps)


def test_upsample_tables_raise_where_the_kernel_cannot_take_them(monkeypatch):
    first, taps = tsamp.resize_taps(40, 80, "cubic")
    wide = (np.maximum(first - 1, 0).astype(np.int32), np.pad(taps, ((0, 0), (0, 1))))
    back = (first[::-1].copy(), taps)
    for tables in (wide, back):
        monkeypatch.setattr(tsamp, "resize_taps", lambda *a, t=tables: t)
        with pytest.raises(ValueError, match="do not fit"):
            kr.upsample_tables.__wrapped__(40, 32, torch.device("cpu"))


def _upsample_by_taps(x):
    """2x Keys upsample of (N, H, W, C) from the 4-tap tables, as
    `upsample2x` runs it: along H, then along W, tap by tap."""
    for axis in (1, 2):
        n = x.shape[axis]
        first, taps = tsamp.resize_taps(n, 2 * n, "cubic")
        first, taps = torch.as_tensor(first).long(), torch.as_tensor(taps)
        shape = [1, 1, 1, 1]
        shape[axis] = 2 * n
        acc = torch.zeros_like(x.index_select(axis, first))
        for t in range(taps.shape[1]):
            acc = acc + taps[:, t].reshape(shape) * x.index_select(axis, first + t)
        x = acc
    return x


@pytest.mark.parametrize("shape", [(2, 6, 9, 4), (1, 301, 401, 4), (3, 600, 800, 4)])
def test_upsample_by_taps_matches_dense(shape):
    x = torch.as_tensor(np.random.default_rng(sum(shape)).uniform(size=shape).astype(np.float32))
    got = _upsample_by_taps(x)
    ref = tsamp.upsample2x_cubic(x)
    assert got.shape == ref.shape == (shape[0], 2 * shape[1], 2 * shape[2], 4)
    assert float((got - ref).abs().max()) <= 1e-6


def test_upsample2x_on_cpu_is_the_plain_version():
    x = torch.as_tensor(np.random.default_rng(5).uniform(size=(3, 17, 23, 4)).astype(np.float32))
    trace.reset_launch_counts()
    got = kr.upsample2x(x)
    assert torch.equal(got, tsamp.upsample2x_cubic(x)) and got.is_contiguous()
    assert trace.launch_counts()["upsample2x"] == trace.launch_counts()["render_plain_on_cuda"] == 0
    with pytest.raises(ValueError, match="float32"):
        kr.upsample2x(x[..., :3])


def test_launch_counts_report_upsample2x():
    trace.reset_launch_counts()
    trace.launched("upsample2x", 3)
    assert trace.launch_counts()["upsample2x"] == 3
    trace.reset_launch_counts()
    assert trace.launch_counts()["upsample2x"] == 0


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


def _warp_args(dev, interp, first=True, n=9, hw=(300, 400)):
    """`planar_warp`'s arguments for n views of a 3x3-like scan (image k
    shifted 27 px right and 9 px down of the last, with a small projective
    part so no coordinate is a whole pixel), gained, image 2 invalid; the
    canvas starts inside image 0 (it is cut by the canvas's top and left
    edges). first: the first band, 512 rows from world row 11.6; else a
    300-row band from row 267.6 that runs past every image's bottom. The
    width, 1003, is no multiple of a block."""
    rng = np.random.default_rng(17)
    h, w = hw
    base = rng.uniform(size=(h + 9 * n, w + 27 * n, 3)).astype(np.float32)
    imgs = np.stack([base[9 * k: 9 * k + h, 27 * k: 27 * k + w] for k in range(n)])
    t = lambda a, dtype=torch.float32: torch.as_tensor(a, dtype=dtype, device=dev)
    feathers = tsamp.feather_weights(h, w).numpy()
    gains = np.resize(GAINS, (n, 3)).astype(np.float32)
    images4 = torch.cat([t(imgs) * t(gains)[:, None, None, :],
                         t(feathers).expand(n, h, w)[..., None]], -1)
    fine4 = tsamp.upsample2x_cubic(images4) if interp == "bicubic2x" else None
    H_inv = np.tile(np.array([[1.01, 0.02, 0.3], [-0.015, 0.99, 0.7], [1e-5, -2e-5, 1.0]],
                             np.float32), (n, 1, 1))
    H_inv[:, 0, 2] -= 27.0 * np.arange(n)
    H_inv[:, 1, 2] -= 9.0 * np.arange(n)
    ok = np.arange(n) != 2
    band = (512, 1003, 17.3, 11.6) if first else (300, 1003, 17.3, 267.6)
    return (images4, fine4, t(H_inv), t(ok, torch.bool), *band, interp)


@pytest.mark.parametrize("interp", INTERPS)
def test_planar_warp_on_cpu_is_the_plain_version(interp):
    args = _warp_args("cpu", interp, n=4, hw=(40, 56))
    args = args[:4] + (24, 61) + args[6:]
    trace.reset_launch_counts()
    cols, ws = kr.planar_warp(*args)
    ref = kr.planar_warp_plain(*args)
    assert torch.equal(cols, ref[0]) and torch.equal(ws, ref[1])
    assert cols.shape == (4, 24, 61, 3) and ws.shape == (4, 24, 61)
    counts = trace.launch_counts()
    assert counts["planar_warp"] == counts["render_plain_on_cuda"] == 0
    assert float(ws[2].abs().max()) == 0.0 and float(cols[2].abs().max()) == 0.0  # not ok
    assert 0.2 < float((ws[0] > 0).float().mean()) < 1  # image 0 partly on the band


def test_launch_counts_list_planar_warp():
    trace.reset_launch_counts()
    assert trace.launch_counts()["planar_warp"] == 0
    trace.launched("planar_warp", 3)
    assert trace.launch_counts()["planar_warp"] == 3
    trace.reset_launch_counts()


@pytest.mark.parametrize("bad,match", [
    ("images_f64", "images4"), ("images_rgb", "images4"), ("fine_missing", "fine4"),
    ("fine_shape", "fine4"), ("h_shape", "H_inv"), ("h_f64", "H_inv"), ("ok_float", "ok"),
    ("ok_shape", "ok"), ("interp", "interpolation"), ("empty_band", "non-empty")])
def test_planar_warp_checks_its_arguments(bad, match):
    images4, fine4, H_inv, ok, bh, w, x0, y0, interp = _warp_args("cpu", "bicubic2x", n=3,
                                                                  hw=(8, 12))
    if bad == "images_f64":
        images4 = images4.double()
    elif bad == "images_rgb":
        images4 = images4[..., :3]
    elif bad == "fine_missing":
        fine4 = None
    elif bad == "fine_shape":
        fine4 = fine4[:, 1:]
    elif bad == "h_shape":
        H_inv = H_inv[:2]
    elif bad == "h_f64":
        H_inv = H_inv.double()
    elif bad == "ok_float":
        ok = ok.float()
    elif bad == "ok_shape":
        ok = ok[:, None]
    elif bad == "interp":
        interp = "lanczos"
    else:
        bh = 0
    with pytest.raises(ValueError, match=match):
        kr.planar_warp(images4, fine4, H_inv, ok, bh, w, x0, y0, interp)


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
    with pytest.raises(ValueError, match="unsupported device"):
        kr.upsample2x(torch.zeros((2, 8, 9, 4), device="meta"))
    warp = tuple(x.to("meta") if torch.is_tensor(x) else x
                 for x in _warp_args("cpu", "bilinear", n=2, hw=(8, 9)))
    with pytest.raises(ValueError, match="unsupported device"):
        kr.planar_warp(*warp)


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
    before = trace.launch_counts()["render_sample"]
    got = kr.render_sample(*args)
    ref = kr.render_sample_plain(*args)
    torch.cuda.synchronize()
    assert trace.launch_counts()["render_sample"] == before + 1
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
        trace.reset_launch_counts()
        out[d.type] = trender.render_rotational(
            torch.as_tensor(imgs, device=d), torch.as_tensor(feathers, device=d), R, K, canvas,
            gains=GAINS, tile=TILE, sizes=sizes, k1=k1)
        if d.type == "cuda":
            counts = trace.launch_counts()
            assert counts["render_sample"] and counts["mb_reduce"] and counts["mb_collapse"]
            assert counts["render_plain_on_cuda"] == 0
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
    names = ("mb_reduce", "mb_collapse", "render_plain_on_cuda")
    before = trace.launch_counts()
    u8, cov = tplanar.composite_band(*args, "multiband", 3, interp)
    torch.cuda.synchronize()
    assert tuple(trace.launch_counts()[k] - before[k] for k in names) == (2, 1, 0)
    cols, ws = tplanar.warp_band(*args, interp)
    _u8_gate(u8, cov, *kr.multiband_plain(cols, ws, 3, to_u8=True))
    assert 0.3 < float(cov.float().mean()) < 1


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("interp", INTERPS)
def test_planar_warp_kernel_matches_plain_on_card(interp, first):
    """`planar_warp` equal to its plain version on the card (`torch.equal`,
    both outputs) at the first band and at a last band past the images'
    bottom, gained, with an invalid image and one cut by the canvas edge; a
    repeat launch bit-identical."""
    dev = _cuda()
    args = _warp_args(dev, interp, first)
    names = ("planar_warp", "render_plain_on_cuda")
    before = trace.launch_counts()
    cols, ws = kr.planar_warp(*args)
    torch.cuda.synchronize()
    assert tuple(trace.launch_counts()[k] - before[k] for k in names) == (1, 0)
    ref = kr.planar_warp_plain(*args)
    assert torch.equal(cols, ref[0]) and torch.equal(ws, ref[1])
    assert float(ws[2].abs().max()) == 0.0  # the invalid image
    assert 0.05 < float((ws > 0).float().mean()) < 0.9
    again = kr.planar_warp(*args)
    assert torch.equal(cols, again[0]) and torch.equal(ws, again[1])


@pytest.mark.cuda
def test_planar_scan_on_planar_warp_matches_plain_on_card(monkeypatch):
    """A 3x3 scan of 800x600 crops at 35 % overlap composited multiband
    (bicubic, gains != 1) by `composite_from_abs`: one `planar_warp` a
    band and no plain version, and the uint8 panorama and coverage equal
    to the same scan on the plain warp on the card."""
    dev = _cuda()
    w, h, sx, sy = 800, 600, 520, 390
    env = synthdata.texture(5, h + 2 * sy, w + 2 * sx)
    offs = [(c * sx, r * sy) for r in range(3) for c in range(3)]
    imgs = np.stack(synthdata.planar_crops(env, [(x, y, w, h) for x, y in offs]))
    H_abs = np.tile(np.eye(3, dtype=np.float32), (9, 1, 1))
    H_abs[:, 0, 2], H_abs[:, 1, 2] = [x + 0.37 for x, _ in offs], [y - 0.21 for _, y in offs]
    H_abs[4, 0, 1], H_abs[4, 2, 0] = 0.002, 1e-6  # one view not a pure translation
    sizes = np.tile(np.array([h, w], np.int32), (9, 1))
    images = torch.as_tensor(imgs.astype(np.float32), device=dev)
    feathers = tsamp.feather_weights(h, w, device=dev).expand(9, h, w).contiguous()
    gains = np.resize(GAINS, (9, 3)).astype(np.float32)
    run = lambda: tplanar.composite_from_abs(images, feathers, sizes, H_abs, np.ones(9, bool),
                                             gains, "multiband", 3, interp="bicubic2x")
    trace.reset_launch_counts()
    got = run()
    counts = trace.launch_counts()
    bands = -(-got["panorama"].shape[0] // 512)
    assert bands == 3 and counts["planar_warp"] == bands and counts["render_plain_on_cuda"] == 0
    monkeypatch.setattr(kr, "planar_warp", kr.planar_warp_plain)
    ref = run()
    np.testing.assert_array_equal(got["coverage"], ref["coverage"])
    np.testing.assert_array_equal(got["panorama"], ref["panorama"])
    assert got["coverage"].mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(38, 600, 800, 4), (102, 600, 800, 4), (3, 301, 401, 4)])
def test_upsample2x_kernel_matches_dense_on_card(shape):
    """The kernel against the dense products (`upsample2x_cubic`) at the
    ring's and the sphere's stacks and an odd one: within 2e-6, the same 4
    products a tap axis in another summation order and with FMA; a repeat
    launch bit-identical."""
    dev = _cuda()
    x = torch.as_tensor(np.random.default_rng(shape[0]).uniform(size=shape).astype(np.float32),
                        device=dev)
    before = trace.launch_counts()["upsample2x"]
    got = kr.upsample2x(x)
    ref = tsamp.upsample2x_cubic(x)
    torch.cuda.synchronize()
    assert trace.launch_counts()["upsample2x"] == before + 1
    assert got.shape == ref.shape and got.is_contiguous()
    assert float((got - ref).abs().max()) <= 2e-6
    del ref
    assert torch.equal(got, kr.upsample2x(x))


@pytest.mark.cuda
def test_ring38_render_on_upsample2x_matches_dense_on_card(monkeypatch):
    """A 38-view 800x600 ring rendered by `render_tile_list` (spherical,
    multiband, bicubic2x) through the kernel, one launch a render, against
    the same render on the dense upsample: coverage equal, uint8 at most 1
    apart on at most 1e-4 of the covered pixels."""
    dev = _cuda()
    n, f, (w, h) = 38, 600.0, (800, 600)
    env = synthdata.smooth_texture(3, 1024, 2048)
    _, views, R, _ = synthdata.rotational_views(3, n_views=n, f=f, size=(w, h),
                                                yaw_step=2 * np.pi / n, env=env)
    R = R.astype(np.float32)
    K = np.tile(np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]], np.float32),
                (n, 1, 1))
    sizes = np.array([[h, w]] * n, np.int32)
    imgs = torch.as_tensor(np.stack(views).astype(np.float32), device=dev)
    feathers = tsamp.feather_weights(h, w, device=dev).expand(n, h, w).contiguous()
    tile = RenderConfig().tile
    canvas = trender.compute_canvas(R, K, sizes, "spherical", RenderConfig(), device=dev)
    sel, ok, org = trender.tile_contributors(canvas, R, K, sizes, tile, device=dev)
    gains = np.ones((n, 3), np.float32)
    render = lambda: trender.render_tile_list(imgs, feathers, R, K, gains, None, sel, ok, org,
                                              canvas, tile, "multiband", 3, 1.0, "bicubic2x")
    before = trace.launch_counts()["upsample2x"]
    u8, cov = render()
    torch.cuda.synchronize()
    assert trace.launch_counts()["upsample2x"] == before + 1
    monkeypatch.setattr(kr, "upsample2x", tsamp.upsample2x_cubic)
    u8_p, cov_p = render()
    assert torch.equal(cov, cov_p) and float(cov.float().mean()) > 0.5
    diff = (u8.int() - u8_p.int()).abs()
    assert int(diff.max()) <= 1
    assert int((diff.amax(-1) > 0).sum()) <= 1e-4 * int(cov_p.sum())
