"""The port's annotations (`models/annotate.py`), native host kernels
(`native/`) and `api` names against the JAX package's.

- Each annotate function on the same inputs: warped boxes within 1e-3 px
  (the boundary rays go through each package's float32 projections),
  drawings pixel-identical (both draw with PIL on the same numbers).
- `native.max_rectangle` and `hamming_2nn` against numpy.
- `api`: every name of the reference's.
- A config-driven stitch with `show_panorama_imgs_nums` gives the
  reference's annotated panorama.
"""

import numpy as np
import pytest

import parity_scenes
from autopanostitch_tpu import api as japi
from autopanostitch_tpu.models import annotate as jann
from autopanostitch_tpu.models import pipeline as jpipe
from autopanostitch_tpu_torch import api as tapi
from autopanostitch_tpu_torch import native
from autopanostitch_tpu_torch.models import annotate as tann
from autopanostitch_tpu_torch.models import crop as tcrop
from autopanostitch_tpu_torch.models import pipeline as tpipe
from test_torch_pipeline import one_torch_thread  # noqa: F401

def _cameras():
    R = np.stack([np.eye(3), np.array([[0.98, 0, 0.199], [0, 1, 0], [-0.199, 0, 0.98]])])
    K = np.tile(np.array([[200.0, 0, 99.5], [0, 200.0, 74.5], [0, 0, 1]]), (2, 1, 1))
    return R.astype(np.float32), K.astype(np.float32), np.array([[150, 200], [150, 200]])


@pytest.mark.parametrize("mode", ["spherical", "cylindrical", "stereographic"])
@pytest.mark.parametrize("k1", [None, np.array([0.05, -0.03], np.float32)])
def test_warped_boxes_rotational_match_jax(mode, k1):
    R, K, sizes = _cameras()
    canvas = {"mode": mode, "f_pan": 200.0, "x0": -0.6, "y0": -0.5,
              "R_ref": np.eye(3, dtype=np.float32)}
    bj, cj = jann.warped_boxes_rotational(canvas, R, K, sizes, k1=k1)
    bt, ct = tann.warped_boxes_rotational(canvas, R, K, sizes, k1=k1)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, equal_nan=True)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-3)


def test_warped_boxes_planar_match_jax():
    H = np.stack([np.eye(3), [[1.0, 0.02, 150.0], [0.01, 1.0, 12.0], [1e-5, 0, 1.0]]])
    sizes = np.array([[150, 200], [150, 200]])
    bj, cj = jann.warped_boxes_planar(H, sizes, (-3.0, -4.0), 0.8)
    bt, ct = tann.warped_boxes_planar(H, sizes, (-3.0, -4.0), 0.8)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ct, cj)


def test_drawings_match_jax():
    rng = np.random.default_rng(0)
    pano = (rng.random((120, 220, 3)) * 255).astype(np.uint8)
    boxes = [np.array([[10.0, 10.0], [150.0, 10.0], [150.0, 80.0], [10.0, 80.0]]),
             np.array([[60.0, 30.0], [np.nan, np.nan], [200.0, 100.0], [60.0, 100.0]])]
    centers = np.array([[80.0, 45.0], [130.0, 65.0]])
    np.testing.assert_array_equal(
        tann.draw_annotations(pano, boxes, centers, labels=[3, 7], crop_rect=(5, 95, 5, 195)),
        jann.draw_annotations(pano, boxes, centers, labels=[3, 7], crop_rect=(5, 95, 5, 195)))
    xy = rng.uniform(0, 200, (40, 2))
    mask = rng.random(40) > 0.2
    scale = rng.uniform(0.5, 20, 40)
    np.testing.assert_array_equal(tann.draw_keypoints(pano, xy, mask, scale),
                                  jann.draw_keypoints(pano, xy, mask, scale))
    np.testing.assert_array_equal(tann.draw_keypoints(pano / 255.0, xy, mask),
                                  jann.draw_keypoints(pano / 255.0, xy, mask))
    inl = rng.random(10) > 0.5
    np.testing.assert_array_equal(
        tann.draw_matches(pano, pano[:100], xy[:10], xy[10:20], inl),
        jann.draw_matches(pano, pano[:100], xy[:10], xy[10:20], inl))
    pairs = np.array([[0, 1], [1, 2], [2, 3], [0, 3]])
    acc = np.array([True, True, False, True])
    nin = np.array([40, 12, 3, 25])
    comps = np.array([0, 0, 0, 3, 5])
    np.testing.assert_array_equal(tann.draw_adjacency_graph(pairs, acc, nin, 5, comps, size=320),
                                  jann.draw_adjacency_graph(pairs, acc, nin, 5, comps, size=320))
    np.testing.assert_array_equal(tann.bright_colors(7, seed=2), jann.bright_colors(7, seed=2))


def test_annotated_stitch_matches_jax():
    """config3 with show_panorama_imgs_nums in both packages: the annotated
    spherical panorama has the reference's shape, and differs from the
    plain panorama where the outlines are drawn."""
    iset, cfg = parity_scenes.config3_spherical_ba()
    cfg = cfg.replace(post=cfg.post.__class__(show_panorama_imgs_nums=True))
    pt = tpipe.stitch(iset, cfg, seed=0, device="cpu").panoramas[0]
    pj = jpipe.stitch(iset, cfg, seed=0).panoramas[0]
    at, aj = pt["projections_annotated"], pj["projections_annotated"]
    assert set(at) == set(aj) == {"spherical"}
    assert at["spherical"].shape == aj["spherical"].shape == pt["projections"]["spherical"].shape
    drawn_t = (at["spherical"] != pt["projections"]["spherical"]).any(-1)
    drawn_j = (aj["spherical"] != pj["projections"]["spherical"]).any(-1)
    assert drawn_t.sum() > 500
    assert (drawn_t & drawn_j).sum() > 0.8 * drawn_j.sum()


def _max_rect_numpy(mask):
    """Brute force over every rectangle of a small mask."""
    H, W = mask.shape
    c = np.pad(np.cumsum(np.cumsum(mask.astype(int), 0), 1), ((1, 0), (1, 0)))
    best = 0
    for r0 in range(H):
        for r1 in range(r0 + 1, H + 1):
            for c0 in range(W):
                for c1 in range(c0 + 1, W + 1):
                    a = (r1 - r0) * (c1 - c0)
                    if a > best and c[r1, c1] - c[r0, c1] - c[r1, c0] + c[r0, c0] == a:
                        best = a
    return best


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_max_rectangle_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((14, 17)) > 0.25
    rect = native.max_rectangle(mask)
    r0, r1, c0, c1 = rect
    assert mask[r0:r1, c0:c1].all()
    assert (r1 - r0) * (c1 - c0) == _max_rect_numpy(mask)
    assert native.max_rectangle(np.zeros((5, 6), bool)) is None
    big = np.zeros((300, 400), bool)
    big[20:250, 30:390] = True
    big[100, 200] = False
    assert native.max_rectangle(big) == tcrop.largest_inscribed_rect(big)


def test_native_hamming_2nn_matches_numpy():
    rng = np.random.default_rng(5)
    A = rng.integers(0, 256, (60, 32), dtype=np.uint8)
    B = rng.integers(0, 256, (90, 32), dtype=np.uint8)
    idx, d1, d2 = native.hamming_2nn(A, B)
    D = np.unpackbits(A[:, None] ^ B[None], axis=-1).sum(-1)
    order = np.argsort(D, axis=1, kind="stable")
    np.testing.assert_array_equal(d1, D[np.arange(60), order[:, 0]])
    np.testing.assert_array_equal(d2, D[np.arange(60), order[:, 1]])
    np.testing.assert_array_equal(D[np.arange(60), idx], d1)
    with pytest.raises(ValueError):
        native.hamming_2nn(A, B[:, :16])


def test_api_has_every_reference_name():
    ref = {n for n in dir(japi) if not n.startswith("_")} - {"annotations"}
    port = {n for n in dir(tapi) if not n.startswith("_")}
    assert ref <= port, ref - port
    for name in ref:
        assert callable(getattr(tapi, name)), name


def test_initialize_cameras_summary_matches_jax():
    from autopanostitch_tpu.models import bundle as jbundle

    f, w, h = 300.0, 320, 240
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]])
    pairs, Hs = [], []
    for i in range(3):
        t = 0.3
        R = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]])
        pairs.append((i, i + 1))
        Hs.append(K @ R @ np.linalg.inv(K))
    pairs, Hs = np.array(pairs), np.array(Hs, np.float32)
    counts = np.zeros((4, 4), np.int32)
    counts[pairs[:, 0], pairs[:, 1]] = counts[pairs[:, 1], pairs[:, 0]] = 100
    sizes = np.array([[h, w]] * 4)
    a = tapi.initialize_cameras_summary(pairs, Hs, counts, sizes)
    b = jbundle.initialize_cameras_summary(pairs, Hs, counts, sizes)
    assert set(a) == set(b) and a["seed"] == b["seed"] and a["no_rotation"] == b["no_rotation"]
    np.testing.assert_allclose(a["f"], b["f"], rtol=1e-6)
    np.testing.assert_allclose(a["R"], b["R"], atol=1e-6)
