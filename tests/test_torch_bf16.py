"""The port's matchers with `compute_dtype="bfloat16"`, its descriptor
widths and k against the JAX package, and `stitch`'s early refusals.

- bf16: the reference rounds both operands of every distance's cross term
  to bf16 and sums their products in float32 (`pairwise_sqdist`); the
  port's plain version takes the same rounded operands and one float32
  product. Products of bf16 values are exact in float32, so only the order
  of summation differs: `nn_idx` must be identical on every row whose
  neighbour gaps exceed 1e-5, distances within 1e-5, ratio decisions
  identical. Before the port honoured the
  dtype, its float32 result differed from the reference's bf16 one in 76
  of these 1015 rows.
- Widths: a 2x2x4 SIFT grid (D = 16) stitched in both packages; k = 12
  pooled neighbours against the reference's `global_knn`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_scenes
from autopanostitch_tpu.config import DetectorConfig, StitchConfig, TPUConfig
from autopanostitch_tpu.models import features as jfeatures
from autopanostitch_tpu.models import pipeline as jpipe
from autopanostitch_tpu.ops import matching as jmt
from autopanostitch_tpu_torch.models import features as tfeatures
from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.ops import matching as tmt
from test_config_flags import _two_view_scene
from test_torch_pipeline import _assert_golden, one_torch_thread  # noqa: F401

TIE = 1e-5


@pytest.fixture(scope="module")
def two_view_desc():
    """The scene of tests/test_config_flags.py's bf16 test at 512 keypoints
    and 3 octaves: JAX's (2, 512, 128) descriptors and mask."""
    stack, sizes = _two_view_scene()
    feats = jfeatures.extract_features(jnp.asarray(stack), sizes,
                                       DetectorConfig(max_keypoints=512, num_octaves=3))
    return np.array(feats.desc), np.array(feats.mask)


def _distinct(d, tie=TIE):
    """(F, k) bool: the neighbour is apart from its neighbours in the list
    by more than `tie`."""
    gaps = np.abs(np.diff(d, axis=1))
    out = np.ones(d.shape, bool)
    out[:, :-1] &= gaps > tie
    out[:, 1:] &= gaps > tie
    return out


def test_global_match_stack_bf16_matches_jax(two_view_desc):
    desc, mask = two_view_desc
    oj = [np.asarray(x) for x in jmt.global_match_stack(jnp.asarray(desc), jnp.asarray(mask), k=4,
                                                         compute_dtype="bfloat16")]
    ot = [x.numpy() for x in tmt.global_match_stack(torch.as_tensor(desc), torch.as_tensor(mask),
                                                     k=4, compute_dtype="bfloat16")]
    rows = mask.reshape(-1)
    assert rows.sum() == 1015
    distinct = _distinct(oj[1])[rows]
    assert distinct.mean() > 0.9
    np.testing.assert_array_equal(ot[0][rows][distinct], oj[0][rows][distinct])
    real = oj[1] < 1e17
    np.testing.assert_allclose(ot[1][real], oj[1][real], rtol=0, atol=TIE)
    np.testing.assert_array_equal(ot[2][ot[3]], oj[2][oj[3]])
    np.testing.assert_array_equal(ot[3], oj[3])
    # the float32 run differs from the bf16 one: the dtype is honoured
    o32 = tmt.global_match_stack(torch.as_tensor(desc), torch.as_tensor(mask), k=4)
    assert int((o32[0].numpy() != ot[0]).any(1)[rows].sum()) > 50


def test_match_all_pairs_bf16_matches_jax(two_view_desc):
    desc, mask = two_view_desc
    pj, ij, mj, nj = jmt.match_all_pairs(jnp.asarray(desc), jnp.asarray(mask), ratio=0.6,
                                         max_matches=256, compute_dtype="bfloat16")
    pt, it, mt_, nt = tmt.match_all_pairs(torch.as_tensor(desc), torch.as_tensor(mask), ratio=0.6,
                                          max_matches=256, compute_dtype="bfloat16")
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(mt_.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    i1, d1, d2 = tmt.two_nn(torch.as_tensor(desc[0]), torch.as_tensor(mask[0]),
                            torch.as_tensor(desc[1]), torch.as_tensor(mask[1]), "bfloat16")
    j1, e1, e2 = jmt.two_nn(jnp.asarray(desc[0]), jnp.asarray(mask[0]), jnp.asarray(desc[1]),
                            jnp.asarray(mask[1]), jnp.bfloat16)
    ok = np.abs(np.asarray(e2) - np.asarray(e1)) > TIE
    np.testing.assert_array_equal(i1.numpy()[ok], np.asarray(j1)[ok])
    np.testing.assert_allclose(d1.numpy(), np.asarray(e1), rtol=0, atol=TIE)
    np.testing.assert_allclose(d2.numpy(), np.asarray(e2), rtol=0, atol=TIE)


def test_config3_bf16_stitch_matches_jax():
    """config3 stitched with compute_dtype="bfloat16" in both packages: the
    same pairs, acceptance, components and panorama within
    tests/test_parity.py's tolerances."""
    iset, cfg = parity_scenes.config3_spherical_ba()
    cfg = cfg.replace(tpu=TPUConfig(compute_dtype="bfloat16"))
    res_j = jpipe.stitch(iset, cfg, seed=0)
    res_t = tpipe.stitch(iset, cfg, seed=0, device="cpu")
    _assert_golden(parity_scenes.extract_artifacts(iset, res_t),
                   parity_scenes.extract_artifacts(iset, res_j))


def test_descriptor_width_16_stitch_matches_jax():
    """D = 16 (descriptor_width=2, descriptor_bins=4), which B1 takes as 32
    zero-padded columns on the card: the planar pair of config1 stitched in
    both packages."""
    iset, cfg = parity_scenes.config1_planar_pair()
    det = cfg.detector.__class__(max_keypoints=512, num_octaves=3, descriptor_width=2,
                                 descriptor_bins=4)
    cfg = cfg.replace(detector=det)
    res_j = jpipe.stitch(iset, cfg, seed=0)
    res_t = tpipe.stitch(iset, cfg, seed=0, device="cpu")
    assert res_t.features.desc.shape[-1] == 16
    _assert_golden(parity_scenes.extract_artifacts(iset, res_t),
                   parity_scenes.extract_artifacts(iset, res_j))


def test_pooled_knn_k12_matches_jax(two_view_desc):
    desc, mask = two_view_desc
    F = desc.shape[0] * desc.shape[1]
    ids = np.repeat(np.arange(2, dtype=np.int32), desc.shape[1])
    flat = desc.reshape(F, -1)
    nn_j, d_j = (np.asarray(x) for x in jmt.global_knn(
        jnp.asarray(flat), jnp.asarray(mask.reshape(-1)), jnp.asarray(ids), k=12))
    nn_t, d_t = (x.numpy() for x in tmt.global_knn(
        torch.as_tensor(flat), torch.as_tensor(mask.reshape(-1)), torch.as_tensor(ids), k=12))
    distinct = _distinct(d_j)
    assert distinct.mean() > 0.95
    np.testing.assert_array_equal(nn_t[distinct], nn_j[distinct])
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=TIE)


def _no_work(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the feature stage ran before the refusal")

    monkeypatch.setattr(tfeatures, "extract_features", fail)


@pytest.mark.parametrize("fields,device,match", [
    ({"matching": {"method": "lsh"}}, "cpu", "method"),
    ({"tpu": {"compute_dtype": "float16"}}, "cpu", "compute_dtype"),
    ({"matching": {"k": 17}}, "cuda", "16"),
    ({"detector": {"descriptor_width": 4, "descriptor_bins": 18}}, "cuda", "bins|256"),
])
def test_stitch_refuses_before_any_work(monkeypatch, fields, device, match):
    """What neither package takes (a method, a dtype) is refused on any
    device, and what the card's kernels do not take (k > 16, a width above
    256) on the card, before the feature stage runs (on this machine the
    card's checks come before the missing device is noticed)."""
    import dataclasses

    _no_work(monkeypatch)
    base = StitchConfig()
    cfg = base.replace(**{sec: dataclasses.replace(getattr(base, sec), **f)
                          for sec, f in fields.items()})
    iset, _ = parity_scenes.config1_planar_pair()
    with pytest.raises(ValueError, match=match):
        tpipe.stitch(iset, cfg, device=device)


def test_stitch_takes_k_above_16_on_the_cpu(two_view_desc):
    """The plain version takes any k: k = 20 pooled against JAX."""
    desc, mask = two_view_desc
    F = desc.shape[0] * desc.shape[1]
    ids = np.repeat(np.arange(2, dtype=np.int32), desc.shape[1])
    nn_j, d_j = (np.asarray(x) for x in jmt.global_knn(
        jnp.asarray(desc.reshape(F, -1)), jnp.asarray(mask.reshape(-1)), jnp.asarray(ids), k=20))
    nn_t, d_t = (x.numpy() for x in tmt.global_knn(
        torch.as_tensor(desc.reshape(F, -1)), torch.as_tensor(mask.reshape(-1)),
        torch.as_tensor(ids), k=20))
    distinct = _distinct(d_j)
    np.testing.assert_array_equal(nn_t[distinct], nn_j[distinct])
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=TIE)
