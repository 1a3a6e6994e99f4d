"""The torch port's recovery paths against the JAX package: the pairwise
matcher on kernel B1's pair-list mode, the pairwise rescue, both second
passes, and the `config4_multipano` golden that needs them.

- `two_nn` / `match_pair` / `match_all_pairs` / `match_pair_list`: equal
  indices, masks and counts on descriptors with small integer entries, so
  every squared distance is exact in float32 and ties are true ties (on
  unit-norm float data two distances 2e-6 apart swap places between two
  correct float32 implementations).
- `knn_pairs_plain` against a numpy brute force: equal indices, distances
  to 1e-4.
- `_vote_candidate_pairs`, `_merge_graphs`, the rescue and the second
  passes: equal pairs, acceptance and components. RANSAC draws differ
  between the packages (torch.Generator vs threefry), so these scenes are
  ones where every pair's verdict is clear.
- The golden: tests/test_parity.py's tolerances.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_scenes
import synthdata
from autopanostitch_tpu.config import RenderConfig
from autopanostitch_tpu.models import pipeline as jpipe
from autopanostitch_tpu.ops import matching as jmt
from autopanostitch_tpu.ops.sift import SiftFeatures as JaxSiftFeatures
from autopanostitch_tpu.utils import image_io
from autopanostitch_tpu.utils.image_io import ImageSet
from autopanostitch_tpu_torch import convert
from autopanostitch_tpu_torch.kernels import knn as tknn
from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.ops import matching as tmt
from test_torch_pipeline import REPO, _assert_golden, one_torch_thread  # noqa: F401


def _int_descriptors(seed, N=4, K=96, D=128):
    """Descriptors with entries in 0..7 (exact float32 arithmetic): each
    image re-observes a shared base set with integer noise; some slots
    invalid (one of them an otherwise perfect match), and a duplicated
    target slot forces exact distance ties."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 8, (K, D))
    desc = np.stack([np.clip(base[rng.permutation(K)] + rng.integers(-1, 2, (K, D)), 0, 7)
                     for _ in range(N)]).astype(np.float32)
    mask = rng.random((N, K)) > 0.1
    mask[0, 3] = False  # an invalid query
    desc[1, 10] = desc[1, 11]  # identical targets: the lower slot must win
    return desc, mask


@pytest.mark.parametrize("ratio,max_matches", [(0.8, 512), (0.9, 40)])
def test_pairwise_matcher_matches_jax(ratio, max_matches):
    desc, mask = _int_descriptors(0)
    dj, mj = jnp.asarray(desc), jnp.asarray(mask)
    dt, mt_ = torch.as_tensor(desc), torch.as_tensor(mask)
    pj = jmt.match_all_pairs(dj, mj, ratio=ratio, max_matches=max_matches)
    pt = tmt.match_all_pairs(dt, mt_, ratio=ratio, max_matches=max_matches)
    np.testing.assert_array_equal(pt[0], np.asarray(pj[0]))
    for a, b in zip(pt[1:], pj[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool((pt[3] > 0).all())
    # a shorter second set (Ma != Mb) through the single-pair entry point
    rj = jmt.match_pair(dj[0], mj[0], dj[1, :70], mj[1, :70], ratio=ratio,
                        max_matches=max_matches)
    rt = tmt.match_pair(dt[0], mt_[0], dt[1, :70], mt_[1, :70], ratio=ratio,
                        max_matches=max_matches)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # an explicit pair list in another order
    plist = np.array([[2, 3], [0, 2], [1, 3]], np.int32)
    lj = jmt.match_pair_list(dj, mj, jnp.asarray(plist), ratio=ratio, max_matches=max_matches)
    lt = tmt.match_pair_list(dt, mt_, plist, ratio=ratio, max_matches=max_matches)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_match_pair_list_chunks_match_jax(monkeypatch):
    """A pair list longer than one memory-bounded chunk: three calls of
    `knn_pairs` of two pairs each, concatenated, equal JAX's single scan."""
    desc, mask = _int_descriptors(3, N=4, K=96)
    monkeypatch.setattr(tmt, "_PAIR_CHUNK_BYTES", 2 * tmt._PAIR_BYTES_PER_SLOT * 96)
    calls = []

    def counted(desc_, valid, pairs, k, compute_dtype="float32"):
        calls.append(pairs.shape[0])
        return tknn.knn_pairs(desc_, valid, pairs, k, compute_dtype=compute_dtype)

    monkeypatch.setattr(tmt, "knn_pairs", counted)
    plist = np.array([[2, 3], [0, 2], [1, 3], [0, 1], [1, 2], [0, 3]], np.int32)
    lj = jmt.match_pair_list(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(plist),
                             ratio=0.8, max_matches=64)
    lt = tmt.match_pair_list(torch.as_tensor(desc), torch.as_tensor(mask), plist, ratio=0.8,
                             max_matches=64)
    assert calls == [2, 2, 2]
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool((lt[2] > 0).all())


def test_two_nn_matches_jax_with_invalid_queries_and_ties():
    desc, mask = _int_descriptors(1)
    ij, d1j, d2j = jmt.two_nn(jnp.asarray(desc[0, :50]), jnp.asarray(mask[0, :50]),
                              jnp.asarray(desc[1]), jnp.asarray(mask[1]))
    it, d1t, d2t = tmt.two_nn(torch.as_tensor(desc[0, :50]), torch.as_tensor(mask[0, :50]),
                              torch.as_tensor(desc[1]), torch.as_tensor(mask[1]))
    # invalid queries keep their true nearest target; only d1/d2 are masked
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(d1t.numpy(), np.asarray(d1j))
    np.testing.assert_array_equal(d2t.numpy(), np.asarray(d2j))
    assert d1t[3] == 1e18 and it[3] != 0


def test_knn_pairs_plain_matches_numpy():
    rng = np.random.default_rng(2)
    desc = rng.standard_normal((3, 20, 32)).astype(np.float32)
    valid = rng.random((3, 20)) > 0.3
    valid[2, 2:] = False  # image 2 has only 2 valid slots
    desc[1, 5] = desc[1, 9]
    pairs = np.array([[0, 1], [2, 0], [1, 2]], np.int32)
    idx, dist = tknn.knn_pairs(torch.as_tensor(desc), torch.as_tensor(valid),
                               torch.as_tensor(pairs), 2)
    assert idx.shape == (3, 2, 20, 2) and idx.dtype == torch.int32
    for p, (a, b) in enumerate(pairs):
        for side, (q, t) in enumerate(((a, b), (b, a))):
            d = ((desc[q][:, None].astype(np.float64) - desc[t][None]) ** 2).sum(-1)
            d[:, ~valid[t]] = 1e18
            order = np.argsort(d, axis=1, kind="stable")[:, :2]
            np.testing.assert_array_equal(idx[p, side].numpy(), order)
            np.testing.assert_allclose(dist[p, side].numpy(), np.take_along_axis(d, order, 1),
                                       rtol=1e-5, atol=1e-4)


def _graph(pairs, accepted, n, M=4, seed=0):
    rng = np.random.default_rng(seed)
    P = len(pairs)
    return tpipe.MatchGraph(
        pairs=np.asarray(pairs, np.int32), pair_idx=rng.integers(0, 50, (P, M, 2)),
        pair_mask=rng.random((P, M)) > 0.3, H=rng.standard_normal((P, 3, 3)).astype(np.float32),
        inliers=rng.random((P, M)) > 0.5, num_inliers=rng.integers(0, 40, P),
        accepted=np.asarray(accepted, bool), counts=rng.integers(0, 30, (n, n)))


def test_vote_candidates_and_merge_match_jax():
    rng = np.random.default_rng(3)
    votes = rng.integers(0, 20, (9, 9))
    votes = np.triu(votes, 1) + np.triu(votes, 1).T
    votes[4] = votes[:, 4] = 0  # an image without votes
    for m in (1, 3, 8):
        np.testing.assert_array_equal(tpipe._vote_candidate_pairs(votes, m),
                                      jpipe._vote_candidate_pairs(votes, m))
    g1 = _graph([[0, 1], [1, 2], [2, 3], [4, 5]], [True, False, True, True], 6, M=4, seed=1)
    g2 = _graph([[0, 1], [2, 3], [3, 5]], [True, False, True], 6, M=6, seed=2)
    mt_, mj = tpipe._merge_graphs(g1, g2), jpipe._merge_graphs(g1, g2)
    for k in tpipe.MatchGraph.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(mt_, k), getattr(mj, k), err_msg=k)
    assert len(mt_.pairs) == 5  # (2, 3) and (4, 5) of g1 ride along
    assert tpipe._merge_graphs(g2, g2) is g2


def _fragmented_set():
    """config3's first two views and a noise image: a singleton component."""
    iset, cfg = parity_scenes.config3_spherical_ba()
    imgs = np.asarray(iset.images)[:3].copy()
    imgs[2] = np.random.default_rng(0).uniform(size=imgs[2].shape).astype(np.float32)
    return ImageSet(images=imgs, sizes=iset.sizes[:3], names=iset.names[:3]), cfg


@pytest.fixture(scope="module")
def fragmented():
    iset, cfg = _fragmented_set()
    feats = tpipe.features_stage.extract_features(torch.as_tensor(iset.images), iset.sizes,
                                                  cfg.detector)
    return iset, cfg, feats


@pytest.mark.parametrize("ratio,max_images", [(0.6, 64), (0.05, 64), (0.05, 2)])
def test_pairwise_rescue_matches_jax(fragmented, ratio, max_images):
    """Both packages rescue the same first-pass graph on the same features:
    the default (nothing better found), a starved pooled ratio (the rescue
    recovers the pair and is adopted) and the vote-bounded branch."""
    iset, cfg, feats = fragmented
    cfg = cfg.replace(matching=dataclasses.replace(
        cfg.matching, ratio_threshold=ratio, pairwise_rescue_max_images=max_images))
    jfeats = JaxSiftFeatures(*[jnp.asarray(x.numpy()) for x in feats])
    pairs, pair_idx, pair_mask, counts, votes = jpipe.match_features(jfeats, cfg,
                                                                     return_votes=True)
    votes = votes()
    if len(pairs):
        pairs, pair_idx, pair_mask = jpipe.select_candidate_pairs(
            pairs, pair_idx, pair_mask, counts, cfg.image_match.m_brown_lowe)
    jgraph = jpipe.verify_matches(jfeats, pairs, pair_idx, pair_mask, counts, cfg,
                                  jpipe.host_prng_key(0))
    comps = jpipe.connected_components(3, jgraph.pairs, jgraph.accepted)
    gj, cj, aj = jpipe.pairwise_rescue(jfeats, jgraph, comps, 3, cfg, jpipe.host_prng_key(0),
                                       votes=votes)
    gt, ct, at = tpipe.pairwise_rescue(feats, convert.match_graph(jgraph), comps, 3, cfg,
                                       tpipe.derived_generator("cpu", 0, 3), votes=votes)
    assert at == aj and at == (ratio < 0.1)
    np.testing.assert_array_equal(ct, cj)
    acc = lambda g: sorted(map(tuple, np.asarray(g.pairs)[np.asarray(g.accepted, bool)].tolist()))
    assert acc(gt) == acc(gj) == [(0, 1)]


def test_stitch_rescues_a_fragmented_set(fragmented):
    """The old NotImplementedError case: the rescue runs, the singleton is
    left out, and the pair is stitched through the pairwise second pass."""
    iset, cfg, _ = fragmented
    timer = tpipe.StageTimer()
    res = tpipe.stitch(iset, cfg, seed=0, device="cpu", timer=timer)
    assert len(res.panoramas) == 1
    np.testing.assert_array_equal(res.panoramas[0]["members"], [0, 1])
    assert {"pairwise_rescue", "second_pass"} <= set(timer.report())


def test_second_pass_component_matches_jax():
    """A set ingested at half the size of its originals: the second pass
    re-resizes to the render limits (2x), re-extracts, re-matches every
    member pair and re-verifies, as the reference does."""
    env = synthdata.texture(11, 420, 760)
    views = synthdata.planar_crops(env, [(0, 0, 440, 380), (250, 20, 440, 380),
                                         (60, 40, 440, 380)])
    iset = image_io.image_set_from_arrays(views, height_limit=190, width_limit=220,
                                          keep_originals=True)
    _, cfg = parity_scenes.config1_planar_pair()
    cfg = cfg.replace(render=RenderConfig(height_limit=380, width_limit=440))
    members = np.array([0, 1, 2])
    sj = jpipe.second_pass_component(iset, members, cfg, jpipe.host_prng_key(0))
    st = tpipe.second_pass_component(iset, members, cfg, tpipe.derived_generator("cpu", 0, 2),
                                     "cpu")
    assert st[0].names == sj[0].names
    np.testing.assert_array_equal(st[0].sizes, sj[0].sizes)
    np.testing.assert_array_equal(st[0].sizes, [[380, 440]] * 3)
    assert st[1].shape == (3, 384, 448, 3)
    np.testing.assert_array_equal(st[3].pairs, sj[3].pairs)
    np.testing.assert_array_equal(st[3].accepted, np.asarray(sj[3].accepted))
    assert np.asarray(st[3].accepted).all()
    # the pairwise second pass on the first-pass features, in global indices
    feats = tpipe.features_stage.extract_features(torch.as_tensor(iset.images), iset.sizes,
                                                  cfg.detector)
    jfeats = JaxSiftFeatures(*[jnp.asarray(x.numpy()) for x in feats])
    first = _graph([[0, 1]], [True], 3)
    gt = tpipe.second_pass_matching(feats, members[1:], first, cfg,
                                    tpipe.derived_generator("cpu", 0, 1))
    gj = jpipe.second_pass_matching(jfeats, members[1:], first, cfg, jpipe.host_prng_key(0))
    np.testing.assert_array_equal(gt.pairs, gj.pairs)
    np.testing.assert_array_equal(gt.pairs, [[1, 2]])
    np.testing.assert_array_equal(gt.accepted, np.asarray(gj.accepted))
    np.testing.assert_array_equal(gt.counts, gj.counts)
    assert tpipe.second_pass_component(ImageSet(iset.images, iset.sizes, iset.names), members,
                                       cfg, None, "cpu") is None


def test_config4_golden_parity():
    iset, cfg = parity_scenes.config4_multipano()
    timer = tpipe.StageTimer()
    res = tpipe.stitch(iset, cfg, seed=0, device="cpu", timer=timer)
    with np.load(os.path.join(REPO, "tests", "goldens", "config4_multipano.npz")) as z:
        golden = {k: z[k] for k in z.files}
    _assert_golden(parity_scenes.extract_artifacts(iset, res), golden)
    assert {"pairwise_rescue", "second_pass", "bundle_adjustment_h"} <= set(timer.report())
