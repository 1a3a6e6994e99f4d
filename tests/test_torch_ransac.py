"""Parity of the torch port's batched RANSAC with the JAX package.

Torch cannot reproduce the reference's threefry streams, so these tests
draw the reference's own minimal sets (`_sample_minimal_sets` with the keys
`ransac_fit` splits) and inject them into the port: the hypotheses are then
identical, H agrees to rtol 1e-4 of its largest entry and the inlier sets
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autopanostitch_tpu.ops import ransac as jrs
from autopanostitch_tpu_torch.ops import ransac as trs
from test_torch_pipeline import one_torch_thread  # noqa: F401


def _pairs(seed, P=6, M=96, outlier=0.35):
    rng = np.random.default_rng(seed)
    src = np.zeros((P, M, 2), np.float32)
    dst = np.zeros((P, M, 2), np.float32)
    mask = np.zeros((P, M), bool)
    for p in range(P):
        H = np.eye(3) + 0.05 * rng.standard_normal((3, 3))
        H[2, :2] *= 0.01
        H[:2, 2] = rng.uniform(-80, 80, 2)
        n = int(rng.integers(20, M + 1))
        s = rng.uniform(0, 320, (n, 2))
        ph = np.concatenate([s, np.ones((n, 1))], 1) @ H.T
        d = ph[:, :2] / ph[:, 2:] + 0.5 * rng.standard_normal((n, 2))
        bad = rng.random(n) < outlier
        d[bad] = rng.uniform(0, 320, (int(bad.sum()), 2))
        src[p, :n], dst[p, :n], mask[p, :n] = s, d, True
    mask[-1, 3:] = False  # a starved pair (fewer valid matches than a model needs)
    return src, dst, mask


def _assert_h_close(got, ref, rtol=1e-4):
    """H agrees to rtol relative to its largest entry (entries span ~1e-4
    perspective terms to ~1e2 translations)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(got - ref) <= rtol * scale).all(), np.abs(got - ref).max()


def _reference_sets(keys, mask, batch, total, p=4):
    """(P, nsub, sub, p): the minimal sets `ransac_fit` draws from each
    pair's key (jax.random.split(key, nsub) per pair)."""
    nsub = max(1, (total + batch - 1) // batch)
    sub = min(batch, total)
    out = []
    for key, m in zip(keys, mask):
        ks = jax.random.split(jnp.asarray(key), nsub)
        out.append([np.asarray(jrs._sample_minimal_sets(ks[c], jnp.asarray(m), sub, p))
                    for c in range(nsub)])
    return torch.as_tensor(np.asarray(out))


@pytest.mark.parametrize("conf,max_iter", [(99.9, 500), (99.0, 64), (100.0, 300), (50.0, 1000)])
def test_num_trials(conf, max_iter):
    assert trs.num_trials(conf, "projective", max_iter) == jrs.num_trials(conf, "projective", max_iter)


@pytest.mark.parametrize("batch,total", [(64, 64), (64, 160)])
def test_ransac_fit_with_injected_minimal_sets(batch, total):
    src, dst, mask = _pairs(0)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), len(src)))
    ref = [jrs.ransac_fit(jnp.asarray(s), jnp.asarray(d), jnp.asarray(m), jnp.asarray(k),
                          threshold=5.5, batch=batch, total=total)
           for s, d, m, k in zip(src, dst, mask, keys)]
    got = trs.ransac_fit(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(mask),
                         threshold=5.5, batch=batch, total=total,
                         minimal_sets=_reference_sets(keys, mask, batch, total))
    for p, r in enumerate(ref):
        assert bool(got["success"][p]) == bool(r.success)
        np.testing.assert_array_equal(got["inliers"][p].numpy(), np.asarray(r.inliers))
        assert int(got["num_inliers"][p]) == int(r.num_inliers)
        assert int(got["num_putative"][p]) == int(r.num_putative)
        _assert_h_close(got["H"][p].numpy(), r.H)
    assert not bool(got["success"][-1])


def test_verify_pairs_acceptance_parity():
    src, dst, mask = _pairs(1, P=8)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(5), len(src)))
    kw = dict(threshold=5.5, batch=64, accept_alpha=8.0, accept_beta=0.3, accept_small_min=8,
              accept_small_ratio=0.9, total=128)
    ref = jrs.verify_pairs(src, dst, mask, keys, **kw)
    got = trs.verify_pairs(src, dst, mask, minimal_sets=_reference_sets(keys, mask, 64, 128),
                           device="cpu", **kw)
    for k in ("accepted", "num_inliers", "num_putative", "inliers"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    _assert_h_close(got["H"], ref["H"])
    _assert_h_close(got["H_inv"], ref["H_inv"])


def test_generator_draws_are_seeded_and_accept_clean_pairs():
    src, dst, mask = _pairs(2, outlier=0.1)
    out = []
    for _ in range(2):
        g = torch.Generator().manual_seed(0)
        out.append(trs.verify_pairs(src, dst, mask, batch=128, total=128, generator=g,
                                    accept_small_min=8, device="cpu"))
    np.testing.assert_array_equal(out[0]["inliers"], out[1]["inliers"])
    assert out[0]["accepted"][:-1].all() and not out[0]["accepted"][-1]


def test_unported_models_raise():
    """Every model of the reference is ported; an unknown one raises."""
    for model in ("projective", "affine", "similarity", "rigid", "translation"):
        assert trs.model_min_pts(model) == jrs.model_min_pts(model)
    with pytest.raises(KeyError):
        trs.num_trials(99.0, "perspective", 100)


_MODELS = ["projective", "affine", "similarity", "rigid", "translation"]


def _model_pairs(seed, model, P=6, M=96, outlier=0.35):
    """Pairs whose inliers follow a random transform of `model`'s family."""
    rng = np.random.default_rng(seed)
    src = np.zeros((P, M, 2), np.float32)
    dst = np.zeros((P, M, 2), np.float32)
    mask = np.zeros((P, M), bool)
    for p in range(P):
        a, s = rng.uniform(-0.2, 0.2), rng.uniform(0.9, 1.1)
        H = np.eye(3)
        if model != "translation":
            H[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        if model in ("similarity", "affine", "projective"):
            H[:2, :2] *= s
        if model in ("affine", "projective"):
            H[:2, :2] += 0.05 * rng.standard_normal((2, 2))
        if model == "projective":
            H[2, :2] = 1e-4 * rng.standard_normal(2)
        H[:2, 2] = rng.uniform(-80, 80, 2)
        n = int(rng.integers(20, M + 1))
        s_ = rng.uniform(0, 320, (n, 2))
        ph = np.concatenate([s_, np.ones((n, 1))], 1) @ H.T
        d = ph[:, :2] / ph[:, 2:] + 0.5 * rng.standard_normal((n, 2))
        bad = rng.random(n) < outlier
        d[bad] = rng.uniform(0, 320, (int(bad.sum()), 2))
        src[p, :n], dst[p, :n], mask[p, :n] = s_, d, True
    mask[-1] = False  # a starved pair (no valid match)
    return src, dst, mask


@pytest.mark.parametrize("method", ["ransac", "mlesac"])
@pytest.mark.parametrize("model", _MODELS)
def test_models_and_methods_with_injected_minimal_sets(model, method):
    """5 models x {ransac, mlesac} on the reference's own minimal sets: H
    within 1e-4 of its largest entry, identical inliers and success."""
    src, dst, mask = _model_pairs(_MODELS.index(model), model)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), len(src)))
    kw = dict(threshold=3.0, model=model, method=method, batch=64, total=128)
    ref = [jrs.ransac_fit(jnp.asarray(s), jnp.asarray(d), jnp.asarray(m), jnp.asarray(k), **kw)
           for s, d, m, k in zip(src, dst, mask, keys)]
    sets = _reference_sets(keys, mask, 64, 128, trs.model_min_pts(model))
    got = trs.ransac_fit(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(mask),
                         minimal_sets=sets, **kw)
    for p, r in enumerate(ref):
        assert bool(got["success"][p]) == bool(r.success)
        np.testing.assert_array_equal(got["inliers"][p].numpy(), np.asarray(r.inliers))
        assert int(got["num_inliers"][p]) == int(r.num_inliers)
        _assert_h_close(got["H"][p].numpy(), r.H)
        np.testing.assert_array_equal(got["raw_inliers"][p].numpy(), np.asarray(r.raw_inliers))
    assert bool(got["success"][:-1].all()) and not bool(got["success"][-1])


def test_num_trials_every_model_and_observed():
    for model in _MODELS:
        for conf, max_iter in ((99.9, 500), (99.0, 64), (100.0, 300)):
            assert trs.num_trials(conf, model, max_iter) == jrs.num_trials(conf, model, max_iter)
        w = np.array([0.0, 0.05, 0.3, 0.45, 0.6, 0.9, 1.0])
        for conf in (99.9, 95.0, 100.0):
            np.testing.assert_array_equal(trs.num_trials_observed(conf, model, w, 256),
                                          jrs.num_trials_observed(conf, model, w, 256))


def _adaptive_problem(seed, n_easy, n_hard, M=128):
    """Easy pairs (inlier ratio 0.8), hard ones (0.3-0.45) and a pure-noise
    pair, as tests/test_ransac.py's adaptive cases."""
    rng = np.random.default_rng(seed)
    P = n_easy + n_hard + 1
    src = np.zeros((P, M, 2), np.float32)
    dst = np.zeros((P, M, 2), np.float32)
    mask = np.zeros((P, M), bool)
    for p in range(P):
        H = np.eye(3) + 0.03 * rng.standard_normal((3, 3))
        H[2, :2] *= 0.01
        H[:2, 2] = rng.uniform(-60, 60, 2)
        n = 100
        s = rng.uniform(0, 400, (n, 2))
        ph = np.concatenate([s, np.ones((n, 1))], 1) @ H.T
        d = ph[:, :2] / ph[:, 2:] + 0.3 * rng.standard_normal((n, 2))
        frac = 0.8 if p < n_easy else (0.3 + 0.15 * rng.random() if p < P - 1 else 0.0)
        bad = rng.random(n) >= frac
        d[bad] = rng.uniform(0, 400, (int(bad.sum()), 2))
        src[p, :n], dst[p, :n], mask[p, :n] = s, d, True
    return src, dst, mask


@pytest.mark.parametrize("n_easy,n_hard", [(0, 4), (3, 2)])
def test_adaptive_budget_matches_the_reference(n_easy, n_hard):
    """The two-phase budget on the reference's own draws: phase A takes the
    sets of the first sub-batch, phase B the rest for the continued pairs
    only. The result equals the reference's adaptive run exactly, and, when
    every pair continues, its single-phase run of the full budget too;
    `last_stats` is the reference's."""
    src, dst, mask = _adaptive_problem(11 + n_easy, n_easy, n_hard)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(13), len(src)))
    kw = dict(threshold=3.0, batch=64, total=256, accept_small_min=None)
    ref = jrs.verify_pairs(src, dst, mask, keys, adaptive_first=64, confidence=99.9, **kw)
    ref_stats = dict(jrs.verify_pairs.last_stats)
    ref_single = jrs.verify_pairs(src, dst, mask, keys, **kw)
    sets = _reference_sets(keys, mask, 64, 256)
    got = trs.verify_pairs(src, dst, mask, adaptive_first=64, confidence=99.9,
                           minimal_sets=sets, device="cpu", **kw)
    assert trs.verify_pairs.last_stats == ref_stats
    for k in ("accepted", "num_inliers", "num_putative", "inliers"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    # H of the accepted pairs: the noise pair's refit on a chance consensus
    # is ill-conditioned, and its H is thrown away
    acc = np.asarray(ref["accepted"])
    _assert_h_close(got["H"][acc], np.asarray(ref["H"])[acc])
    if n_easy == 0:
        assert ref_stats["n_continued"] == len(src)
        for k in ("accepted", "num_inliers", "inliers"):
            np.testing.assert_array_equal(got[k], np.asarray(ref_single[k]), err_msg=k)
        _assert_h_close(got["H"], ref_single["H"])
    else:
        assert 0 < ref_stats["n_continued"] < len(src)


def test_adaptive_budget_draws_from_the_generator():
    """Without injected sets phase B draws afresh for the continued pairs
    only: seeded runs repeat, and the clean pairs stop after phase A."""
    src, dst, mask = _adaptive_problem(21, 3, 2)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(0)
        outs.append(trs.verify_pairs(src, dst, mask, threshold=3.0, batch=64, total=256,
                                     adaptive_first=64, generator=g, device="cpu"))
        stats = trs.verify_pairs.last_stats
        assert stats["first"] == 64 and 0 < stats["n_continued"] < len(src)
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert outs[0]["accepted"][:3].all() and not outs[0]["accepted"][-1]
