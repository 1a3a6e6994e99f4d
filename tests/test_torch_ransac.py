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


def _reference_sets(keys, mask, batch, total):
    """(P, nsub, sub, 4): the minimal sets `ransac_fit` draws from each
    pair's key (jax.random.split(key, nsub) per pair)."""
    nsub = max(1, (total + batch - 1) // batch)
    sub = min(batch, total)
    out = []
    for key, m in zip(keys, mask):
        ks = jax.random.split(jnp.asarray(key), nsub)
        out.append([np.asarray(jrs._sample_minimal_sets(ks[c], jnp.asarray(m), sub, 4))
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
    with pytest.raises(NotImplementedError, match="A11"):
        trs.num_trials(99.0, "affine", 100)
