"""The port's approximate pooled matcher and its sketch matrix against the
JAX package.

- `utils/threefry.normal` against `jax.random.normal(PRNGKey(12345), (D,
  32))`: the random bits bit-equal; the normals within 3 ulp (XLA's float32
  log1p inside erfinv rounds differently on some inputs; ~99 % are
  bit-equal).
- `global_knn(method="approximate")`: `nn_idx` identical to the
  reference's on the scene of tests/test_config_flags.py's approximate test
  and on config3's features, distances within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_scenes
from autopanostitch_tpu.models import features as jfeatures
from autopanostitch_tpu.ops import matching as jmt
from autopanostitch_tpu_torch.ops import matching as tmt
from autopanostitch_tpu_torch.utils import threefry
from test_torch_pipeline import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("D", [64, 72, 128, 256])
def test_threefry_normal_matches_jax(D):
    key = jax.random.PRNGKey(12345)
    bits = np.asarray(jax.random.bits(key, (D, 32), jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits(12345, (D, 32)), bits)
    ref = np.asarray(jax.random.normal(key, (D, 32), jnp.float32))
    got = threefry.normal(12345, (D, 32))
    assert got.dtype == np.float32
    ulp = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    assert ulp.max() <= 3
    assert (ulp == 0).mean() > 0.98


def test_sketch_matrix_is_the_references():
    D = 128
    G = np.asarray(jax.random.normal(jax.random.PRNGKey(12345), (D, 32), jnp.float32))
    G = G / np.asarray(jnp.sqrt(32.0))
    np.testing.assert_allclose(tmt.sketch_matrix(D, "cpu").numpy(), G, rtol=1e-6, atol=0)


def _approx_both(desc, mask, ids, k, block, compute_dtype="float32"):
    nn_j, d_j = jmt.global_knn(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(ids), k=k,
                               block=block, method="approximate", compute_dtype=compute_dtype)
    nn_t, d_t = tmt.global_knn(torch.as_tensor(desc), torch.as_tensor(mask), torch.as_tensor(ids),
                               k=k, method="approximate", block=block, compute_dtype=compute_dtype)
    return np.asarray(nn_j), np.asarray(d_j), nn_t.numpy(), d_t.numpy()


def test_approximate_matches_jax_on_the_easy_scene():
    """The data of tests/test_config_flags.py's approximate-matcher test."""
    rng = np.random.default_rng(1)
    base = rng.normal(0, 1, (64, 128)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    desc = np.concatenate([base, base + rng.normal(0, 0.02, base.shape).astype(np.float32)])
    mask = np.ones(128, bool)
    ids = np.repeat([0, 1], 64).astype(np.int32)
    nn_j, d_j, nn_t, d_t = _approx_both(desc, mask, ids, 2, 64)
    np.testing.assert_array_equal(nn_t, nn_j)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_approximate_matches_jax_on_config3_features(compute_dtype):
    """config3's pooled SIFT features (8 images x 512 slots), k = 4, as the
    pipeline calls it (query blocks of 1024)."""
    iset, cfg = parity_scenes.config3_spherical_ba()
    feats = jfeatures.extract_features(jnp.asarray(iset.images), iset.sizes, cfg.detector)
    N, K, D = feats.desc.shape
    desc = np.array(feats.desc).reshape(N * K, D)
    mask = np.array(feats.mask).reshape(-1)
    ids = np.repeat(np.arange(N, dtype=np.int32), K)
    nn_j, d_j, nn_t, d_t = _approx_both(desc, mask, ids, 4, 1024, compute_dtype)
    np.testing.assert_array_equal(nn_t, nn_j)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-5)
    exact = tmt.global_knn(torch.as_tensor(desc), torch.as_tensor(mask), torch.as_tensor(ids), k=4)
    agree = (exact[0][:, 0].numpy() == nn_t[:, 0])[mask]
    assert agree.mean() > 0.9  # the sketch keeps the true nearest neighbour


def test_approximate_narrow_descriptors_run_the_exhaustive_path():
    rng = np.random.default_rng(2)
    desc = rng.standard_normal((90, 32)).astype(np.float32)
    mask = rng.random(90) > 0.1
    ids = np.repeat(np.arange(3, dtype=np.int32), 30)
    a = tmt.global_knn(torch.as_tensor(desc), torch.as_tensor(mask), torch.as_tensor(ids), k=4,
                       method="approximate")
    b = tmt.global_knn(torch.as_tensor(desc), torch.as_tensor(mask), torch.as_tensor(ids), k=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    nn_j, d_j, nn_t, d_t = _approx_both(desc, mask, ids, 4, 32)
    np.testing.assert_array_equal(nn_t, nn_j)
