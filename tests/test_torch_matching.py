"""Parity of the torch port's pooled matcher (kernel B1's plain version and
the ratio test) with the JAX package.

The plain k-NN must give the reference's `global_knn` neighbours exactly
(same indices, including the masked fill of short rows; distances to
1e-5) and `two_nn_pallas` (interpret mode) with self/same-image exclusion.
The CUDA kernel is held against the plain version on the card
(tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autopanostitch_tpu.ops import matching as jmt
from autopanostitch_tpu.ops.pallas.match_kernel import two_nn_pallas
from autopanostitch_tpu_torch.kernels import knn as tknn
from autopanostitch_tpu_torch.ops import matching as tmt
from test_torch_pipeline import one_torch_thread  # noqa: F401


def _pooled(seed, n_img=5, per=120, D=128, noise=0.25, invalid=0.1):
    """Unit descriptors where each image re-observes a shared base set with
    noise (so the ratio test accepts some), plus invalid rows."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((per, D)).astype(np.float32)
    desc = np.concatenate([base + noise * rng.standard_normal((per, D)).astype(np.float32)
                           for _ in range(n_img)])
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    mask = rng.random(len(desc)) > invalid
    desc[~mask] = 0.0
    ids = np.repeat(np.arange(n_img, dtype=np.int32), per)
    return desc, mask, ids


def test_plain_knn_matches_global_knn():
    desc, mask, ids = _pooled(0)
    nn_j, d_j = jmt.global_knn(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(ids), k=4, block=128)
    nn_t, d_t = tmt.global_knn(torch.as_tensor(desc), torch.as_tensor(mask), torch.as_tensor(ids), k=4)
    np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-5)
    assert nn_t.dtype == torch.int32


def test_plain_knn_short_rows_fill_like_top_k():
    """A query with fewer than k valid cross-image targets is filled with the
    lowest-index masked targets at 1e18, as jax.lax.top_k orders ties."""
    desc, mask, ids = _pooled(1, n_img=2, per=6, invalid=0.5)
    nn_j, d_j = jmt.global_knn(jnp.asarray(desc), jnp.asarray(mask), jnp.asarray(ids), k=4, block=16)
    nn_t, d_t = tmt.global_knn(torch.as_tensor(desc), torch.as_tensor(mask), torch.as_tensor(ids), k=4)
    np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_j))
    np.testing.assert_array_equal(d_t.numpy() >= 1e17, np.asarray(d_j) >= 1e17)


def test_plain_knn_matches_two_nn_pallas():
    """k = 2 mode against the Pallas kernel in interpret mode (the data of
    tests/test_matching.py::TestPallasMatcher)."""
    r = np.random.default_rng(11)
    q = r.normal(size=(200, 128)).astype(np.float32)
    t = r.normal(size=(500, 128)).astype(np.float32)
    qid = r.integers(0, 3, 200).astype(np.int32)
    tid = r.integers(0, 3, 500).astype(np.int32)
    idx, d1, d2 = map(np.asarray, two_nn_pallas(
        jnp.asarray(q), jnp.asarray(qid), jnp.asarray(t), jnp.asarray(tid), interpret=True))
    nn, dd = tknn.knn(torch.as_tensor(q), torch.as_tensor(qid), torch.as_tensor(t),
                      torch.as_tensor(tid), 2)
    np.testing.assert_array_equal(nn[:, 0].numpy(), idx)
    np.testing.assert_allclose(dd[:, 0].numpy(), d1, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dd[:, 1].numpy(), d2, rtol=1e-5, atol=1e-3)


def test_plain_knn_self_exclusion_matches_two_nn_pallas():
    r = np.random.default_rng(12)
    d = r.normal(size=(100, 128)).astype(np.float32)
    ids = np.arange(100, dtype=np.int32) % 50
    selfi = np.arange(100, dtype=np.int32)
    idx, d1, d2 = map(np.asarray, two_nn_pallas(
        jnp.asarray(d), jnp.asarray(ids), jnp.asarray(d), jnp.asarray(ids),
        jnp.asarray(selfi), interpret=True))
    nn, dd = tknn.knn(torch.as_tensor(d), torch.as_tensor(ids), torch.as_tensor(d),
                      torch.as_tensor(ids), 2, self_idx=torch.as_tensor(selfi))
    nn = nn.numpy()
    np.testing.assert_array_equal(nn[:, 0], idx)
    np.testing.assert_allclose(dd[:, 0].numpy(), d1, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dd[:, 1].numpy(), d2, rtol=1e-5, atol=1e-3)
    assert (nn[:, 0] != selfi).all() and (ids[nn[:, 0]] != ids).all()


@pytest.mark.parametrize("ratio", [0.6, 0.8])
def test_global_match_stack_and_pairs(ratio):
    desc, mask, ids = _pooled(2, n_img=4, per=100)
    N, K = 4, 100
    out_j = jmt.global_match_stack(jnp.asarray(desc.reshape(N, K, -1)), jnp.asarray(mask.reshape(N, K)),
                                   k=4, block=128, ratio=ratio)
    out_t = tmt.global_match_stack(torch.as_tensor(desc.reshape(N, K, -1)),
                                   torch.as_tensor(mask.reshape(N, K)), k=4, ratio=ratio)
    for a, b in zip(out_t, out_j):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out_t[3].any()
    image_id = np.repeat(np.arange(N, dtype=np.int32), K)
    local = np.tile(np.arange(K, dtype=np.int32), N)
    best, acc = out_t[2].numpy(), out_t[3].numpy()
    pj = jmt.global_matches_to_pairs(best, acc, image_id, local, N, 64)
    pt = tmt.global_matches_to_pairs(best, acc, image_id, local, N, 64)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tmt.knn_votes(out_t[0].numpy(), out_t[1].numpy(), image_id, N),
        jmt.knn_votes(out_t[0].numpy(), out_t[1].numpy(), image_id, N))

