"""The port's two CUDA kernels (B1 in its pooled and pair-list modes, B2)
against their plain PyTorch versions.

This file imports no jax, so the card's machine (which has none) runs its
`cuda`-marked tests directly, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Here, on the CPU, those tests skip; the wrapper and plain-version checks run.
B1's indices must be equal outside distance ties (1e-5) and its distances
within atol 1e-4 (float32 FMA sums in another order); B2 is bit-exact.
"""

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.kernels import _build
from autopanostitch_tpu_torch.kernels import knn as tknn
from autopanostitch_tpu_torch.kernels import window_gather as twg


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_kernels.py on the card")
    return torch.device("cuda")


def _pooled(seed, n_img, per, invalid=0.1):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((per, 128)).astype(np.float32)
    d = np.concatenate([base + 0.3 * rng.standard_normal((per, 128)).astype(np.float32)
                        for _ in range(n_img)])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ids = np.repeat(np.arange(n_img, dtype=np.int32), per)
    qid = np.where(rng.random(len(d)) < invalid, -2, ids).astype(np.int32)
    return d, ids, qid


def _assert_knn_agrees(idx_k, d_k, idx_p, d_p, tie=1e-5):
    """Kernel (F, k) against a plain result with one neighbour more."""
    k = d_k.shape[1]
    torch.testing.assert_close(d_k, d_p[:, :k], rtol=0, atol=1e-4)
    gaps = (d_p[:, 1:] - d_p[:, :-1]).abs()
    distinct = gaps[:, :k] > tie
    distinct[:, 1:] &= gaps[:, : k - 1] > tie
    assert int(((idx_k != idx_p[:, :k]) & distinct).sum()) == 0


def test_plain_knn_is_exact_with_lower_index_ties():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 3, (30, 32)).astype(np.float32)  # many exact distance ties
    t = rng.integers(0, 3, (50, 32)).astype(np.float32)
    qid = rng.integers(0, 3, 30).astype(np.int32)
    tid = rng.integers(0, 3, 50).astype(np.int32)
    idx, dist = tknn.knn_plain(torch.as_tensor(q), torch.as_tensor(qid), torch.as_tensor(t),
                               torch.as_tensor(tid), 3, block=7)
    full = ((q[:, None] - t[None]) ** 2).sum(-1)
    full[qid[:, None] == tid[None]] = 1e18
    order = np.argsort(full, axis=1, kind="stable")[:, :3]
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_allclose(dist.numpy(), np.take_along_axis(full, order, 1), rtol=1e-6)


def test_plain_gather_windows_indexing():
    src = torch.arange(3 * 10 * 12 * 2, dtype=torch.float32).reshape(3, 10, 12, 2)
    lev = torch.tensor([0, 2, 1], dtype=torch.int32)
    ys = torch.tensor([0, 5, 3], dtype=torch.int32)
    xs = torch.tensor([0, 8, 1], dtype=torch.int32)
    out = twg.gather_windows(src, lev, ys, xs, 5, 4)
    for k in range(3):
        assert torch.equal(out[k], src[lev[k], ys[k]:ys[k] + 5, xs[k]:xs[k] + 4])


def test_wrappers_reject_bad_inputs():
    d = torch.zeros((8, 128))
    i = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tknn.knn(d.double(), i, d.double(), i, 2)
    with pytest.raises(TypeError):
        tknn.knn(d, i.long(), d, i.long(), 2)
    with pytest.raises(ValueError):
        tknn.knn(d, i, d, i, 9)
    desc, valid = torch.zeros((3, 8, 128)), torch.ones((3, 8), dtype=torch.bool)
    pairs = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(TypeError):
        tknn.knn_pairs(desc, valid, pairs.long())
    with pytest.raises(TypeError):
        tknn.knn_pairs(desc, valid.int(), pairs)
    with pytest.raises(ValueError):
        tknn.knn_pairs(desc, valid, pairs, 3)
    with pytest.raises(ValueError):
        tknn.knn_pairs(desc, valid[:2], pairs)
    with pytest.raises(ValueError, match="indices"):
        tknn.knn_pairs(desc, valid, pairs + 2)
    src = torch.zeros((2, 8, 8, 2))
    with pytest.raises(ValueError):
        twg.gather_windows(src, i[:2], i[:2], i[:2], 9, 4)
    with pytest.raises(ValueError):
        twg.gather_windows(src[..., :1], i[:2], i[:2], i[:2], 4, 4)
    with pytest.raises(ValueError):
        twg.gather_windows(src, i[:2].long(), i[:2], i[:2], 4, 4)


def test_library_is_named_by_source_hash():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libapst_kernels_")
    assert p == _build.library_path()
    assert {s.name for s in _build.CSRC.glob("*.cu")} == {"knn.cu", "window_gather.cu"}


@pytest.mark.cuda
@pytest.mark.parametrize("k,with_self", [(4, False), (2, True), (8, False)])
def test_knn_kernel_matches_plain_on_card(k, with_self):
    dev = _cuda()
    d, ids, qid = _pooled(1, n_img=6, per=700)
    desc = torch.as_tensor(d, device=dev)
    if with_self:
        q = torch.as_tensor(ids, device=dev)
        extra = (torch.arange(len(d), dtype=torch.int32, device=dev),)
    else:
        q = torch.as_tensor(qid, device=dev)
        extra = ()
    before = tknn.launches
    idx_k, d_k = tknn.knn(desc, q, desc, q, k, *extra)
    torch.cuda.synchronize()
    assert tknn.launches == before + 1
    idx_p, d_p = tknn.knn_plain(desc, q, desc, q, k + 1, *extra)
    _assert_knn_agrees(idx_k, d_k, idx_p, d_p)
    if with_self:
        assert (idx_k[:, 0] != torch.arange(len(d), device=dev)).all()


@pytest.mark.cuda
def test_knn_kernel_short_rows_on_card():
    """Fewer valid targets than k: the kernel fills with the lowest-index
    masked targets at 1e18, like the plain version."""
    dev = _cuda()
    d, ids, _ = _pooled(2, n_img=2, per=5)
    q = torch.as_tensor(np.where(np.arange(10) % 3 == 0, -2, ids).astype(np.int32), device=dev)
    desc = torch.as_tensor(d, device=dev)
    idx_k, d_k = tknn.knn(desc, q, desc, q, 4)
    idx_p, d_p = tknn.knn_plain(desc, q, desc, q, 4)
    assert torch.equal(idx_k, idx_p)
    assert torch.equal(d_k >= 1e17, d_p >= 1e17)


@pytest.mark.cuda
@pytest.mark.parametrize("win", [40, 80])
def test_gather_kernel_matches_plain_on_card(win):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    src = torch.randn((24, 150, 200, 2), generator=g, device=dev)
    K = 3000
    lev = torch.randint(0, 24, (K,), generator=g, device=dev, dtype=torch.int32)
    ys = torch.randint(0, 150 - win + 1, (K,), generator=g, device=dev, dtype=torch.int32)
    xs = torch.randint(0, 200 - win + 1, (K,), generator=g, device=dev, dtype=torch.int32)
    before = twg.launches
    out = twg.gather_windows(src, lev, ys, xs, win, win)
    torch.cuda.synchronize()
    assert twg.launches == before + 1
    assert torch.equal(out, twg.gather_windows_plain(src, lev, ys, xs, win, win))


@pytest.mark.cuda
def test_knn_pairs_kernel_matches_plain_on_card():
    """Pair-list mode, k = 2, both directions, in one launch; image 3 has
    only one valid slot (short rows) and image 0 a row of invalid slots."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    d = rng.standard_normal((5, 300, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = rng.random((5, 300)) > 0.1
    valid[3, 1:] = False
    valid[0, 100:140] = False
    desc = torch.as_tensor(d, device=dev)
    val = torch.as_tensor(valid, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(5, 1), -1).astype(np.int32), device=dev)
    before = tknn.pair_launches
    idx_k, d_k = tknn.knn_pairs(desc, val, pairs, 2)
    torch.cuda.synchronize()
    assert tknn.pair_launches == before + 1
    idx_p, d_p = tknn.knn_pairs_plain(desc, val, pairs, 2)
    assert idx_k.shape == (10, 2, 300, 2)
    # the plain version with one neighbour more: pooled-mode agreement check
    # per pair and direction, ties of 1e-5 allowed to swap
    for p in range(10):
        for side in range(2):
            q = pairs[p, side].item()
            t = pairs[p, 1 - side].item()
            tid = torch.where(val[t], 0, -2).to(torch.int32)
            wide = tknn.knn_plain(desc[q], torch.full((300,), -1, dtype=torch.int32, device=dev),
                                  desc[t], tid, 3)
            _assert_knn_agrees(idx_k[p, side], d_k[p, side], *wide)
            torch.testing.assert_close(d_p[p, side], wide[1][:, :2], rtol=0, atol=1e-4)
    short = pairs[:, 1] == 3
    assert torch.equal(d_k[short][:, 0, :, 1] >= 1e17, d_p[short][:, 0, :, 1] >= 1e17)


@pytest.mark.cuda
def test_knn_pairs_kernel_takes_a_list_beyond_the_grid_y_limit():
    """79800 pairs (every pair of 400 images) in one launch: more blocks of
    (pair, direction) than gridDim.y or .z could hold."""
    dev = _cuda()
    rng = np.random.default_rng(4)
    d = rng.integers(0, 8, (400, 32, 32)).astype(np.float32)  # exact distances
    desc = torch.as_tensor(d, device=dev)
    val = torch.as_tensor(rng.random((400, 32)) > 0.1, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(400, 1), -1).astype(np.int32), device=dev)
    before = tknn.pair_launches
    idx_k, d_k = tknn.knn_pairs(desc, val, pairs, 2)
    torch.cuda.synchronize()
    assert tknn.pair_launches == before + 1
    idx_p, d_p = tknn.knn_pairs_plain(desc, val, pairs, 2)
    assert torch.equal(d_k, d_p)
    assert torch.equal(idx_k, idx_p)
