"""The port's two CUDA kernels (B1 in its pooled and pair-list modes, B2)
against their plain PyTorch versions.

This file imports no jax, so the card's machine (which has none) runs its
`cuda`-marked tests directly, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Here, on the CPU, those tests skip; the wrapper and plain-version checks run,
and a numpy emulation of B1's 3xTF32 split bounds its distance error.
B1's indices must be equal outside distance ties (1e-5) and its distances
within atol 1e-4 (3xTF32 tensor-core sums, ~1e-6 on unit descriptors, in
another order); on small-integer descriptors it is bit-equal to the plain
version. Its bf16 instance (`compute_dtype="bfloat16"`) is held to the
plain bf16 version with distances within 1e-5 relative (+1e-6: the same
exact products summed in another order, no refinement), its padded widths
(16, 72) and its K = 16 instance (9 <= k <= 16) like the others. B2 is
bit-exact.
"""

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.kernels import _build
from autopanostitch_tpu_torch.kernels import knn as tknn
from autopanostitch_tpu_torch.kernels import window_gather as twg
from autopanostitch_tpu_torch.utils import trace


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


def _assert_knn_agrees(idx_k, d_k, idx_p, d_p, tie=1e-5, rtol=0.0, atol=1e-4):
    """Kernel (F, k) against a plain result with one neighbour more."""
    k = d_k.shape[1]
    torch.testing.assert_close(d_k, d_p[:, :k], rtol=rtol, atol=atol)
    gaps = (d_p[:, 1:] - d_p[:, :-1]).abs()
    distinct = gaps[:, :k] > tie
    distinct[:, 1:] &= gaps[:, : k - 1] > tie
    assert int(((idx_k != idx_p[:, :k]) & distinct).sum()) == 0


def _tf32(x, mode="rna"):
    """Float32 to TF32 (10 mantissa bits): "rna" rounds to nearest with ties
    away from zero (cvt.rna.tf32.f32, and B1's hi), "rz" truncates (how the
    tensor core reads a float32 operand, and so B1's lo)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if mode == "rna":
        u = u + np.uint32(0x1000)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _dist_3xtf32(q, t):
    """Squared distances with B1's q.t products emulated: each query and
    target element split into hi = rna(x), lo = rz(x - hi), and hi.hi +
    hi.lo + lo.hi summed in float64 (the tensor core's float32 accumulation
    is not emulated)."""
    qh, th = _tf32(q), _tf32(t)
    ql, tl = _tf32(q - qh, "rz"), _tf32(t - th, "rz")
    f = np.float64
    dot = qh.astype(f) @ th.T.astype(f) + qh.astype(f) @ tl.T.astype(f) + ql.astype(f) @ th.T.astype(f)
    qn = (q.astype(f) ** 2).sum(1)
    tn = (t.astype(f) ** 2).sum(1)
    return qn[:, None] + tn[None, :] - 2.0 * dot


def _sift_like(rng, n):
    """Non-negative 128-d unit descriptors clipped at 0.2 and renormalised,
    as SIFT builds them."""
    d = np.abs(rng.standard_normal((n, 128))) ** 2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.minimum(d, 0.2)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11),
                  1.0 + 3 * 2.0**-11], np.float32)
    np.testing.assert_array_equal(_tf32(x), np.array(
        [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10), 1.0 + 2.0**-9], np.float32))
    np.testing.assert_array_equal(_tf32(x, "rz"), np.array(
        [1.0, 1.0 + 2.0**-10, 1.0, 1.0, -1.0, 1.0 + 2.0**-10], np.float32))
    for mode in ("rna", "rz"):
        assert (_tf32(x, mode).view(np.uint32) & 0x1FFF == 0).all()


def test_3xtf32_split_keeps_float32_accuracy():
    """The tolerance argument of B1's tensor-core design: on SIFT-like unit
    descriptors the split's distance error is <= 2e-6 (below the 1e-5 tie
    rule and the 1e-4 gate); on small-integer descriptors it is exactly 0."""
    rng = np.random.default_rng(0)
    q, t = _sift_like(rng, 300), _sift_like(rng, 500)
    exact = ((q.astype(np.float64)[:, None] - t.astype(np.float64)[None]) ** 2).sum(-1)
    err = np.abs(_dist_3xtf32(q, t) - exact).max()
    assert err <= 2e-6
    one_pass = _tf32(q).astype(np.float64) @ _tf32(t).T.astype(np.float64)
    assert np.abs(one_pass - q.astype(np.float64) @ t.T.astype(np.float64)).max() > 1e-4
    qi = rng.integers(0, 8, (50, 128)).astype(np.float32)
    ti = rng.integers(0, 8, (70, 128)).astype(np.float32)
    exact_i = ((qi.astype(np.float64)[:, None] - ti.astype(np.float64)[None]) ** 2).sum(-1)
    assert np.array_equal(_dist_3xtf32(qi, ti), exact_i)


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


def test_width_check_takes_multiples_of_32_up_to_256():
    """The kernel's instances are multiples of 32 up to 256; the wrappers
    pad any other width up to 256 with zero columns, so the check refuses
    only widths above 256 (and 0)."""
    for D in (16, 32, 72, 100, 128, 160, 256):
        tknn.check_width(D)
    for D in (0, 288, 512):
        with pytest.raises(ValueError, match="256"):
            tknn.check_width(D)
    for D, Dp in ((16, 32), (72, 96), (100, 128), (128, 128), (250, 256)):
        x = torch.randn(5, D)
        xp = tknn.pad_width(x)
        assert xp.shape == (5, Dp) and torch.equal(xp[:, :D], x)
        assert not xp[:, D:].any()
    x = torch.randn(2, 3, 72)
    assert tknn.pad_width(x).shape == (2, 3, 96)


def test_library_is_named_by_source_hash():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libapst_kernels_")
    assert p == _build.library_path()
    assert {s.name for s in _build.CSRC.glob("*.cu")} == {"knn.cu", "knn_wide.cu", "knn_bf16.cu",
                                                           "sift_window.cu", "window_gather.cu",
                                                           "ba_system.cu", "render.cu",
                                                           "render_pyramid.cu", "upsample.cu",
                                                           "kaze.cu"}
    assert {"knn.cuh", "knn_bf16.cuh", "tma.cuh", "ba_direction.cuh"} <= {
        s.name for s in _build._sources()}


def test_cached_library_reports_its_build_log(tmp_path, monkeypatch):
    """A library loaded from the cache brings back ptxas's report of its
    build (what chip_smoke's spill gate reads), and none where it has no log."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_log", "")
    lib = _build.library_path()
    lib.write_bytes(b"")
    assert _build.build() == lib and _build.build_log == ""
    report = "ptxas info    : Used 76 registers\n    0 bytes stack frame, 0 bytes spill stores\n"
    lib.with_suffix(".log").write_text(report)
    assert _build.build() == lib and _build.build_log == report


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
    before = trace.launch_counts()["knn"]
    idx_k, d_k = tknn.knn(desc, q, desc, q, k, *extra)
    torch.cuda.synchronize()
    assert trace.launch_counts()["knn"] == before + 1
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
    before = trace.launch_counts()["window_gather"]
    out = twg.gather_windows(src, lev, ys, xs, win, win)
    torch.cuda.synchronize()
    assert trace.launch_counts()["window_gather"] == before + 1
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
    before = trace.launch_counts()["knn_pairs"]
    idx_k, d_k = tknn.knn_pairs(desc, val, pairs, 2)
    torch.cuda.synchronize()
    assert trace.launch_counts()["knn_pairs"] == before + 1
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
def test_knn_pairs_kernel_exact_duplicates_on_card():
    """Pair-list mode: a slot whose descriptor recurs in the other image is
    matched to it at distance 0 both ways; the runner-up keeps its float32
    distance."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    d = np.abs(rng.standard_normal((3, 500, 128))).astype(np.float32) ** 2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    perm = rng.permutation(500)
    d[2] = d[0][perm]  # slot j of image 2 is slot perm[j] of image 0
    desc = torch.as_tensor(d, device=dev)
    valid = torch.ones((3, 500), dtype=torch.bool, device=dev)
    pairs = torch.as_tensor([[0, 2], [1, 2]], dtype=torch.int32, device=dev)
    idx, dist = tknn.knn_pairs(desc, valid, pairs, 2)
    assert np.array_equal(idx[0, 0, :, 0].cpu().numpy(), np.argsort(perm))
    assert np.array_equal(idx[0, 1, :, 0].cpu().numpy(), perm)
    assert float(dist[0, :, :, 0].abs().max()) == 0.0
    _, d_p = tknn.knn_pairs_plain(desc, valid, pairs, 2)
    torch.testing.assert_close(dist[..., 1], d_p[..., 1], rtol=0, atol=1e-5)


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
    before = trace.launch_counts()["knn_pairs"]
    idx_k, d_k = tknn.knn_pairs(desc, val, pairs, 2)
    torch.cuda.synchronize()
    assert trace.launch_counts()["knn_pairs"] == before + 1
    idx_p, d_p = tknn.knn_pairs_plain(desc, val, pairs, 2)
    assert torch.equal(d_k, d_p)
    assert torch.equal(idx_k, idx_p)


def _knn_case(seed, Fq, Ft, D, integer=False):
    """Queries (Fq, D) against distinct targets (Ft, D), 3 images each, ~10 %
    invalid targets; unit descriptors, or small integers (exact sums)."""
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(0, 8, (Fq, D)).astype(np.float32)
        t = rng.integers(0, 8, (Ft, D)).astype(np.float32)
    else:
        q = rng.standard_normal((Fq, D)).astype(np.float32)
        t = rng.standard_normal((Ft, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        t /= np.linalg.norm(t, axis=1, keepdims=True)
    qid = rng.integers(0, 3, Fq).astype(np.int32)
    tid = np.where(rng.random(Ft) < 0.1, -2, rng.integers(0, 3, Ft)).astype(np.int32)
    return q, qid, t, tid


def _run_knn_case(case, k, dev, exact=False, compute_dtype="float32"):
    q, qid, t, tid = (torch.as_tensor(a, device=dev) for a in case)
    before = trace.launch_counts()["knn"]
    idx_k, d_k = tknn.knn(q, qid, t, tid, k, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert trace.launch_counts()["knn"] == before + 1
    if exact:
        idx_p, d_p = tknn.knn_plain(q, qid, t, tid, k, compute_dtype=compute_dtype)
        assert torch.equal(d_k, d_p) and torch.equal(idx_k, idx_p)
    else:
        idx_p, d_p = tknn.knn_plain(q, qid, t, tid, min(k + 1, t.shape[0]),
                                    compute_dtype=compute_dtype)
        if d_p.shape[1] == k:  # Ft == k: no neighbour beyond the k-th
            d_p = torch.cat([d_p, torch.full_like(d_p[:, :1], float("inf"))], 1)
            idx_p = torch.cat([idx_p, idx_p[:, :1]], 1)
        tol = dict(rtol=1e-5, atol=1e-6) if compute_dtype == "bfloat16" else {}
        _assert_knn_agrees(idx_k, d_k, idx_p, d_p, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
def test_knn_kernel_every_k_on_card(k):
    _run_knn_case(_knn_case(10 + k, 1000, 1500, 128), k, _cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 96, 128, 160, 192, 224, 256])
def test_knn_kernel_descriptor_widths_on_card(D):
    dev = _cuda()
    _run_knn_case(_knn_case(20 + D, 777, 1234, D), 4, dev)
    _run_knn_case(_knn_case(20 + D, 777, 1234, D, integer=True), 4, dev, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("Fq,Ft", [(1, 3), (5, 8), (130, 65), (127, 4097), (1001, 63)])
def test_knn_kernel_ragged_sizes_on_card(Fq, Ft):
    """Query and target counts that are no multiple of a tile (128 x 64)."""
    dev = _cuda()
    k = min(4, Ft)
    _run_knn_case(_knn_case(Fq + Ft, Fq, Ft, 128), k, dev)
    _run_knn_case(_knn_case(Fq + Ft, Fq, Ft, 128, integer=True), k, dev, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(0, 700), (700, 1500), (300, 1500)])
def test_knn_kernel_queries_sliced_from_the_pool_on_card(lo, hi):
    """Queries that are a slice of the target pool (one address when the
    slice starts at row 0), as a rank's share of the pooled kNN: the
    targets keep their own norms."""
    dev = _cuda()
    rng = np.random.default_rng(lo + hi)
    d = rng.standard_normal((1500, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = torch.as_tensor(d, device=dev)
    ids = torch.as_tensor(np.repeat(np.arange(5, dtype=np.int32), 300), device=dev)
    self_idx = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    idx_k, d_k = tknn.knn(d[lo:hi], ids[lo:hi], d, ids, 4, self_idx=self_idx)
    idx_p, d_p = tknn.knn_plain(d[lo:hi], ids[lo:hi], d, ids, 5, self_idx=self_idx)
    torch.cuda.synchronize()
    _assert_knn_agrees(idx_k, d_k, idx_p, d_p)


@pytest.mark.cuda
@pytest.mark.parametrize("k,with_self", [(4, False), (2, True)])
def test_knn_kernel_bit_equal_on_integer_descriptors_on_card(k, with_self):
    """Pooled mode on one set with same-image, invalid and self masks: every
    distance exact, ties real, so idx and dist equal the plain version's."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    d = torch.as_tensor(rng.integers(0, 8, (3000, 128)).astype(np.float32), device=dev)
    ids = np.repeat(np.arange(5, dtype=np.int32), 600)
    if not with_self:
        ids = np.where(rng.random(3000) < 0.1, -2, ids).astype(np.int32)
    qid = torch.as_tensor(ids, device=dev)
    extra = (torch.arange(3000, dtype=torch.int32, device=dev),) if with_self else ()
    idx_k, d_k = tknn.knn(d, qid, d, qid, k, *extra)
    idx_p, d_p = tknn.knn_plain(d, qid, d, qid, k, *extra)
    assert torch.equal(d_k, d_p) and torch.equal(idx_k, idx_p)


@pytest.mark.cuda
def test_knn_pairs_kernel_bit_equal_on_integer_descriptors_on_card():
    """Pair-list mode at D = 128 with a ragged slot count (300)."""
    dev = _cuda()
    rng = np.random.default_rng(8)
    desc = torch.as_tensor(rng.integers(0, 8, (6, 300, 128)).astype(np.float32), device=dev)
    val = torch.as_tensor(rng.random((6, 300)) > 0.1, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(6, 1), -1).astype(np.int32), device=dev)
    for k in (1, 2):
        idx_k, d_k = tknn.knn_pairs(desc, val, pairs, k)
        idx_p, d_p = tknn.knn_pairs_plain(desc, val, pairs, k)
        assert torch.equal(d_k, d_p) and torch.equal(idx_k, idx_p)


@pytest.mark.cuda
def test_knn_kernel_at_the_smoke_shape_on_card():
    """F = 40,960 pooled (20 images of 2048), k = 4, as the ring's matcher."""
    dev = _cuda()
    d, ids, qid = _pooled(9, n_img=20, per=2048)
    desc = torch.as_tensor(d, device=dev)
    q = torch.as_tensor(qid, device=dev)
    idx_k, d_k = tknn.knn(desc, q, desc, q, 4)
    idx_p, d_p = tknn.knn_plain(desc, q, desc, q, 5)
    _assert_knn_agrees(idx_k, d_k, idx_p, d_p)


@pytest.mark.cuda
def test_knn_kernel_exact_duplicates_on_card():
    """An exact duplicate in another image is found first at distance 0:
    the winners' distances are recomputed from direct differences, so the
    tensor core's truncating accumulation (a few 1e-6 here) does not reach
    the ratio test."""
    dev = _cuda()
    rng = np.random.default_rng(11)
    d = np.abs(rng.standard_normal((4000, 128))).astype(np.float32) ** 2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[2000:3000] = d[:1000]
    desc = torch.as_tensor(d, device=dev)
    ids = torch.as_tensor(np.repeat(np.arange(4, dtype=np.int32), 1000), device=dev)
    idx, dist = tknn.knn(desc, ids, desc, ids, 2)
    assert torch.equal(idx[:1000, 0], torch.arange(2000, 3000, dtype=torch.int32, device=dev))
    assert float(dist[:1000, 0].abs().max()) == 0.0


def _bits(rng, shape, p=0.5):
    return (rng.random(shape) < p).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [256, 160])
def test_knn_kernel_binary_descriptors_on_card(D):
    """{0,1} descriptors (the corner detectors' 256 bits, and 160, a width
    that is neither 128 nor 256): every distance is an integer and ties are
    the common case, so indices AND distances equal the plain version's,
    same-image, invalid and self masks included."""
    dev = _cuda()
    rng = np.random.default_rng(30 + D)
    d = torch.as_tensor(_bits(rng, (3000, D)), device=dev)
    ids = np.repeat(np.arange(5, dtype=np.int32), 600)
    qid = torch.as_tensor(np.where(rng.random(3000) < 0.1, -2, ids).astype(np.int32), device=dev)
    for k in (4, 2, 8):
        idx_k, d_k = tknn.knn(d, qid, d, qid, k)
        idx_p, d_p = tknn.knn_plain(d, qid, d, qid, k)
        assert torch.equal(d_k, d_p) and torch.equal(idx_k, idx_p), k
    idq = torch.as_tensor(ids, device=dev)
    self_idx = torch.arange(3000, dtype=torch.int32, device=dev)
    idx_k, d_k = tknn.knn(d, idq, d, idq, 2, self_idx)
    idx_p, d_p = tknn.knn_plain(d, idq, d, idq, 2, self_idx)
    assert torch.equal(d_k, d_p) and torch.equal(idx_k, idx_p)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [256, 160])
def test_knn_pairs_kernel_binary_descriptors_on_card(D):
    """Pair-list mode on {0,1} descriptors with a ragged slot count (300):
    bit-equal to the plain version, k = 1 and 2."""
    dev = _cuda()
    rng = np.random.default_rng(40 + D)
    desc = torch.as_tensor(_bits(rng, (6, 300, D)), device=dev)
    val = torch.as_tensor(rng.random((6, 300)) > 0.1, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(6, 1), -1).astype(np.int32), device=dev)
    for k in (1, 2):
        idx_k, d_k = tknn.knn_pairs(desc, val, pairs, k)
        idx_p, d_p = tknn.knn_pairs_plain(desc, val, pairs, k)
        assert torch.equal(d_k, d_p) and torch.equal(idx_k, idx_p), k


@pytest.mark.cuda
@pytest.mark.parametrize("k,with_self", [(4, False), (2, True), (8, False), (12, False)])
def test_knn_kernel_bf16_matches_plain_on_card(k, with_self):
    """The bf16 instance (one bf16 product a k-step, float32 sums, no
    refinement) against the plain bf16 version: the same exact products in
    another order, so indices agree outside ties and distances within 1e-5
    relative."""
    dev = _cuda()
    d, ids, qid = _pooled(1, n_img=6, per=700)
    desc = torch.as_tensor(d, device=dev)
    if with_self:
        q = torch.as_tensor(ids, device=dev)
        extra = (torch.arange(len(d), dtype=torch.int32, device=dev),)
    else:
        q = torch.as_tensor(qid, device=dev)
        extra = ()
    before = trace.launch_counts()["knn"]
    idx_k, d_k = tknn.knn(desc, q, desc, q, k, *extra, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    assert trace.launch_counts()["knn"] == before + 1 and idx_k.shape == (len(d), k)
    idx_p, d_p = tknn.knn_plain(desc, q, desc, q, k + 1, *extra, compute_dtype="bfloat16")
    _assert_knn_agrees(idx_k, d_k, idx_p, d_p, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 72, 128, 256])
def test_knn_kernel_bf16_widths_on_card(D):
    _run_knn_case(_knn_case(60 + D, 777, 1234, D), 4, _cuda(), compute_dtype="bfloat16")
    _run_knn_case(_knn_case(60 + D, 777, 1234, D, integer=True), 4, _cuda(), exact=True,
                  compute_dtype="bfloat16")


@pytest.mark.cuda
def test_knn_pairs_kernel_bf16_matches_plain_on_card():
    """Pair-list mode, bf16 instance, against the plain bf16 version."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    d = rng.standard_normal((5, 300, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = rng.random((5, 300)) > 0.1
    desc = torch.as_tensor(d, device=dev)
    val = torch.as_tensor(valid, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(5, 1), -1).astype(np.int32), device=dev)
    before = trace.launch_counts()["knn_pairs"]
    idx_k, d_k = tknn.knn_pairs(desc, val, pairs, 2, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    assert trace.launch_counts()["knn_pairs"] == before + 1
    for p in range(10):
        for side in range(2):
            q = pairs[p, side].item()
            t = pairs[p, 1 - side].item()
            tid = torch.where(val[t], 0, -2).to(torch.int32)
            wide = tknn.knn_plain(desc[q], torch.full((300,), -1, dtype=torch.int32, device=dev),
                                  desc[t], tid, 3, compute_dtype="bfloat16")
            _assert_knn_agrees(idx_k[p, side], d_k[p, side], *wide, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 72])
def test_knn_kernel_padded_widths_on_card(D):
    """Widths that are no multiple of 32 (D = 16: a 2x2x4 SIFT grid; 72:
    3x3x8) go through zero-padded columns, both modes, both operand types."""
    dev = _cuda()
    _run_knn_case(_knn_case(80 + D, 777, 1234, D), 4, dev)
    _run_knn_case(_knn_case(80 + D, 777, 1234, D, integer=True), 4, dev, exact=True)
    rng = np.random.default_rng(90 + D)
    desc = torch.as_tensor(rng.integers(0, 8, (6, 300, D)).astype(np.float32), device=dev)
    val = torch.as_tensor(rng.random((6, 300)) > 0.1, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(6, 1), -1).astype(np.int32), device=dev)
    for cd in ("float32", "bfloat16"):
        idx_k, d_k = tknn.knn_pairs(desc, val, pairs, 2, compute_dtype=cd)
        idx_p, d_p = tknn.knn_pairs_plain(desc, val, pairs, 2, compute_dtype=cd)
        assert torch.equal(d_k, d_p) and torch.equal(idx_k, idx_p), cd


@pytest.mark.cuda
@pytest.mark.parametrize("k", [9, 12, 16])
def test_knn_kernel_k16_instance_on_card(k):
    """9 <= k <= 16 run the K = 16 instance (3xTF32 in 64-column chunks)."""
    dev = _cuda()
    _run_knn_case(_knn_case(100 + k, 1000, 1500, 128), k, dev)
    _run_knn_case(_knn_case(100 + k, 1000, 1500, 256), k, dev)
    _run_knn_case(_knn_case(100 + k, 700, 900, 128, integer=True), k, dev, exact=True)


@pytest.mark.cuda
def test_knn_kernel_refuses_k_above_16_on_card():
    dev = _cuda()
    q, qid, t, tid = (torch.as_tensor(a, device=dev) for a in _knn_case(5, 50, 60, 128))
    with pytest.raises(ValueError, match="16"):
        tknn.knn(q, qid, t, tid, 17)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [256, 160])
def test_knn_kernel_binary_bf16_equals_float32_on_card(D):
    """On {0,1} descriptors the bf16 instance gives, bit for bit, what the
    3xTF32 instance with its refinement gives (pooled and pair list)."""
    dev = _cuda()
    rng = np.random.default_rng(50 + D)
    d = torch.as_tensor(_bits(rng, (3000, D)), device=dev)
    ids = np.repeat(np.arange(5, dtype=np.int32), 600)
    qid = torch.as_tensor(np.where(rng.random(3000) < 0.1, -2, ids).astype(np.int32), device=dev)
    a = tknn.knn(d, qid, d, qid, 4)
    b = tknn.knn(d, qid, d, qid, 4, compute_dtype="bfloat16")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    desc = d[:1800].reshape(6, 300, D)
    val = torch.as_tensor(rng.random((6, 300)) > 0.1, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(6, 1), -1).astype(np.int32), device=dev)
    a = tknn.knn_pairs(desc, val, pairs, 2)
    b = tknn.knn_pairs(desc, val, pairs, 2, compute_dtype="bfloat16")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 8, 16])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 160, 192, 224, 256])
def test_knn_kernel_bf16_every_width_and_k_on_card(D, k):
    """The bf16 instance of every width and K, ragged counts (333 queries
    against 517 distinct targets): on small integers every product and sum
    is exact, so indices and distances equal the plain bf16 version's."""
    _run_knn_case(_knn_case(200 + D + k, 333, 517, D, integer=True), k, _cuda(), exact=True,
                  compute_dtype="bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("Fq,Ft", [(1, 3), (5, 8), (130, 65), (127, 4097), (1001, 63)])
def test_knn_kernel_bf16_ragged_sizes_on_card(Fq, Ft):
    dev = _cuda()
    k = min(4, Ft)
    _run_knn_case(_knn_case(300 + Fq + Ft, Fq, Ft, 128), k, dev, compute_dtype="bfloat16")
    _run_knn_case(_knn_case(300 + Fq + Ft, Fq, Ft, 128, integer=True), k, dev, exact=True,
                  compute_dtype="bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(0, 700), (700, 1500), (300, 1500)])
def test_knn_kernel_bf16_queries_sliced_from_the_pool_on_card(lo, hi):
    """Queries sliced from the pool (a rank's share in stitch_multichip, one
    address when the slice starts at row 0) get their own bf16 copy."""
    dev = _cuda()
    rng = np.random.default_rng(400 + lo + hi)
    d = torch.as_tensor(rng.integers(0, 8, (1500, 128)).astype(np.float32), device=dev)
    ids = torch.as_tensor(np.repeat(np.arange(5, dtype=np.int32), 300), device=dev)
    self_idx = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    got = tknn.knn(d[lo:hi], ids[lo:hi], d, ids, 4, self_idx=self_idx, compute_dtype="bfloat16")
    want = tknn.knn_plain(d[lo:hi], ids[lo:hi], d, ids, 4, self_idx=self_idx,
                          compute_dtype="bfloat16")
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("D,Kc", [(128, 150), (128, 300), (256, 150), (64, 1)])
def test_knn_pairs_kernel_bf16_ragged_slots_on_card(D, Kc):
    """The pair list with slot counts that are no multiple of a tile (128 at
    D <= 128, 64 above): a tile never reads the next image's slots."""
    dev = _cuda()
    rng = np.random.default_rng(500 + D + Kc)
    desc = torch.as_tensor(rng.integers(0, 8, (5, Kc, D)).astype(np.float32), device=dev)
    val = torch.as_tensor(rng.random((5, Kc)) > 0.1, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(5, 1), -1).astype(np.int32), device=dev)
    for k in (1, 2) if Kc > 1 else (1,):
        got = tknn.knn_pairs(desc, val, pairs, k, compute_dtype="bfloat16")
        want = tknn.knn_pairs_plain(desc, val, pairs, k, compute_dtype="bfloat16")
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), k


@pytest.mark.cuda
def test_knn_kernel_bf16_exact_duplicates_on_card():
    """Exact duplicates in other images, across tile boundaries: distance 0
    (integers, exact), ties broken by the lower index as the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    d = rng.integers(0, 8, (4000, 128)).astype(np.float32)
    d[2000:3000] = d[:1000]
    d[3100:3300] = d[:200]
    desc = torch.as_tensor(d, device=dev)
    ids = torch.as_tensor(np.repeat(np.arange(4, dtype=np.int32), 1000), device=dev)
    for k in (2, 4):
        got = tknn.knn(desc, ids, desc, ids, k, compute_dtype="bfloat16")
        want = tknn.knn_plain(desc, ids, desc, ids, k, compute_dtype="bfloat16")
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), k
        assert torch.equal(got[0][:1000, 0], torch.arange(2000, 3000, dtype=torch.int32,
                                                           device=dev))


@pytest.mark.cuda
def test_knn_kernel_bf16_repeat_launch_bit_identical_on_card():
    """Two launches on the same inputs, pooled and pair list: bit-identical
    (the schedule has no atomics and no order that varies from run to run)."""
    dev = _cuda()
    d, ids, qid = _pooled(13, n_img=8, per=1000)
    desc = torch.as_tensor(d, device=dev)
    q = torch.as_tensor(qid, device=dev)
    a = tknn.knn(desc, q, desc, q, 4, compute_dtype="bfloat16")
    b = tknn.knn(desc, q, desc, q, 4, compute_dtype="bfloat16")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    slots = desc.reshape(8, 1000, 128)
    val = torch.ones((8, 1000), dtype=torch.bool, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(8, 1), -1).astype(np.int32), device=dev)
    a = tknn.knn_pairs(slots, val, pairs, 2, compute_dtype="bfloat16")
    b = tknn.knn_pairs(slots, val, pairs, 2, compute_dtype="bfloat16")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [256, 160])
def test_knn_kernel_binary_bf16_equals_plain_on_card(D):
    """{0,1} descriptors on the bf16 instance, pooled (k = 2, 4, 8 and 12)
    and pair list: indices and distances identical to the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(60 + D)
    d = torch.as_tensor(_bits(rng, (3000, D)), device=dev)
    ids = np.repeat(np.arange(5, dtype=np.int32), 600)
    qid = torch.as_tensor(np.where(rng.random(3000) < 0.1, -2, ids).astype(np.int32), device=dev)
    for k in (2, 4, 8, 12):
        got = tknn.knn(d, qid, d, qid, k, compute_dtype="bfloat16")
        want = tknn.knn_plain(d, qid, d, qid, k, compute_dtype="bfloat16")
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), k
    desc = d[:1800].reshape(6, 300, D)
    val = torch.as_tensor(rng.random((6, 300)) > 0.1, device=dev)
    pairs = torch.as_tensor(np.stack(np.triu_indices(6, 1), -1).astype(np.int32), device=dev)
    got = tknn.knn_pairs(desc, val, pairs, 2, compute_dtype="bfloat16")
    want = tknn.knn_pairs_plain(desc, val, pairs, 2, compute_dtype="bfloat16")
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
