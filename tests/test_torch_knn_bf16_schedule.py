"""B1's bf16 instance (`csrc/knn_bf16.cuh`) on the CPU: its prologue's plain
version against the JAX package's rounding, and a model of its schedule
against the port's plain bf16 k-NN.

- The prologue (`kernels.knn.prep_bf16_plain`) rounds each row to bf16 once,
  to nearest even, as `jnp.astype(jnp.bfloat16)` does in the reference's
  `pairwise_sqdist`, zero-pads it to whole 128-byte rows, and sums the float32
  norm: bit-equal, round-to-even ties included.
- `_schedule_knn` is a pure-PyTorch model of the kernel's order of work,
  defined here only: query blocks of 128 rows in clusters of two; two target
  halves (pooled) streamed as tiles of 128 (D <= 128) or 64 targets; in
  each tile, each of the 4 lanes of a quad keeps its own list over its
  columns (8 j + 2 lane + {0, 1}), filters the tile's pairs against the
  quad's bound and pushes the survivors in ascending column order; then the
  quads' and the halves' lists merge by (distance, index). Held bit-equal to
  `knn_plain(..., compute_dtype="bfloat16")` on descriptors whose products
  are exact in any order (small integers), with exact duplicates across tile
  boundaries, rows with fewer valid targets than k, and set sizes that are
  no multiple of a tile; and within 1e-6 (indices outside 1e-5 ties) on
  unit descriptors, where only the order of the float32 sums differs.

The kernel itself runs on the card only: tests/test_torch_kernels.py holds
it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.kernels import knn as tknn
from test_torch_pipeline import one_torch_thread  # noqa: F401

BIG = tknn.BIG
INF = float("inf")
BQ = 128  # query rows a block (knn.cuh BQ)


def _tile(D: int) -> int:
    """Targets a tile (knn_bf16.cuh bf_bn)."""
    return 128 if D <= 128 else 64


def _quad_bound(lists: torch.Tensor, K: int) -> torch.Tensor:
    """(R, 4, K) lane lists -> (R,) bound (knn_bf16.cuh quad_bound): the K-th
    smallest of the quad's entries for K = 2, 4; else the largest of the
    lanes' (K / 4)-th entries."""
    if K in (2, 4):
        return torch.sort(lists.reshape(lists.shape[0], -1), dim=1).values[:, K - 1]
    return lists[:, :, K // 4 - 1].max(dim=1).values


def _push(bd, bi, d, i, take):
    """knn.cuh's push / knn_bf16.cuh's push_sel on (R, K) lists, rows where
    `take` (i is larger than every index in the lists)."""
    d = torch.where(take, d, torch.full_like(d, INF))
    K = bd.shape[1]
    old_d, old_i = bd.clone(), bi.clone()
    for j in range(K - 1, 0, -1):
        shift = d < old_d[:, j - 1]
        here = ~shift & (d < old_d[:, j])
        bd[:, j] = torch.where(shift, old_d[:, j - 1], torch.where(here, d, old_d[:, j]))
        bi[:, j] = torch.where(shift, old_i[:, j - 1], torch.where(here, i, old_i[:, j]))
    first = d < old_d[:, 0]
    bd[:, 0] = torch.where(first, d, old_d[:, 0])
    bi[:, 0] = torch.where(first, i, old_i[:, 0])


def _merge(da, ia, db, ib, K):
    """K rounds of the lexicographic (distance, index) minimum of two sorted
    (R, K) lists (the half merge; also the quad merge, pairwise)."""
    R = da.shape[0]
    out_d, out_i = torch.empty_like(da), torch.empty_like(ia)
    pa = torch.zeros(R, dtype=torch.long)
    pb = torch.zeros(R, dtype=torch.long)
    pad_d = torch.full((R, 1), INF)
    pad_i = torch.full((R, 1), 2**31 - 1, dtype=ia.dtype)
    da, ia = torch.cat([da, pad_d], 1), torch.cat([ia, pad_i], 1)
    db, ib = torch.cat([db, pad_d], 1), torch.cat([ib, pad_i], 1)
    rows = torch.arange(R)
    for r in range(K):
        ad, ai, bdv, bi2 = da[rows, pa], ia[rows, pa], db[rows, pb], ib[rows, pb]
        take_a = (ad < bdv) | ((ad == bdv) & (ai < bi2))
        out_d[:, r] = torch.where(take_a, ad, bdv)
        out_i[:, r] = torch.where(take_a, ai, bi2)
        pa += take_a
        pb += ~take_a
    return out_d, out_i


def _scan(x, bad, t_lo, t_hi, K, BN):
    """One block's walk over target tiles [t_lo, t_hi) of BN columns: the
    lanes' lists after the last tile, merged over the quad. x (R, Ft) the
    distances before the clamp, bad (R, Ft) the masks."""
    R, Ft = x.shape
    bd = torch.full((R, 4, K), INF)
    bi = torch.full((R, 4, K), 2**31 - 1, dtype=torch.long)
    for t in range(t_lo, t_hi):
        t0 = t * BN
        bound = _quad_bound(bd, K)  # at the tile's start
        fill = bound > BIG
        lim = torch.where(bound > 0, bound, torch.full_like(bound, -INF))
        for j in range(BN // 8):
            for col in range(2):
                for lane in range(4):
                    c = t0 + 8 * j + 2 * lane + col
                    if c >= Ft:  # past the targets: dropped by c < nvalid
                        continue
                    xc = x[:, c]
                    flagged = (xc < lim) | fill
                    d = torch.where(bad[:, c], torch.full_like(xc, BIG), xc.clamp(min=0.0))
                    _push(bd[:, lane], bi[:, lane], d, torch.full((R,), c), flagged)
                    # (bd[:, lane] is a view: _push updates the lane's list)
    d01, i01 = _merge(bd[:, 0], bi[:, 0], bd[:, 1], bi[:, 1], K)
    d23, i23 = _merge(bd[:, 2], bi[:, 2], bd[:, 3], bi[:, 3], K)
    return _merge(d01, i01, d23, i23, K)


def _distances(q, t):
    """The kernel's x = fmaf(-2, q.t, |q|^2 + |t|^2) with bf16 operands and
    float32 norms; exact wherever the products are."""
    qn, q_rows = tknn.prep_bf16_plain(q)
    tn, t_rows = tknn.prep_bf16_plain(t)
    cross = q_rows.float() @ t_rows.float().T
    return (qn[:, None] + tn[None, :]) - 2.0 * cross, qn


def _schedule_knn(q, qid, t, tid, k, self_idx=None):
    """The pooled bf16 kernel's schedule: (idx (Fq, k) int32, dist (Fq, k))."""
    K = next(K for K in tknn.POOLED_K if K >= k)
    BN = _tile(q.shape[1])
    x, qn = _distances(q, t)
    Fq, Ft = x.shape
    x = torch.where((qid == -2)[:, None], torch.full_like(x, INF), x)  # infinite norm
    ar = torch.arange(Ft)
    bad = (tid[None, :] == qid[:, None]) | (tid[None, :] == -2) | (qid[:, None] == -2)
    if self_idx is not None:
        bad |= ar[None, :] == self_idx[:, None].long()
    n_all = -(-Ft // BN)
    per = -(-n_all // 2)
    out_d, out_i = [], []
    # clusters of 4 blocks: query blocks 2c and 2c + 1, target halves 0 and 1
    for qb0 in range(0, -(-Fq // BQ), 2):
        for qb in (qb0, qb0 + 1):
            rows = slice(qb * BQ, min(Fq, (qb + 1) * BQ))
            if rows.start >= Fq:
                continue  # the cluster's second block has no queries
            halves = [_scan(x[rows], bad[rows], min(h * per, n_all),
                            min(n_all, min(h * per, n_all) + per), K, BN) for h in (0, 1)]
            d, i = _merge(*halves[0], *halves[1], K)
            out_d.append(d)
            out_i.append(i)
    d, i = torch.cat(out_d), torch.cat(out_i)
    return i[:, :k].to(torch.int32), d[:, :k]


def _schedule_knn_pairs(desc, valid, pairs, k):
    """The pair-list bf16 kernel's schedule: one block streams every tile of
    the other image; only invalid targets are masked."""
    N, Kc, D = desc.shape
    BN = _tile(D)
    idx = torch.empty((pairs.shape[0], 2, Kc, k), dtype=torch.int32)
    dist = torch.empty((pairs.shape[0], 2, Kc, k))
    for p, (a, b) in enumerate(pairs.tolist()):
        for direction, (qi, ti) in enumerate(((a, b), (b, a))):
            x, _ = _distances(desc[qi], desc[ti])
            bad = (~valid[ti])[None, :].expand(Kc, Kc)
            d, i = _scan(x, bad, 0, -(-Kc // BN), 2, BN)
            idx[p, direction], dist[p, direction] = i[:, :k].to(torch.int32), d[:, :k]
    return idx, dist


def _integer_set(rng, F, D, n_img, invalid=0.1, hi=4):
    """Small-integer descriptors (every product and sum exact in float32 in
    any order, so ties are real) of n_img images, ~10 % invalid rows."""
    d = rng.integers(0, hi, (F, D)).astype(np.float32)
    ids = np.repeat(np.arange(n_img, dtype=np.int32), -(-F // n_img))[:F]
    qid = np.where(rng.random(F) < invalid, -2, ids).astype(np.int32)
    return torch.as_tensor(d), torch.as_tensor(qid)


@pytest.mark.parametrize("D", [16, 72, 256])
def test_prologue_plain_rounds_as_jax(D, one_torch_thread):
    """prep_bf16_plain: rows bit-equal to jnp.astype(bfloat16) (nearest
    even: a quarter of the entries sit exactly halfway between two bf16
    values), zero columns up to a whole 128-byte row, float32 norms."""
    rng = np.random.default_rng(D)
    x = rng.standard_normal((41, D)).astype(np.float32)
    u = x.view(np.uint32)
    tie = rng.random(x.shape) < 0.25
    u[tie] = (u[tie] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)  # ties to even
    norms, rows = tknn.prep_bf16_plain(torch.as_tensor(x))
    W = tknn.bf16_width(D)
    assert rows.dtype == torch.bfloat16 and rows.shape == (41, W) and W % 64 == 0 and W >= D
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    got = rows.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got[:, :D], ref)
    assert not got[:, D:].any()
    assert norms.dtype == torch.float32
    torch.testing.assert_close(norms, torch.sum(torch.as_tensor(x) ** 2, dim=-1), rtol=0, atol=0)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jnp.sum(jnp.asarray(x) ** 2, axis=-1)),
                               rtol=1e-6)
    assert tknn.bf16_scratch_floats(41, D) == 64 + 41 * W // 2


@pytest.mark.parametrize("k,D,Fq,Ft,self_exclusion", [
    (4, 32, 300, 300, True),     # one set, tiles of 128, self excluded
    (2, 128, 130, 517, False),   # queries != targets, ragged counts
    (8, 64, 257, 389, False),
    (12, 160, 140, 300, True),   # K = 16 instance, tiles of 64
])
def test_schedule_model_equals_plain(k, D, Fq, Ft, self_exclusion, one_torch_thread):
    rng = np.random.default_rng(k * 1000 + D)
    t, tid = _integer_set(rng, Ft, D, 3)
    # exact duplicates across tile boundaries: target c + BN repeats c
    BN = _tile(D)
    for c in range(0, Ft - BN, 37):
        t[c + BN] = t[c]
    if self_exclusion:
        q, qid = t[:Fq], tid[:Fq]
        self_idx = torch.arange(Fq, dtype=torch.int32)
    else:
        q, qid = _integer_set(rng, Fq, D, 3)
        q[: Fq // 2] = t[torch.as_tensor(rng.integers(0, Ft, Fq // 2))]  # duplicates
        self_idx = None
    want = tknn.knn_plain(q, qid, t, tid, k, self_idx, compute_dtype="bfloat16")
    got = _schedule_knn(q, qid, t, tid, k, self_idx)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert torch.equal(got[0], want[0])


def test_schedule_model_short_rows(one_torch_thread):
    """Rows with fewer valid targets than k: every target but a few is
    invalid or in the query's image, so the lists end in masked entries at
    BIG with the lowest indices, as the plain version's stable sort."""
    rng = np.random.default_rng(7)
    F, D, k = 200, 32, 8
    d, _ = _integer_set(rng, F, D, 1, invalid=0.0)
    ids = np.zeros(F, np.int32)
    ids[rng.choice(F, 5, replace=False)] = 1  # 5 targets of another image
    ids[rng.random(F) < 0.2] = -2
    qid = torch.as_tensor(ids)
    want = tknn.knn_plain(d, qid, d, qid, k, compute_dtype="bfloat16")
    got = _schedule_knn(d, qid, d, qid, k)
    assert bool((want[1] >= BIG).any())
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert torch.equal(got[0], want[0])


def test_schedule_model_pair_list_equals_plain(one_torch_thread):
    """The pair list: 4 images of 150 slots (no multiple of a tile), ~10 %
    invalid slots, duplicates across images, k = 2."""
    rng = np.random.default_rng(11)
    desc = torch.as_tensor(rng.integers(0, 4, (4, 150, 64)).astype(np.float32))
    desc[1, :40] = desc[0, 100:140]
    valid = torch.as_tensor(rng.random((4, 150)) > 0.1)
    pairs = torch.as_tensor(np.stack(np.triu_indices(4, 1), -1).astype(np.int32))
    want = tknn.knn_pairs_plain(desc, valid, pairs, 2, compute_dtype="bfloat16")
    got = _schedule_knn_pairs(desc, valid, pairs, 2)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert torch.equal(got[0], want[0])


def test_schedule_model_unit_descriptors(one_torch_thread):
    """Unit descriptors: the model's float32 sums of the exact bf16 products
    run in another order than the plain version's, so distances agree within
    1e-6 and indices outside 1e-5 ties."""
    rng = np.random.default_rng(3)
    F, k = 390, 4
    d = rng.standard_normal((F, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    desc = torch.as_tensor(d)
    qid = torch.as_tensor(np.repeat(np.arange(3, dtype=np.int32), 130))
    want_i, want_d = tknn.knn_plain(desc, qid, desc, qid, k + 1, compute_dtype="bfloat16")
    got_i, got_d = _schedule_knn(desc, qid, desc, qid, k)
    torch.testing.assert_close(got_d, want_d[:, :k], rtol=0, atol=1e-6)
    gaps = (want_d[:, 1:] - want_d[:, :-1]).abs()
    distinct = gaps[:, :k] > 1e-5
    distinct[:, 1:] &= gaps[:, : k - 1] > 1e-5
    assert int(((got_i != want_i[:, :k]) & distinct).sum()) == 0
