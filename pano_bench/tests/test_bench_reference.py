"""The reference's arithmetic on hand-made cases."""

import numpy as np
import torch

from pano_bench import reference
from pano_bench.scenes import synth


def test_members_wrong():
    exp = [np.array([0, 2, 4]), np.array([1, 3])]
    assert reference.members_wrong(exp, [np.array([4, 2, 0]), np.array([3, 1])], 6) == 0
    assert reference.members_wrong(exp, [np.array([0, 2, 4, 5]), np.array([1, 3])], 6) == 4
    assert reference.members_wrong(exp, [np.array([0, 1, 2, 3, 4])], 6) == 5


def test_gauge_and_rotation_error():
    rng = np.random.default_rng(0)
    R_true = np.stack([synth.rot_y(a).T for a in rng.uniform(0, 6, 5)])
    G = synth.rot_x(0.3) @ synth.rot_y(1.1)
    R_est = np.stack([R @ G.T for R in R_true])  # R_true = R_est G
    assert np.allclose(reference.gauge(R_est, R_true), G)
    assert reference.rotation_err_deg(R_est, R_true, G) < 1e-5
    R_est[2] = synth.rot_x(np.radians(0.5)) @ R_est[2]
    err = reference.rotation_err_deg(R_est, R_true, reference.gauge(R_est, R_true))
    assert 0.3 < err < 0.6


def _pooled_matches(desc, mask, ratio):
    """Matches of the pooled rule, worked out in float64 on the host."""
    N, K, _ = desc.shape
    x = desc.reshape(N * K, -1).astype(np.float64)
    img = np.repeat(np.arange(N), K)
    d = ((x[:, None] - x[None]) ** 2).sum(-1)
    d[:, ~mask.reshape(-1)] = np.inf
    d[img[:, None] == img[None]] = np.inf
    out = {}
    for q in np.nonzero(mask.reshape(-1))[0]:
        o = np.argsort(d[q])
        if d[q, o[0]] < ratio * ratio * d[q, o[1]]:
            i, j = sorted([(img[q], q % K), (img[o[0]], o[0] % K)])
            out.setdefault((i[0], j[0]), set()).add((i[1], j[1]))
    return out


def test_match_excess_reads_zero_on_the_rule_and_flags_a_wrong_match():
    rng = np.random.default_rng(1)
    N, K, D = 3, 40, 16
    A, B, C = (rng.normal(size=(K // 2, D)) for _ in range(3))  # each seen by two images
    desc = np.stack([np.concatenate(s) for s in ((A, C), (A, B), (B, C))])
    desc = (desc + 0.05 * rng.normal(size=desc.shape)).astype(np.float32)
    mask = np.ones((N, K), bool)
    mask[1, 5] = False
    m = _pooled_matches(desc, mask, 0.6)
    pairs = np.array(sorted(m), np.int64)
    M = max(len(v) for v in m.values()) + 1
    idx = np.zeros((len(pairs), M, 2), np.int64)
    pm = np.zeros((len(pairs), M), bool)
    for p, key in enumerate(pairs):
        for s, (a, b) in enumerate(sorted(m[tuple(key)])):
            idx[p, s] = (a, b)
            pm[p, s] = True
    t = torch.as_tensor(desc)
    tm = torch.as_tensor(mask)
    counts = np.zeros((N, N), np.int64)
    counts[pairs[:, 0], pairs[:, 1]] = pm.sum(1)
    got = reference.match_excess(t, tm, pairs, idx, pm, counts, 0.6, 0.8)
    assert got == {"match_excess": 0.0, "match_missing": 0.0, "pairwise_pairs": 0.0}
    a, b = idx[0, 0]
    idx[0, 0] = (a, (b + 1) % K)  # a's match moved to another descriptor of the image
    got = reference.match_excess(t, tm, pairs, idx, pm, counts, 0.6, 0.8)
    assert got["match_excess"] > 1e-3 and got["match_missing"] > 1e-3
    idx[0, 0] = (a, b)
    d = [((desc[pairs[0, 0], i] - desc[pairs[0, 1], j]) ** 2).sum() for i, j in idx[0]]
    pm[0, int(np.argmin(np.where(pm[0], d, np.inf)))] = False  # the clearest match, left out
    got = reference.match_excess(t, tm, pairs, idx, pm, counts, 0.6, 0.8)
    assert got["match_excess"] == 0.0 and got["match_missing"] > 1e-3


def _homography_case(rng, n=3, m=60):
    """Views of a plane: view k's homography to view 0 (the anchor) and
    noisy matches between each pair of views."""
    H = np.tile(np.eye(3), (n, 1, 1))
    H[1:, :2, 2] = rng.uniform(100, 200, size=(n - 1, 2))
    H[1:, :2, :2] += rng.normal(scale=0.01, size=(n - 1, 2, 2))
    H[1:, 2, :2] = rng.normal(scale=1e-5, size=(n - 1, 2))
    pairs = np.array([(i, j) for i in range(n) for j in range(i + 1, n)])
    u_i = np.zeros((len(pairs), m, 2))
    u_j = np.zeros((len(pairs), m, 2))
    for p, (i, j) in enumerate(pairs):
        x = rng.uniform(0, 300, size=(m, 2))  # canvas points seen by both
        for k, u in ((i, u_i), (j, u_j)):
            inv = np.linalg.inv(H[k])
            w = np.c_[x, np.ones(m)] @ inv.T
            u[p] = w[:, :2] / w[:, 2:] + rng.normal(scale=0.3, size=(m, 2))
    return H, pairs, u_i, u_j, np.ones((len(pairs), m))


def test_homography_cost_excess_is_nought_at_the_optimum_and_flags_a_shift():
    rng = np.random.default_rng(3)
    H, pairs, u_i, u_j, w = _homography_case(rng)
    args = (pairs, u_i, u_j, w, 2.0, 1e-4)
    p0 = torch.as_tensor((H / H[:, 2:3, 2:3]).reshape(-1, 9)[:, :8])
    t = (torch.as_tensor(pairs), torch.as_tensor(u_i), torch.as_tensor(u_j),
         torch.as_tensor(w), 2.0, 1e-4)
    best = reference.homography_optimum(p0, 0, t)
    Hb = torch.cat([best, torch.ones(len(H), 1, dtype=best.dtype)], 1).reshape(-1, 3, 3).numpy()
    Hb[0] = np.eye(3)
    assert abs(reference.homography_cost_excess(Hb, 0, H, *args)) < 1e-9
    assert reference.homography_cost_excess(H, 0, H, *args) > 0  # the truth is not the least
    shifted = Hb.copy()
    shifted[2, :2, 2] += 0.2  # a view off by a fifth of a pixel
    assert reference.homography_cost_excess(shifted, 0, H, *args) > 0.05


def test_pairwise_only_holds_every_pair_to_the_pair_rule():
    rng = np.random.default_rng(5)
    K, D = 30, 16
    A = rng.normal(size=(K, D))
    desc = np.stack([A, A[rng.permutation(K)]]) + 0.05 * rng.normal(size=(2, K, D))
    desc = desc.astype(np.float32)
    d = ((desc[0][:, None].astype(np.float64) - desc[1][None]) ** 2).sum(-1)
    o = np.sort(d, 1)
    nn_ab, nn_ba = d.argmin(1), d.argmin(0)
    rule = [(a, nn_ab[a]) for a in range(K)
            if o[a, 0] < 0.36 * o[a, 1] and nn_ba[nn_ab[a]] == a]
    rule.sort(key=lambda ab: d[ab])  # the pair lists are in distance order
    pairs = np.array([[0, 1]])
    idx = np.array([rule + [(0, 0)]], np.int64)
    pm = np.array([[True] * len(rule) + [False]])
    counts = np.array([[0, len(rule)], [len(rule), 0]])
    t, tm = torch.as_tensor(desc), torch.ones(2, K, dtype=torch.bool)
    got = reference.match_excess(t, tm, pairs, idx, pm, counts, 0.6, 0.6, pairwise_only=True)
    assert got["match_excess"] == 0.0 and got["match_missing"] == 0.0
    assert got["pairwise_pairs"] == 1.0
    a, b = idx[0, 0]
    idx[0, 0] = (a, (b + 1) % K)
    got = reference.match_excess(t, tm, pairs, idx, pm, counts, 0.6, 0.6, pairwise_only=True)
    assert got["match_excess"] > 1e-3 and got["match_missing"] > 1e-3


def test_second_passes_keep_what_the_program_derived(monkeypatch):
    from autopanostitch_tpu_torch.models import pipeline

    from pano_bench import harness

    monkeypatch.setattr(pipeline, "second_pass_component",
                        lambda *a, **k: ("set", "images", "feats", "graph"))
    sp = harness.SecondPasses().install()
    try:
        assert pipeline.second_pass_component(1, 2)[2] == "feats"
        assert sp.take() == [("feats", "graph")] and sp.take() == []
    finally:
        sp.uninstall()
    assert pipeline.second_pass_component(1, 2)[0] == "set"
    assert not sp.missing
