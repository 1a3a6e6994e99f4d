"""The match check holds a run to the rule of the matcher its configuration
states (`reference.stated_matcher`): float32 or bf16 operands, the
exhaustive or the approximate pooled method, float or binary descriptors.
A run that changes the program's configuration (the control) is still
judged by the cell's file; a test that states another matcher passes it
(`stated`). Small cells on the CPU (`small_cells.py`)."""

import numpy as np
import pytest
import torch

from pano_bench import faults, reference, scenes, sketch, spec
from pano_bench.tests.small_cells import (KAZE, ORB, PLANAR, RING, run_small, small_config,
                                          small_traffic)

MATCH = ("match_excess", "match_missing")
APPROX = {"matching": {"method": "approximate"}}
BF16 = {"tpu": {"compute_dtype": "bfloat16"}}
# the float32 exhaustive rule's numbers at the parent of the stated-matcher
# rules, on these small inputs at seed 2**33 + 5 (one stitch each)
PARENT = {
    "ring": {"match_excess": 0.0, "match_missing": 0.0, "pairwise_pairs": 0.0},
    "planar": {"match_excess": 3.2607964406551884e-07, "match_missing": 1.826141857463881e-07,
               "pairwise_pairs": 0.0},
    "kaze": {"match_excess": 0.0, "match_missing": 0.0, "pairwise_pairs": 0.0},
    "ring_knn_swap": {"match_excess": 0.335828034724049, "match_missing": 0.14384865824907708,
                      "pairwise_pairs": 1.0},
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)


def _stitch(cell, fault=None):
    """One first pass of the small cell's folder: (result, configuration)."""
    from autopanostitch_tpu_torch import api

    config = small_config(cell)
    folder = scenes.make(small_traffic(cell), 2**33 + 5, 0, torch.device("cpu"))
    undo = faults.plant(fault) if fault else None
    try:
        res = api.stitch(folder.iset, spec.stitch_config(config), seed=folder.stitch_seed,
                         device="cpu")
    finally:
        if undo is not None:
            undo()
    return res, config


def _numbers(res, config, matcher):
    g = res.graph
    m = config["stitch_config"]["matching"]
    return reference.match_excess(
        res.features.desc, res.features.mask, g.pairs, g.pair_idx, g.pair_mask, g.counts,
        float(m["ratio_threshold"]), float(m["pairwise_rescue_ratio"]), matcher=matcher)


def _fails(line):
    return not line["correct"] and max(line["checks"][k]["value"] for k in MATCH) > 1e-4


@pytest.mark.parametrize("D", [64, 128, 256])
def test_sketch_matrix_is_the_programs(D):
    from autopanostitch_tpu_torch.ops import matching

    G = sketch.matrix(D)
    assert G.dtype == np.float32
    np.testing.assert_array_equal(G.view(np.uint32),
                                  matching.sketch_matrix(D, "cpu").numpy().view(np.uint32))


@pytest.mark.parametrize("name, cell, fault", [("ring", RING, None), ("planar", PLANAR, None),
                                               ("kaze", KAZE, None),
                                               ("ring_knn_swap", RING, "knn_swap")])
def test_float32_rule_reads_the_parents_numbers(name, cell, fault):
    res, config = _stitch(cell, fault)
    matcher = reference.stated_matcher(config)
    assert matcher == reference.Matcher()
    assert _numbers(res, config, matcher) == PARENT[name]


@pytest.mark.parametrize("program, stated, correct", [
    ("bfloat16", BF16, True),  # the program in bf16, judged by the bf16 rule
    ("float32", BF16, False),  # float32 distances are not the bf16 rule's
    ("bfloat16", None, False),  # the control: the cell's file states float32
])
def test_bf16_rule(program, stated, correct):
    line = run_small(RING, compute_dtype=program,
                     stated=small_config(RING, **stated) if stated else None)
    assert line["correct"] if correct else _fails(line), line["checks"]


@pytest.mark.parametrize("stated, fault, correct", [
    (APPROX, None, True),  # the sketch rule
    (None, None, False),  # the exact rule: the sketch misses second neighbours
    (APPROX, "knn_swap", False),  # an answer altered in the approximate matcher
])
def test_approximate_rule(stated, fault, correct):
    undo = faults.plant(fault) if fault else None
    try:
        line = run_small(RING, stated=small_config(RING, **stated) if stated else None, **APPROX)
    finally:
        if undo is not None:
            undo()
    assert line["correct"] if correct else _fails(line), line["checks"]


def _lists(matches: dict, N: int, M: int = 16):
    """Pooled lists (pairs, pair_idx, pair_mask, counts) of {(i, j): {(a, b)}}."""
    keys = sorted(k for k, v in matches.items() if v)
    pairs = np.array(keys, np.int64).reshape(-1, 2)
    idx = np.zeros((len(keys), M, 2), np.int64)
    mask = np.zeros((len(keys), M), bool)
    counts = np.zeros((N, N), np.int64)
    for p, key in enumerate(keys):
        for s, ab in enumerate(sorted(matches[key])):
            idx[p, s], mask[p, s] = ab, True
        counts[key] = counts[key[::-1]] = len(matches[key])
    return pairs, idx, mask, counts


def _tie_scene(t_lo_sketch: float):
    """Descriptors (4, 8, 64) whose query a (image 0, slot 0) has, by
    sketch distance, its true nearest t (image 1, slot 0; squared distance
    0.1), 14 fillers (far: 2.0) and then T_lo (image 2, slot 0; 0.12) and
    T_hi (image 3, slot 0; 2.0) at the 16th place (k = 2, 8k = 16 of 32
    slots), tied in the sketch unless `t_lo_sketch` moves T_lo. Whether
    T_lo is a candidate decides a's ratio test (0.1 < 0.36 d2). a's twin
    (slot 1, 1e-4 away in G's null space) keeps t's own ratio test from
    matching a."""
    rng = np.random.default_rng(3)
    D = 64
    G = sketch.matrix(D).astype(np.float64)
    U = np.linalg.svd(G)[0]
    col, null = U[:, :32], U[:, 32:]
    lift = np.linalg.inv(col.T @ G)  # sketch vector sigma -> column-space coordinates

    def target(sigma2, exact, direction=None):
        v = rng.normal(size=32) if direction is None else direction
        y = np.sqrt(sigma2) * v / np.linalg.norm(v) @ lift
        z = rng.normal(size=32)
        z *= np.sqrt(exact - y @ y) / np.linalg.norm(z)
        return col @ y + null @ z

    a = rng.normal(size=D)
    a /= np.linalg.norm(a)
    desc = np.zeros((4, 8, D))
    mask = np.zeros((4, 8), bool)
    desc[0, 0], desc[0, 1] = a, a + 1e-2 * null[:, 0]
    mask[0, :2] = True
    desc[1, 0] = a + target(0.002, 0.1)
    tie = rng.normal(size=32)
    desc[2, 0] = a + target(t_lo_sketch, 0.12, tie)
    desc[3, 0] = a + target(0.008, 2.0, tie)
    slots = [(1, s) for s in range(1, 6)] + [(2, s) for s in range(1, 6)] + [(3, s)
                                                                          for s in range(1, 5)]
    for i, s in slots:
        desc[i, s] = a + target(0.004, 2.0)
    mask[1:, 0] = True
    for i, s in slots:
        mask[i, s] = True
    return torch.as_tensor(desc, dtype=torch.float32), torch.as_tensor(mask)


def _program_lists(desc, mask):
    """The program's approximate pooled matcher's lists, as a dict."""
    from autopanostitch_tpu_torch.ops import matching as mt

    N, K, _ = desc.shape
    _, _, best, acc = mt.global_match_stack(desc, mask, k=2, method="approximate", ratio=0.6)
    pairs, idx, pm, _ = mt.global_matches_to_pairs(
        best.numpy(), acc.numpy(), np.repeat(np.arange(N), K), np.tile(np.arange(K), N), N, 16)
    return {tuple(map(int, pq)): {tuple(map(int, ab)) for ab, on in zip(ix, m) if on}
            for pq, ix, m in zip(pairs, idx, pm)}


def _read(desc, mask, matches, matcher):
    """The numbers of the lists; a rescue ratio of 0 holds every pair to the
    pooled rule (the scene's pairs hold too few matches to tell the rules
    apart)."""
    return reference.match_excess(desc, mask, *_lists(matches, desc.shape[0]), 0.6, 0.0,
                                  matcher=matcher)


def test_boundary_tie_at_the_sketch_rank_is_neither_excess_nor_missing():
    approx = reference.Matcher(method="approximate", k=2)
    desc, mask = _tie_scene(0.008)
    prog = _program_lists(desc, mask)
    with_a = {**prog, (0, 1): prog.get((0, 1), set()) | {(0, 0)}}
    without_a = {**prog, (0, 1): prog.get((0, 1), set()) - {(0, 0)}}
    zero = {"match_excess": 0.0, "match_missing": 0.0, "pairwise_pairs": 0.0}
    # T_lo in the candidates or out: either list is one an admissible choice makes
    for matches in (prog, with_a, without_a):
        assert _read(desc, mask, matches, approx) == zero
    # the exact rule sees T_lo, so a's match is an excess there
    assert _read(desc, mask, with_a, reference.Matcher())["match_excess"] > 0.05
    # T_lo surely a candidate (0.003: before the fillers): a's match is an
    # excess, and listing none reads nothing
    desc, mask = _tie_scene(0.003)
    prog = _program_lists(desc, mask)
    assert (0, 0) not in prog.get((0, 1), set())
    assert _read(desc, mask, prog, approx) == zero
    with_a = {**prog, (0, 1): prog.get((0, 1), set()) | {(0, 0)}}
    assert _read(desc, mask, with_a, approx)["match_excess"] > 0.05


@pytest.mark.parametrize("t_lo_sketch, out", [(0.008, False), (0.012, True)])
def test_a_match_to_a_target_certainly_out_of_the_candidates_reads_infinite(t_lo_sketch, out):
    """From a's side, a listed match (a, T_lo) is held to the sketch rule's
    candidates: tied with T_hi at the 16th place, T_lo is admissible and
    the excess is finite; past T_hi (0.012), no admissible choice holds it,
    and the excess is infinite, whatever the distances."""
    desc, mask = _tie_scene(t_lo_sketch)
    N, K, D = desc.shape
    x = desc.reshape(N * K, D).double()
    valid = mask.reshape(-1)
    q = torch.nonzero(valid).flatten()
    rule = reference._SketchRule(x, x, valid, torch.arange(N).repeat_interleave(K), q, 8,
                                 16, "float32", 0.36)
    a, t_lo = torch.tensor([0]), torch.tensor([2 * K])
    row = (q == 0).nonzero().flatten()
    v = float(rule.excess(row, a, t_lo, ((x[a] - x[t_lo]) ** 2).sum(-1))[0])
    assert (v == float("inf")) == out, v


@pytest.fixture(scope="module")
def orb_runs():
    return {fault: _stitch(ORB, fault) for fault in (None, "knn_swap")}


def test_binary_rule_holds_orb(orb_runs):
    res, config = orb_runs[None]
    matcher = reference.stated_matcher(config)
    assert matcher == reference.Matcher(binary=True, threshold=10.0)
    assert int(res.graph.pair_mask.sum()) > 100
    sound = _numbers(res, config, matcher)
    assert max(sound[k] for k in MATCH) <= 1e-4, sound
    # the same lists under the squared rule (d1 < r^2 d2)
    squared = _numbers(res, config, reference.Matcher())
    assert max(squared[k] for k in MATCH) > 1e-4, squared
    res, config = orb_runs["knn_swap"]
    swapped = _numbers(res, config, matcher)
    assert max(swapped[k] for k in MATCH) > 1e-4, swapped


def test_binary_threshold_holds_where_the_program_cuts():
    """The pairwise matcher cuts binary matches at 10 % of the bits; the
    rule does too, and a rule without the cut misses what it left out."""
    from autopanostitch_tpu_torch.ops import matching as mt

    rng = np.random.default_rng(5)
    K, D = 64, 256
    bits = rng.integers(0, 2, size=(K, D))
    flips = rng.random((K, D)) < rng.uniform(0.02, 0.2, size=(K, 1))
    desc = torch.as_tensor(np.stack([bits, bits ^ flips]), dtype=torch.float32)
    mask = torch.ones((2, K), dtype=torch.bool)
    pairs = np.array([[0, 1]])
    idx, m, n = (t.numpy() for t in mt.match_pair_list(desc, mask, pairs, ratio=0.6,
                                                        threshold=10.0, binary=True))
    assert 0 < int(n[0]) < K
    counts = np.zeros((2, 2), np.int64)
    counts[0, 1] = counts[1, 0] = int(n[0])

    def read(matcher):
        return reference.match_excess(desc, mask, pairs, idx, m, counts, 0.6, 0.6,
                                      pairwise_only=True, matcher=matcher)

    assert read(reference.Matcher(binary=True, threshold=10.0)) == {
        "match_excess": 0.0, "match_missing": 0.0, "pairwise_pairs": 1.0}
    assert read(reference.Matcher(binary=True))["match_missing"] >= 1.0
