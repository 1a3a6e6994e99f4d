"""The port's approximate pooled matcher (`global_knn(method="approximate")`)
against the benchmark's plain float64 reference of its rule
(`pano_bench/reference.py`: `Matcher`, `match_excess`, `_SketchRule`; the
sketch matrix drawn again by `pano_bench/sketch.py`), on seeded random unit
descriptors: 6 images x 256 slots x D = 128, k = 4, query blocks of 128
(12 blocks), a tenth of the slots masked.

The descriptors are SIFT-like (nonnegative, heavy-tailed, clipped at 0.2
and normalised again). Each image holds 85 features of its own, and each
feature appears again in the next two images, every copy with its own
noise (log-uniform 0.05-0.5 of the feature's scale), so that a copy's
nearest and second nearest are often the two other copies and the ratio
test at 0.6 is close for many of them, as on crops of one texture.

Readings on these inputs, on a CPU: the float32 program 0 / 0 by the
sketch rule, its distances within 9.0e-7 of float64; the same matcher in
bf16 1.39e-3 / 2.71e-3 (`match_excess` / `match_missing`), its distances
5.5e-3 off; the exhaustive matcher's lists 0 / 0.157 by the sketch rule.
The controls are held to 1e-3, ten times the limit the benchmark's ring
cells set on these numbers (1e-4)."""

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.ops import matching as mt
from pano_bench import reference
from test_torch_pipeline import one_torch_thread  # noqa: F401

N, K, D, BLOCK = 6, 256, 128, 128
SKETCH = reference.Matcher("float32", "approximate", k=4)
LIMIT = 1e-4  # the ring cells' limit of match_excess and match_missing


def _sift_like(x: np.ndarray) -> np.ndarray:
    x = np.abs(x) ** 2
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x = np.minimum(x, 0.2)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def scene():
    """desc (N, K, D) float32 and mask (N, K), as the module doc says."""
    rng = np.random.default_rng(1)
    copies, per = 3, K // 3
    base = rng.normal(size=(N, per, D))
    desc = rng.normal(size=(N, K, D))  # the one slot left over of each image: a filler
    for i in range(N):
        for c in range(copies):
            s = np.exp(rng.uniform(np.log(0.05), np.log(0.5), size=(per, 1)))
            desc[(i + c) % N, c * per:(c + 1) * per] = base[i] + s * rng.normal(size=(per, D))
    desc = _sift_like(desc)
    for i in range(N):
        desc[i] = desc[i, rng.permutation(K)]
    mask = rng.random((N, K)) > 0.1
    return torch.as_tensor(desc, dtype=torch.float32), torch.as_tensor(mask)


def _matches(desc, mask, method="approximate", compute_dtype="float32"):
    """The program's pooled lists (pairs, pair_idx, pair_mask, counts) and its
    kNN (nn_idx, nn_dist)."""
    nn_idx, nn_dist, best, acc = mt.global_match_stack(
        desc, mask, k=SKETCH.k, method=method, ratio=0.6, compute_dtype=compute_dtype,
        block=BLOCK)
    lists = mt.global_matches_to_pairs(best.numpy(), acc.numpy(), np.repeat(np.arange(N), K),
                                       np.tile(np.arange(K), N), N, 512)
    return lists, nn_idx, nn_dist


def _read(desc, mask, lists):
    """The sketch rule's numbers; a rescue ratio of 0 holds every pair to the
    pooled rule (the rescue's rule lists nothing at 0)."""
    return reference.match_excess(desc, mask, *lists, 0.6, 0.0, matcher=SKETCH)


def test_approximate_matches_follow_the_sketch_rule(scene):
    desc, mask = scene
    lists, _, _ = _matches(desc, mask)
    assert lists[2].sum() > 200  # the lists hold matches to judge
    assert _read(desc, mask, lists) == {"match_excess": 0.0, "match_missing": 0.0,
                                        "pairwise_pairs": 0.0}


def test_approximate_distances_are_float32_exact(scene):
    """Each listed neighbour's distance against float64 |q - t|^2 of the same
    float32 descriptors, within 1e-5: the program's expansion form
    |q|^2 + |t|^2 - 2 q.t sums D = 128 float32 products of unit vectors,
    whose roundings (2^-24 relative each, of either sign) add up to a few
    1e-7 (read: 9.0e-7 at most); bf16 operands, 2^-9 relative, read 5.5e-3."""
    desc, mask = scene
    _, nn_idx, nn_dist = _matches(desc, mask)
    x = desc.reshape(N * K, D).double()
    real = nn_dist < float(mt._BIG)
    assert real.sum() > 0.85 * N * K * SKETCH.k
    exact = ((x[:, None, :] - x[nn_idx.long().clamp(min=0)]) ** 2).sum(-1)
    assert (nn_dist.double() - exact)[real].abs().max() < 1e-5
    # the rows the mask leaves out have no neighbour
    assert not real[~mask.reshape(-1)].any()


@pytest.mark.parametrize("method, compute_dtype", [
    ("approximate", "bfloat16"),  # the same matcher in bf16: 1.39e-3 / 2.71e-3
    ("exhaustive", "float32"),  # the exact neighbours, not the sketch's: 0 / 0.157
])
def test_the_sketch_rule_fails_other_matchers(scene, method, compute_dtype):
    desc, mask = scene
    lists, _, _ = _matches(desc, mask, method, compute_dtype)
    got = _read(desc, mask, lists)
    assert max(got["match_excess"], got["match_missing"]) >= 10 * LIMIT, got
