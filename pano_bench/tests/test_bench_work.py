"""The kNN work count against a brute-force count."""

import numpy as np

from pano_bench import work


def test_pooled_counts_valid_cross_image_pairs():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 4, size=60).astype(np.int32)
    ids[ids == -1] = -2  # -2 marks an invalid row
    brute = sum(1 for a in ids for b in ids if a >= 0 and b >= 0 and a != b)
    assert work.pooled_flops(ids, ids, 128) == 2.0 * 128 * brute


def test_pair_list_counts_valid_slot_pairs_once():
    valid = np.array([[1, 1, 0], [1, 0, 0], [1, 1, 1]], bool)
    pairs = np.array([[0, 1], [0, 2], [1, 2]])
    assert work.pair_flops(valid, pairs, 32) == 2.0 * 32 * (2 * 1 + 2 * 3 + 1 * 3)


def test_peaks():
    assert work.peak("NVIDIA H100 80GB HBM3", "tf32_flop_s") == 495e12
    assert work.peak("some other card", "tf32_flop_s") is None
