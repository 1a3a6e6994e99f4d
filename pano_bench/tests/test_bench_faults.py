"""A run with the timed path broken underneath comes out as not correct,
once for each fault a stitching cell can have (`pano_bench/faults.py`): an
answer altered where it is produced, half of the batch left out, and a step
that returns its state unchanged. The run skips only the look for a card.
The last is held on both cells: on the planar scan the homography bundle
adjustment's objective (`h_cost_excess`) catches it, where the corner
error alone reads within 3x of a sound run."""

import pytest
import torch

from pano_bench import faults
from pano_bench.tests.small_cells import PLANAR, RING, run_small


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)


def test_sound_run_is_correct():
    line = run_small(RING)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault, cell, check", [
    ("knn_swap", RING, "match_excess"),
    ("half_views", RING, "members_wrong"),
    ("ba_unchanged", RING, None),
    ("ba_unchanged", PLANAR, "h_cost_excess"),
])
def test_fault_is_not_correct(fault, cell, check):
    undo = faults.plant(fault)
    try:
        line = run_small(cell)
    finally:
        undo()
    assert not line["correct"]
    if check is not None:
        assert line["checks"][check]["value"] > line["checks"][check]["limit"]
