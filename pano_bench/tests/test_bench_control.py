"""The control: the program with its own lower-precision path switched on
(the matcher's bf16 distances, `compute_dtype="bfloat16"`) comes out as not
correct, where the same small cell in float32 is correct. On the card the
control was read at each cell's own size (`calibrate.py --control`,
PERF.md)."""

import torch

from pano_bench.tests.small_cells import PLANAR, run_small


def test_control_is_not_correct():
    torch.set_num_threads(4)
    sound = run_small(PLANAR)
    assert sound["correct"], sound["checks"]
    control = run_small(PLANAR, compute_dtype="bfloat16")
    assert not control["correct"]
    checks = control["checks"]
    assert max(checks["match_excess"]["value"], checks["match_missing"]["value"]) > 1e-4
