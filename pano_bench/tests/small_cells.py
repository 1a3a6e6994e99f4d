"""Cells small enough for the CPU (the port runs its plain kernel versions
there), with limits of their own: the control and fault tests drive whole
runs of them."""

import copy

from pano_bench import spec

BENCH = spec.load_benchmark()

RING = {"workload": "rot800.ring38",
        "traffic": {"views": 12, "width": 320, "height": 240, "focal_px": 240.0,
                    "env": [512, 1024], "pool": 1},
        "detector": {"max_keypoints": 512, "num_octaves": 3}}
PLANAR = {"workload": "planar800.scan3x3",
          "traffic": {"width": 320, "height": 240, "pool": 1},
          "detector": {"max_keypoints": 1024, "num_octaves": 3}}
# readings of sound CPU runs of these cells (seeds 1, 2): ring focal
# 0.15-0.17 %, rotations 0.015-0.037 deg, 48.7-49.3 dB; planar 55.8-56.9 dB,
# the homography BA within 3.9e-7 of its objective's least cost (3.2 with
# the BA's state left unchanged); matches off the rule by at most 3.3e-7 (in
# squared distance), where the control (bf16) leaves out matches by 1.4e-3
# and more
LIMITS = {"members_wrong": {"limit": 0, "better": "lower"},
          "focal_err_pct": {"limit": 0.5, "better": "lower"},
          "rot_err_deg": {"limit": 0.2, "better": "lower"},
          "h_cost_excess": {"limit": 0.01, "better": "lower"},
          "psnr_db": {"limit": 45.0, "better": "higher"},
          "match_excess": {"limit": 1e-4, "better": "lower"},
          "match_missing": {"limit": 1e-4, "better": "lower"}}


def run_small(cell: dict, seed: int = 2**33 + 5, compute_dtype: str = "float32") -> dict:
    """One run of the small cell on the CPU; returns the result line."""
    from pano_bench import harness

    wl = spec.workload(BENCH, cell["workload"])
    traffic = spec.traffic(wl["traffic"])
    traffic.update(cell["traffic"])
    config = copy.deepcopy(spec.config_file(BENCH, wl["config"]))
    config["stitch_config"]["detector"].update(cell["detector"])
    config["stitch_config"]["tpu"]["compute_dtype"] = compute_dtype
    names = spec.limits(wl["name"])["checks"]
    limits = {"checks": {k: v for k, v in LIMITS.items() if k in names}}
    return harness.run_cell(BENCH, wl, seed, 0.01, False, "cpu", 0.0, traffic=traffic,
                            config=config, limits=limits)
