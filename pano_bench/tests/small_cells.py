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
KAZE = {"workload": "kaze800.ring38", "traffic": RING["traffic"],
        "detector": {"max_keypoints": 512}}
# ORB with MLESAC and the adaptive budget (chip_smoke phase 8's settings) on
# the ring at phase 8's texture cutoff: on the ring's own (0.08) ORB finds
# no corner
ORB = {"workload": "rot800.ring38", "traffic": {**RING["traffic"], "cutoff": 0.2},
       "detector": {"detector": "ORB", "max_keypoints": 512, "num_octaves": 3},
       "image_match": {"method": "mlesac", "adaptive_first_batch": 64}}
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


def small_traffic(cell: dict) -> dict:
    traffic = spec.traffic(spec.workload(BENCH, cell["workload"])["traffic"])
    traffic.update(cell["traffic"])
    return traffic


def small_config(cell: dict, **changes) -> dict:
    """The cell's configuration file with the small cell's sections, then
    `changes` ({section: {field: value}}), applied."""
    wl = spec.workload(BENCH, cell["workload"])
    config = copy.deepcopy(spec.config_file(BENCH, wl["config"]))
    for sec, fields in [*cell.items(), *changes.items()]:
        if sec in config["stitch_config"]:
            config["stitch_config"][sec].update(fields)
    return config


def run_small(cell: dict, seed: int = 2**33 + 5, compute_dtype: str = "float32",
              stated: dict = None, **changes) -> dict:
    """One run of the small cell on the CPU, the program's configuration
    changed by `compute_dtype` and `changes`, judged by `stated` (the
    cell's file unless given); returns the result line."""
    from pano_bench import harness

    wl = spec.workload(BENCH, cell["workload"])
    config = small_config(cell, tpu={"compute_dtype": compute_dtype}, **changes)
    names = spec.limits(wl["name"])["checks"]
    limits = {"checks": {k: v for k, v in LIMITS.items() if k in names}}
    return harness.run_cell(BENCH, wl, seed, 0.01, False, "cpu", 0.0,
                            traffic=small_traffic(cell), config=config, limits=limits,
                            stated=stated)
