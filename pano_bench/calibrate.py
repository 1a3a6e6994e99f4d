#!/usr/bin/env python3
"""Readings that the limits of `limits/<workload>.json` are set from.

    python3 pano_bench/calibrate.py --workload rot800.ring38 --seeds 101-112 [--control]
        [--fault ba_unchanged ...]

In one process, for each seed: the cell's pool made as a run makes it, each
folder stitched once through `api.stitch` with the cell's configuration and
judged by the reference as a run judges it, the worst of the pool kept (as
a run keeps it). With `--control`, the same folders are stitched again with
the program's own lower-precision path switched on (`compute_dtype`
"bfloat16": the matcher's distances from bf16 operands) and judged alike,
by the configuration the cell states: the control, which has to come out
as not correct. With `--fault`, the same again with that fault of
`faults.py` planted underneath. Prints one JSON line a seed and side, and
a summary of each number's worst sound reading and, for the control and
each fault, its best. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def seed_list(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    args = ap.parse_args(argv)

    import torch

    from autopanostitch_tpu_torch import api
    from pano_bench import faults, harness, scenes, spec

    bench = spec.load_benchmark()
    wl = spec.workload(bench, args.workload)
    traffic = spec.traffic(wl["traffic"])
    config = spec.config_file(bench, wl["config"])
    limits = spec.limits(wl["name"])["checks"]
    sides = {"program": config}
    if args.control:
        ctl = copy.deepcopy(config)
        ctl["stitch_config"]["tpu"]["compute_dtype"] = "bfloat16"
        sides["control"] = ctl
    for name in args.fault:
        sides["fault:" + name] = config
    cfgs = {k: spec.stitch_config(c) for k, c in sides.items()}
    dev = torch.device("cuda")
    summary = {k: {} for k in sides}
    for seed in seed_list(args.seeds):
        pool = [scenes.make(traffic, seed, i, dev) for i in range(int(traffic["pool"]))]
        for side, cfg in cfgs.items():
            rows, times = [], []
            undo = faults.plant(side[6:]) if side.startswith("fault:") else None
            second = harness.SecondPasses().install()
            try:
                for folder in pool:
                    t = time.perf_counter()
                    res = api.stitch(folder.iset, cfg, seed=folder.stitch_seed,
                                     device="cuda")
                    times.append(time.perf_counter() - t)
                    rows.append(harness.judge(folder, res, config, second.take()))
                    del res
            finally:
                second.uninstall()
                if undo is not None:
                    undo()
            worst = harness.worst_of(rows, limits)
            print(json.dumps({"seed": seed, "side": side, "worst": worst, "per_folder": rows,
                              "stitch_s": times}), flush=True)
            for name, v in worst.items():
                summary[side].setdefault(name, []).append(v)
        del pool
        torch.cuda.empty_cache()
    out = {}
    for name, lim in limits.items():
        worst, best = (max, min) if lim["better"] == "lower" else (min, max)
        row = {"program_worst": worst(summary["program"][name])}
        for side in sides:
            if side != "program":
                row[side + "_best"] = best(summary[side][name])
        out[name] = row
    print(json.dumps({"workload": wl["name"], "summary": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
