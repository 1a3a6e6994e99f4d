#!/usr/bin/env python3
"""The benchmark of `autopanostitch_tpu_torch` on CUDA cards.

    python3 pano_bench/run.py --workload rot800.ring38 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device` and, with `--trace 1`, `breakdown`; last in it, `checks`, each
number the reference compared beside its limit, which also end standard
error. Exits with another code than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), when the program cannot be
imported, or when JAX or the JAX package was loaded. See README.md.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def process_start() -> float:
    """This process's start on the `time.perf_counter` clock (Linux: from
    /proc; elsewhere the moment this file began to run)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return T_START


def _finite(x):
    """JSON has no infinity or NaN: such a value is written as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = CHECKOUT / "_bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    sys.path.insert(0, str(CHECKOUT))
    try:
        import torch

        import autopanostitch_tpu_torch  # noqa: F401
        from pano_bench import harness, spec
    except ImportError as e:
        print(f"run.py: cannot import the program or the harness: {e}", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    workload = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        print(f"run.py: {args.workload} needs {workload['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = harness.run_cell(bench, workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", t0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for text in harness.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
