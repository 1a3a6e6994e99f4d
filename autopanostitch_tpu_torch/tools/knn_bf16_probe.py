#!/usr/bin/env python3
"""What holds B1's bf16 instance (`csrc/knn_bf16.cuh`): its time with parts
of the tile loop taken out or changed, each variant built with one of the
loop's probe switches (`APST_PROBE_*`, at the head of knn_bf16.cuh) and
timed in turns in one process per variant.

    python3 autopanostitch_tpu_torch/tools/knn_bf16_probe.py [--reps R]

Needs one CUDA GPU and nvcc. Variants:
  as_built         the loop as built;
  first_pass       the epilogue's second pass (candidate pushes) skipped;
  no_epilogue      the epilogue skipped: products, ring and barriers only;
  cluster_release  the consumers' remote arrivals on the multicast pair's
                   empty barriers with a cluster-scope release.
The variants that skip work give wrong neighbours; only their times count.
Each times (CUDA events, median of R, default 7) phase 3d's shapes of
chip_smoke.py (pooled F = 40,960 x 128 unit descriptors, k = 4; the pair
list of 25 images x 2048 slots, all 300 pairs, k = 2) and phase 3c's at D
= 256 on {0,1} (pooled 12 x 2048, k = 4; the pair list of its 66 pairs).
Every variant builds only the bf16 widths timed (128, 256). Prints one JSON
record a variant, with the card's name and power limit. The builds land in a
temporary directory and are removed.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[2]

WIDTHS = ["-DAPST_PROBE_TIMED_WIDTHS"]
VARIANTS = {
    "as_built": WIDTHS,
    "first_pass": WIDTHS + ["-DAPST_PROBE_FIRST_PASS"],
    "no_epilogue": WIDTHS + ["-DAPST_PROBE_NO_EPILOGUE"],
    "cluster_release": WIDTHS + ["-DAPST_PROBE_CLUSTER_RELEASE"],
}

# run before each child's work: the variant's flags, and its build directory
SETUP = """
import json, pathlib, sys
from autopanostitch_tpu_torch.kernels import _build
_build.FLAGS = _build.FLAGS + json.loads(sys.argv[1])
_build.BUILD_DIR = pathlib.Path(sys.argv[2])
"""

TIMER = SETUP + r'''
import numpy as np
import torch
from autopanostitch_tpu_torch.kernels import knn as K

reps = int(sys.argv[3])
dev = torch.device("cuda")


def ms(fn):
    fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


rng = np.random.default_rng(0)
d = rng.standard_normal((40960, 128)).astype(np.float32)
d /= np.linalg.norm(d, axis=1, keepdims=True)
desc = torch.as_tensor(d, device=dev)
ids = torch.as_tensor(np.repeat(np.arange(20, dtype=np.int32), 2048), device=dev)
base = rng.standard_normal((2048, 128)).astype(np.float32)
p = np.stack([base[rng.permutation(2048)] + 0.6 * rng.standard_normal((2048, 128)).astype(np.float32)
              for _ in range(25)])
p /= np.linalg.norm(p, axis=-1, keepdims=True)
slots = torch.as_tensor(p, device=dev)
valid = torch.as_tensor(rng.random((25, 2048)) > 0.1, device=dev)
pairs = torch.as_tensor(np.stack(np.triu_indices(25, 1), -1).astype(np.int32), device=dev)
bits = torch.as_tensor((rng.random((12 * 2048, 256)) < 0.5).astype(np.float32), device=dev)
bid = torch.as_tensor(np.repeat(np.arange(12, dtype=np.int32), 2048), device=dev)
bslots = bits.reshape(12, 2048, 256)
bvalid = torch.ones((12, 2048), dtype=torch.bool, device=dev)
bpairs = torch.as_tensor(np.stack(np.triu_indices(12, 1), -1).astype(np.int32), device=dev)
bf = "bfloat16"
print(json.dumps({
    "pooled_d128_ms": ms(lambda: K.knn(desc, ids, desc, ids, 4, compute_dtype=bf)),
    "pairs_d128_ms": ms(lambda: K.knn_pairs(slots, valid, pairs, 2, compute_dtype=bf)),
    "pooled_d256_ms": ms(lambda: K.knn(bits, bid, bits, bid, 4, compute_dtype=bf)),
    "pairs_d256_ms": ms(lambda: K.knn_pairs(bslots, bvalid, bpairs, 2, compute_dtype=bf)),
}))
'''


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("knn_bf16_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    name = card()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    with tempfile.TemporaryDirectory() as tmp:
        # build every variant at once (each builds its own sources in parallel)
        builds = {v: subprocess.Popen([sys.executable, "-c", SETUP + "_build.build()",
                                       json.dumps(flags), tmp], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                  for v, flags in VARIANTS.items()}
        for v, proc in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"knn_bf16_probe: {v} did not build:\n{log[-4000:]}")
        for v, flags in VARIANTS.items():
            out = subprocess.run([sys.executable, "-c", TIMER, json.dumps(flags), tmp,
                                  str(args.reps)], cwd=REPO, env=env,
                                 capture_output=True, text=True, timeout=600)
            if out.returncode:
                raise SystemExit(f"knn_bf16_probe: {v} failed:\n{out.stderr[-4000:]}")
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"variant": v, "card": name, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
