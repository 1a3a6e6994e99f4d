#!/usr/bin/env python3
"""What holds the multiband pyramid's kernels, on the card.

    python3 autopanostitch_tpu_torch/tools/pyramid_probe.py [--tree DIR]

Needs one CUDA GPU and nvcc. Times `kernels.render.mb_reduce` and
`mb_collapse` (with the uint8 finish, as the renderer calls it) at three
shapes of the main path, on contributors drawn from a seed (the kernels'
work does not depend on the values): the ring's canvas (66 tiles x 6 slots
of 96 x 384), the folder's (66 x 4) and the planar path's band (9 images x
512 x 1920 px, no leading dims). Each time is the device's for one call: a
CUDA graph of 20 calls (`utils.timing.graph_ms`), replay time over 20,
printed beside the call's bytes bound at 3.35 TB/s (level 0 read and the
levels written for the reduce; every level read and the uint8 tile and
coverage written for the collapse). Where the tree has them
(`kernels.render.reduce_launch`, `collapse_launch`), each kernel's variants
are timed too: `loads`, its copies and the pipeline's waits and barriers
with no arithmetic and no stores, and `compute`, its arithmetic and stores on
shared memory as it stands, with no loads but the tables.

--tree DIR imports the package from another checkout (for instance a parent
commit unpacked with `git archive`), which builds its own kernels there.
Prints one JSON record a line, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys


HBM_BYTES = 3.35e12
SHAPES = {"ring": (66, 6, 96, 384), "folder": (66, 4, 96, 384), "planar_band": (9, 512, 1920)}


def emit(**rec):
    print(json.dumps(rec), flush=True)


def inputs(shape, dev, seed: int = 0):
    """Colours in [0, 1] and weights with a third zero, made on the card
    from a seed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.rand(shape + (3,), generator=g, device=dev)
    w = torch.rand(shape, generator=g, device=dev)
    w = w * (torch.rand(shape, generator=g, device=dev) > 0.3)
    return cols, w


def probe(kr, timing, label: str, shape, dev) -> None:
    cols, w = inputs(shape, dev)
    H, W = shape[-2:]
    plan = kr.pyramid_plan(H, W, 3, 1.0, dev)
    levels = kr.mb_reduce(cols, w, plan)
    lead_c = math.prod(shape[:-2])  # contributors of all tiles
    level_bytes = sum(lead_c * 4 * h * w_ * 4 for h, w_ in plan.sizes[1:])
    level0 = lead_c * H * W * 16
    bounds = {"mb_reduce": (level0 + level_bytes) / HBM_BYTES * 1e3,
              "mb_collapse": (level0 + level_bytes + math.prod(shape[:-3]) * H * W * 4)
                             / HBM_BYTES * 1e3}
    calls = {"mb_reduce": {"whole": lambda: kr.mb_reduce(cols, w, plan)},
             "mb_collapse": {"whole": lambda: kr.mb_collapse(cols, w, levels, plan, True)}}
    if hasattr(kr, "reduce_launch"):
        for name, v in (("loads", 1), ("compute", 2)):
            calls["mb_reduce"][name] = lambda v=v: kr.reduce_launch(cols, w, plan, v)
            calls["mb_collapse"][name] = lambda v=v: kr.collapse_launch(cols, w, levels, plan,
                                                                        True, v)
    for kernel, variants in calls.items():
        ms = {name: timing.graph_ms(fn, 20) for name, fn in variants.items()}
        emit(shape=label, dims=list(shape), kernel=kernel, ms=ms, bound_ms=bounds[kernel],
             share_of_bound={k: bounds[kernel] / v for k, v in ms.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=None, help="import the package from this checkout")
    args = ap.parse_args()
    root = pathlib.Path(args.tree).resolve() if args.tree else pathlib.Path(__file__).parents[2]
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("pyramid_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    from autopanostitch_tpu_torch.kernels import render as kr
    from autopanostitch_tpu_torch.utils import timing

    emit(card=smi, tree=str(root), kernels=str(pathlib.Path(kr.__file__).parents[1]))
    dev = torch.device("cuda", 0)
    for label, shape in SHAPES.items():
        probe(kr, timing, label, shape, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
