"""The JAX package's results on `chip_smoke.py`'s phase-8 scenes, on a CPU:
the 12-view 800x600 ring (f = 600 px, `synthdata.smooth_texture` with
cutoff 0.2) stitched with each option set of
`chip_smoke.PHASE8` (ORB with MLESAC and the adaptive RANSAC budget, SURF,
KAZE). Prints one JSON line per option set: panoramas (sorted member
lists), the max focal error in percent and the spherical PSNR in dB of the
panorama holding every view, as `chip_smoke.pano_psnr` measures it. These
are the gates `chip_smoke.JAX_PHASE8` records.

    python3 tools/jax_gates.py [name ...]
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from autopanostitch_tpu import config as jconfig  # noqa: E402
from autopanostitch_tpu.models import pipeline as jpipe  # noqa: E402
from autopanostitch_tpu.utils.image_io import ImageSet  # noqa: E402


def main(names) -> None:
    n, f, w, h, env_hw, cutoff = chip_smoke.PHASE8_RING
    port_set, env, Rs = chip_smoke.ring_scene(n, f, w, h, env_hw, cutoff)
    iset = ImageSet(images=port_set.images, sizes=port_set.sizes, names=port_set.names)
    for name in names:
        t0 = time.perf_counter()
        res = jpipe.stitch(iset, chip_smoke.phase8_config(jconfig, name), seed=0)
        panos = sorted(sorted(np.asarray(p["members"]).tolist()) for p in res.panoramas)
        full = [p for p in res.panoramas if len(p["members"]) == n]
        psnr, ferr = chip_smoke.pano_psnr(full[0], env, Rs, f) if full else (None, None)
        print(json.dumps({"name": name, "panoramas": panos, "focal_err": ferr, "psnr": psnr,
                          "accepted": int(np.asarray(res.graph.accepted).sum()),
                          "pairs": len(res.graph.pairs),
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(chip_smoke.PHASE8))
