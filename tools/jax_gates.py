"""The JAX package's results on `chip_smoke.py`'s scenes, on a CPU:

- phase 8: the 12-view 800x600 ring (f = 600 px, `synthdata.smooth_texture`
  with cutoff 0.2) stitched with each option set of `chip_smoke.PHASE8`
  (ORB with MLESAC and the adaptive RANSAC budget, SURF, KAZE);
- phase 5b: phase 5's 20-view ring with each option set of
  `chip_smoke.RING_OPTIONS` (`ring_bf16`: `compute_dtype="bfloat16"`;
  `ring_approximate`: the approximate matcher);
- phase 9: `pano100`, the 100-view ring of `bench.build_pano` with its
  config (`chip_smoke.PANO100`).

Prints one JSON line per scene: panoramas (sorted member lists), the max
focal error in percent and the spherical PSNR in dB of the panorama holding
every view, as `chip_smoke.pano_psnr` measures it. These are the gates
`chip_smoke.JAX_PHASE8`, `JAX_RING_OPTIONS` and `JAX_PANO100` record.

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


SCENES = {name: (chip_smoke.PHASE8_RING, fields) for name, fields in chip_smoke.PHASE8.items()}
SCENES.update({f"ring_{name}": (chip_smoke.RING, fields)
               for name, fields in chip_smoke.RING_OPTIONS.items()})
SCENES["pano100"] = (chip_smoke.PANO100_RING, chip_smoke.PANO100)


def main(names) -> None:
    for name in names:
        ring, fields = SCENES[name]
        n, f = ring[0], ring[1]
        port_set, env, Rs = chip_smoke.ring_scene(*ring)
        iset = ImageSet(images=port_set.images, sizes=port_set.sizes, names=port_set.names)
        t0 = time.perf_counter()
        res = jpipe.stitch(iset, chip_smoke.config_with(jconfig, fields), seed=0)
        panos = sorted(sorted(np.asarray(p["members"]).tolist()) for p in res.panoramas)
        full = [p for p in res.panoramas if len(p["members"]) == n]
        psnr, ferr = chip_smoke.pano_psnr(full[0], env, Rs, f) if full else (None, None)
        print(json.dumps({"name": name, "panoramas": panos, "focal_err": ferr, "psnr": psnr,
                          "accepted": int(np.asarray(res.graph.accepted).sum()),
                          "pairs": len(res.graph.pairs),
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(SCENES))
