#!/usr/bin/env python3
"""Where the rotational render stage's time goes, on the card.

    python3 autopanostitch_tpu_torch/tools/render_probe.py

Needs one CUDA GPU and nvcc. Stitches chip_smoke.py's 20-view 800x600 ring
(phase 5, the default StitchConfig) and its multi-panorama folder (phase 6:
two 12-view rings and a distractor, spherical and cylindrical) once, records
every `models.render.render_rotational` call of those stitches, and then,
for each recorded call (the ring's one; the folder's four, two rings x two
projections):
  wall_s       the host's wall time of a warm call ending in a synchronize,
               median of 3 after one warm-up;
  profile      one more warm call under `torch.profiler` (CPU + CUDA):
               its wall time, the device's busy time (the union of the
               device's kernel, copy and fill intervals), the kernels and
               copies the device ran, the host's CUDA runtime calls by name
               (launches, synchronisations, copies), and, for each of the
               port's render functions that exists in the tree it runs on
               (`tile_contributors`, `_render_tiles`, `render_tile_list`,
               `assemble_tiles`, `multiband_blend`, `resize_axis`, and the
               wrappers of `kernels/render.py`), its calls and its host time
               (inclusive, and self: without the PyTorch operators it
               called), read from a `record_function` range around it;
  top_kernels  the ten kernels with the most device time.
Prints one JSON record a line, the card's name and power limit first. The
functions are looked up by name, so the probe runs unchanged on a tree
from before the render kernels.
"""

from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

PROBED = ("tile_contributors", "_render_tiles", "render_tile_list", "assemble_tiles",
          "multiband_blend", "resize_axis", "render_sample", "multiband")


def emit(**rec):
    print(json.dumps(rec), flush=True)


@contextlib.contextmanager
def record_calls(store: list):
    """Append (args, kwargs) of every `render_rotational` call to `store`."""
    from autopanostitch_tpu_torch.models import render

    orig = render.render_rotational

    def rec(*args, **kw):
        store.append((args, kw))
        return orig(*args, **kw)

    render.render_rotational = rec
    try:
        yield
    finally:
        render.render_rotational = orig


@contextlib.contextmanager
def ranges():
    """Wrap each PROBED function of the port's loaded modules in a
    `record_function` range named probe::<name> (one wrapper a function,
    set wherever a module holds it)."""
    mods = [m for n, m in list(sys.modules.items())
            if n.startswith("autopanostitch_tpu_torch") and m is not None]
    saved, wrappers = [], {}
    for mod in mods:
        for name in PROBED:
            fn = mod.__dict__.get(name)
            if not callable(fn) or not getattr(fn, "__module__", "").startswith(
                    "autopanostitch_tpu_torch"):
                continue
            if id(fn) not in wrappers:
                def wrap(f=fn, label=f"probe::{name}"):
                    @functools.wraps(f)
                    def run(*a, **k):
                        with torch.profiler.record_function(label):
                            return f(*a, **k)
                    return run
                wrappers[id(fn)] = wrap()
            saved.append((mod, name, fn))
            setattr(mod, name, wrappers[id(fn)])
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_call(fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # the device's own work: the probe's ranges also show on the device's
    # timeline (as user annotations), so they are left out
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("probe::")]
    kernels = [e for e in dev if "Memcpy" not in e.name and "Memset" not in e.name]
    copies = {}
    for e in dev:
        if "Memcpy" in e.name or "Memset" in e.name:
            copies[e.name] = copies.get(e.name, 0) + 1
    runtime, funcs, by_kernel = {}, {}, {}
    for a in prof.key_averages():
        if a.key.startswith(("cuda", "cu")) and a.device_type == DeviceType.CPU:
            runtime[a.key] = {"calls": a.count, "host_ms": a.cpu_time_total / 1e3}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("probe::"):
            f = funcs.setdefault(e.name[7:], {"calls": 0, "host_ms": 0.0, "host_self_ms": 0.0})
            f["calls"] += 1
            f["host_ms"] += e.time_range.elapsed_us() / 1e3
            f["host_self_ms"] += e.self_cpu_time_total / 1e3
    for e in kernels:
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "wall_s": wall,
        "device_busy_ms": union_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1e3
        if dev else None,
        "device_kernels": len(kernels),
        "device_kernel_ms": sum(v[1] for v in by_kernel.values()) / 1e3,
        "device_copies": copies, "runtime": runtime, "functions": funcs,
        "top_kernels": [{"name": n[:120], "count": c, "ms": us / 1e3} for n, (c, us) in top],
    }


def probe(label: str, calls: list) -> None:
    from autopanostitch_tpu_torch.models import render

    for i, (args, kw) in enumerate(calls):
        canvas = kw.get("canvas", args[4] if len(args) > 4 else None)

        def run():
            return render.render_rotational(*args, **kw)

        run()  # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        emit(probe=label, call=i, mode=canvas["mode"], canvas=[canvas["Hc"], canvas["Wc"]],
             images=list(args[0].shape), tile=list(kw.get("tile", ())),
             blend=kw.get("blend_mode"), interp=kw.get("interp"),
             wall_s=float(np.median(walls)), wall_runs_s=walls, profile=profile_call(run))


def main() -> int:
    if not torch.cuda.is_available():
        print("render_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from autopanostitch_tpu_torch import api, config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(env=smi, torch=torch.__version__, cuda=torch.version.cuda)
    dev = "cuda"
    n, f, w, h, env_hw = chip_smoke.RING
    iset, _, _ = chip_smoke.ring_scene(n, f, w, h, env_hw)
    ring_calls = []
    with record_calls(ring_calls):
        api.stitch(iset, config.StitchConfig(), seed=0, device=dev)
    probe("ring", ring_calls)
    iset, _ = chip_smoke.multipano_scene(12, 600.0, 800, 600, (1024, 2048), 400)
    cfg = chip_smoke.config_with(config, {"render": {"projections": ("spherical", "cylindrical")}})
    folder_calls = []
    with record_calls(folder_calls):
        api.stitch(iset, cfg, seed=0, device=dev)
    probe("folder", folder_calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
