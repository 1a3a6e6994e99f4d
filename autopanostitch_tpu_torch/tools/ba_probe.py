#!/usr/bin/env python3
"""Where the rotational bundle adjustment's time goes, on the card.

    python3 autopanostitch_tpu_torch/tools/ba_probe.py

Needs one CUDA GPU and nvcc. On two synthetic rings at the shapes of
chip_smoke.py's stitches (`utils.ba_scene.ring_scene`: 20 views, each
paired with the next 3, M = 300; 100 views paired with the next, M = 256;
k1 estimated, pd = 5, the default BundleConfig) it runs
`bundle.run_incremental_ba` from CUDA graphs:
  graph_first  capturing the shapes this ring needs;
  graph_warm   from the cached graphs, three times;
then splits a warm run into the host's phase set-up (`bundle._phase_plan`),
the device time of each phase's graph replay (CUDA events around
`graph.replay()` of the cached graphs, median of 5), and the rest of the
wall time (uploads, gathers, scatters, the final read-back); and times the
LM's Cholesky factorisation and solve alone at each phase's (pd nb)^2
system, eagerly and captured in a graph (CUDA events, median of 20), which
also shows whether cuSOLVER's `potrf` / `potrs` can be captured; and the
device memory the ring's graphs hold (`memory_reserved` before and after
they are dropped). Prints one JSON record a line. (The same phases run
eagerly are chip_smoke.py's phase 9b.)
"""

from __future__ import annotations

import gc
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

RINGS = {"ring20": (20, 3, 300), "ring100": (100, 1, 256)}


def emit(**rec):
    print(json.dumps(rec), flush=True)


def event_ms(fn, reps: int) -> float:
    fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def solve_ms(n: int, dev) -> dict:
    """cholesky_ex + cholesky_solve of an SPD (n, n) float32 system, eager
    and replayed from a graph (ms)."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)).astype(np.float32)
    H = torch.as_tensor(A @ A.T / n + np.eye(n, dtype=np.float32), device=dev)
    g = torch.as_tensor(rng.standard_normal((n, 1)).astype(np.float32), device=dev)

    def solve():
        L, _ = torch.linalg.cholesky_ex(H)
        return torch.cholesky_solve(g, L)

    eager = event_ms(solve, 20)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x = solve()
    graph.replay()
    torch.cuda.synchronize()
    same = bool(torch.equal(x, solve()))
    return dict(n=n, eager_ms=eager, graph_ms=event_ms(graph.replay, 20), graph_equals_eager=same)


def main() -> int:
    if not torch.cuda.is_available():
        print("ba_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    from autopanostitch_tpu_torch.config import BundleConfig
    from autopanostitch_tpu_torch.kernels import _build
    from autopanostitch_tpu_torch.models import bundle as tba
    from autopanostitch_tpu_torch.utils.ba_scene import perturbed_state, ring_scene

    dev = torch.device("cuda", 0)
    _build.library()
    emit(card=torch.cuda.get_device_name(0), torch=torch.__version__)
    cfg = BundleConfig()
    for name, (n, hops, M) in RINGS.items():
        sc = ring_scene(n, hops, M, seed=13)
        R0, f0, _ = perturbed_state(sc, seed=14)
        f0[:] = f0.mean()
        args = (R0, f0, sc["cx"], sc["cy"], sc["u_i"], sc["u_j"], sc["w"], sc["pairs"],
                list(range(n)), 0, cfg)
        outs = []
        for label in ("graph_first", "graph_warm", "graph_warm", "graph_warm"):
            caps, reps = tba.graph_captures, tba.graph_replays
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tba.run_incremental_ba(*args, with_k1=True, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            outs.append(out)
            emit(ring=name, run=label, wall_s=wall, captures=tba.graph_captures - caps,
                 replays=tba.graph_replays - reps,
                 max_focal_err=float((out[1] / float(sc["f"][0]) - 1).abs().max()),
                 cost=float(out[3]))
        same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[-1]))
        # the split of a warm run: the host's phase set-up, each phase's replay on the device
        t0 = time.perf_counter()
        specs, _ = tba._phase_plan(f0, sc["pairs"], list(range(n)), 0, cfg)
        spec_s = time.perf_counter() - t0
        replay = {}
        for (_, _, iters, _, (pb, m, _), nb), graph in tba._graphs.items():
            if m == M:
                replay[(nb, pb, iters)] = event_ms(graph.graph.replay, 5)
        device_s = sum(replay[(s_.nb, s_.pb, s_.iters)] for s_ in specs) / 1e3
        # the device memory the ring's graphs hold: their pools and static inputs
        outs.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        for key in [k for k in tba._graphs if k[4][1] == M]:
            del tba._graphs[key]
        gc.collect()
        torch.cuda.empty_cache()
        graph_mb = (held - torch.cuda.memory_reserved()) / 1e6
        emit(ring=name, warm_equals_first=same, graph_memory_mb=graph_mb, phases=len(specs),
             iterations=sum(s_.iters for s_ in specs), host_phase_plan_s=spec_s,
             replays_device_s=device_s,
             replay_ms={f"nb{a}_pb{b}_iters{c}": v for (a, b, c), v in replay.items()})
    for n in (320, 640):
        emit(solve=solve_ms(n, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
