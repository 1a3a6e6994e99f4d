#!/usr/bin/env python3
"""Where the rotational bundle adjustment's time goes, on the card.

    python3 autopanostitch_tpu_torch/tools/ba_probe.py

Needs one CUDA GPU and nvcc. On two synthetic rings at the shapes of
chip_smoke.py's stitches (`utils.ba_scene.ring_scene`: 20 views, each
paired with the next 3, M = 300; 100 views paired with the next, M = 256;
FILL of each pair's slots real, as in chip_smoke's ring; k1 estimated, pd =
5, the default BundleConfig) it runs
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
they are dropped).

Then, for each bucket shape (nb, pb) of the ring's phases, at its largest
phase linearised at the warm run's result, both linearisations: `ba_system`
(the main path) and the per-pair one (`ba_normals` + the one-hot einsum
assembly, its camera map built once a phase): each one's device
time a launch (a CUDA graph of 20 back-to-back calls, replay time / 20),
beside an empty kernel's (the launch floor); and an LM iteration's replay
split: the phase captured as one graph with 0 and with 8 iterations, an
iteration = the difference / 8, of which the solve (the Cholesky graph
above at the phase's size), the linearisation (as just timed) and the rest
(the damped system, the step's caps, the rotation update, the accept test);
and the kernels one replay of the ring's largest 8-iteration phase runs
(torch.profiler: launches and device time by name).
Last, the warm BA wall of each ring with the LM run on the per-pair
linearisation (its camera map built each linearisation), its graphs
captured anew, beside the main path's. Prints one JSON record a line. (The
same phases run eagerly are chip_smoke.py's phase 9b.)
"""

from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

RINGS = {"ring20": (20, 3, 300), "ring100": (100, 1, 256)}
GRAPH_CALLS = 20  # calls a CUDA graph of `timing.graph_ms` holds
FILL = 0.22  # real match slots a pair: chip_smoke.py's ring phase has 4,307 of 19,200


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


def per_pair_normal_eqns(E=None):
    """`bundle._normal_eqns` on the per-pair kernel: `ba_normals`, then the
    one-hot einsum assembly through E (built each call if None)."""
    from autopanostitch_tpu_torch.kernels import ba as kba

    def normal_eqns(Rb, f, k1, inp, pd, st):
        cmap = kba.camera_map(inp["pij"], Rb.shape[0], f.dtype) if E is None else E
        return kba.assemble_plain(*kba.ba_normals(
            Rb, f, k1, inp["cx"], inp["cy"], inp["u_i"], inp["u_j"], inp["w"], inp["pij"], pd,
            st.sigma, st.one_direction), cmap)

    return normal_eqns


def linearisation_split(spec, inp, pd: int, st, solve: float, floor: float) -> dict:
    """Both linearisations' device time a launch at one phase, and an LM
    iteration's replay split under each (ms)."""
    from autopanostitch_tpu_torch.kernels import ba as kba
    from autopanostitch_tpu_torch.models import bundle as tba
    from autopanostitch_tpu_torch.utils import timing

    E = kba.camera_map(inp["pij"], spec.nb, torch.float32)
    paths = {"ba_system": tba._normal_eqns, "per_pair": per_pair_normal_eqns(E)}
    rec = dict(nb=spec.nb, pb=spec.pb, npair=spec.npair, matches=int((inp["w"] > 0).sum()),
               launch_floor_ms=floor, solve_ms=solve)
    saved = tba._normal_eqns
    try:
        for name, fn in paths.items():
            tba._normal_eqns = fn
            lin = timing.graph_ms(lambda: fn(inp["Rb"], inp["f"], inp["k1"], inp, pd, st),
                                  GRAPH_CALLS)
            phase = {it: timing.graph_ms(lambda: tba._lm_phase(inp, pd, it, st), n=1, reps=9)
                     for it in (0, 8)}
            iteration = (phase[8] - phase[0]) / 8
            rec[name] = dict(linearisation_ms=lin, phase0_ms=phase[0], phase8_ms=phase[8],
                             iteration_ms=iteration, rest_ms=iteration - lin - solve)
    finally:
        tba._normal_eqns = saved
    return rec


def profile_replay(graph, reps: int = 3) -> dict:
    """What a phase graph's replay runs (torch.profiler): its kernels by
    name, each one's launches and device time a replay (ms), the 15 that
    take the most time first."""
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    rows = sorted(((e.key[:90], e.count / reps, e.self_device_time_total / reps / 1e3)
                   for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    return dict(kernels_a_replay=sum(r[1] for r in rows),
                device_ms_a_replay=sum(r[2] for r in rows),
                top=[dict(name=n, launches=c, ms=t) for n, c, t in rows[:15]])


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
    from autopanostitch_tpu_torch.utils import timing
    from autopanostitch_tpu_torch.utils.ba_scene import perturbed_state, ring_scene

    dev = torch.device("cuda", 0)
    _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(card=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__)
    cfg = BundleConfig()
    st = tba._statics(cfg)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    floor = timing.launch_floor_ms(GRAPH_CALLS)
    solves = {}
    walls = {}
    for name, (n, hops, M) in RINGS.items():
        sc = ring_scene(n, hops, M, seed=13, fill=FILL)
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
            walls.setdefault(name, []).append(wall)
            emit(ring=name, run=label, wall_s=wall, captures=tba.graph_captures - caps,
                 replays=tba.graph_replays - reps,
                 max_focal_err=float((out[1] / float(sc["f"][0]) - 1).abs().max()),
                 cost=float(out[3]))
        same = all(torch.equal(a, b) for a, b in zip(outs[0], outs[-1]))
        # the split of a warm run: the host's phase set-up, each phase's replay on the device
        t0 = time.perf_counter()
        specs, _ = tba._phase_plan(f0, sc["pairs"], tba.pair_extents(sc["w"]), list(range(n)), 0,
                                   cfg)
        spec_s = time.perf_counter() - t0
        replay = {}
        for (_, _, iters, _, (pb, m, _), nb), graph in tba._graphs.items():
            if m == M:
                replay[(nb, pb, iters)] = event_ms(graph.graph.replay, 5)
        device_s = sum(replay[(s_.nb, s_.pb, s_.iters)] for s_ in specs) / 1e3
        # what the largest 8-iteration phase's replay runs
        key = max((k for k in tba._graphs if k[4][1] == M and k[2] == 8), key=lambda k: k[4][0])
        emit(ring=name, phase=f"nb{key[5]}_pb{key[4][0]}_iters8",
             profile=profile_replay(tba._graphs[key].graph))
        # both linearisations and an iteration's split at each bucket shape's largest phase
        R, f, k1 = outs[-1][:3]
        largest = {}
        for s_ in specs:
            if len(s_.act) >= len(largest.get((s_.nb, s_.pb), ((), 0))[0]):
                largest[(s_.nb, s_.pb)] = (s_.act, s_)
        for act, s_ in largest.values():
            spec = tba._phase_spec(n, sc["pairs"], tba.pair_extents(sc["w"]), act, 0, None,
                                   cfg.focal_step_fracs[-1], tba._K1_STEP_CAP,
                                   float(cfg.lambda0), 0)
            inp = tba._phase_inputs(spec, t(spec.ints, torch.long), t(spec.floats), R, f, k1,
                                    t(sc["cx"]), t(sc["cy"]), t(sc["u_i"]), t(sc["u_j"]),
                                    t(sc["w"]))
            size = 5 * spec.nb
            if size not in solves:
                solves[size] = solve_ms(size, dev)
            emit(ring=name, **linearisation_split(spec, inp, 5, st, solves[size]["graph_ms"],
                                                  floor))
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
        emit(solve=solves.get(n) or solve_ms(n, dev))
    # the warm BA on the per-pair linearisation, its graphs captured anew
    saved = tba._normal_eqns
    tba._graphs.clear()
    try:
        tba._normal_eqns = per_pair_normal_eqns()
        for name, (n, hops, M) in RINGS.items():
            sc = ring_scene(n, hops, M, seed=13, fill=FILL)
            R0, f0, _ = perturbed_state(sc, seed=14)
            f0[:] = f0.mean()
            args = (R0, f0, sc["cx"], sc["cy"], sc["u_i"], sc["u_j"], sc["w"], sc["pairs"],
                    list(range(n)), 0, cfg)
            old = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tba.run_incremental_ba(*args, with_k1=True, device=dev)
                torch.cuda.synchronize()
                old.append(time.perf_counter() - t0)
            emit(ring=name, warm_ba_wall_s={"ba_system": walls[name][1:], "per_pair": old[1:]},
                 first_ba_wall_s={"ba_system": walls[name][0], "per_pair": old[0]}, nvidia_smi=smi)
    finally:
        tba._normal_eqns = saved
        tba._graphs.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
