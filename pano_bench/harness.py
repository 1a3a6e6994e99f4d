"""One run of one cell: set-up, the measured window, the check, the line.

Set-up makes the cell's pool of folders from the seed and stitches each
once, so that every shape the window uses (every CUDA graph of the bundle
adjustment) is built before it. The window is a closed loop with one
client, always (a traffic file names no number of clients): `api.stitch`
on the next folder of the pool as soon as the last returned, until
`seconds` have passed since the first call; the folder started last
finishes inside it. After the window the reference judges one result of
each folder of the pool, drawn from the seed among its stitches in the
window (`reference.py`), with what its second passes derived, by the
configuration the cell states: a run that changes the program's
configuration (the control) does not change the rule its matches are held
to.

With `trace`, each stitch gets a stage timer (its stages' seconds are the
device's stream time between CUDA events, read after the stitch), the
window is profiled, and the line carries the cell's per-layer metrics
instead of its end-to-end ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from pano_bench import devtrace, reference, scenes, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "autopanostitch_tpu")


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads after a traced window."""

    folders: int
    stages: Dict[str, float]
    counters: Dict[str, float]
    trace: Optional[devtrace.Trace]
    device_kind: str
    store: dict

    def per_folder(self, *stages: str):
        """Seconds a folder of the named stages, or None where none ran."""
        if not self.folders or not any(s in self.stages for s in stages):
            return None
        return sum(self.stages.get(s, 0.0) for s in stages) / self.folders


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _timer_class():
    from autopanostitch_tpu_torch.models.pipeline import StageTimer

    class BenchTimer(StageTimer):
        """The pipeline's stage timer, each stage also marked in the trace."""

        @contextlib.contextmanager
        def stage(self, name: str):
            with torch.profiler.record_function(devtrace.STAGE_PREFIX + name):
                with super().stage(name):
                    yield

    return BenchTimer


def worst_of(rows: List[Dict[str, float]], limits: dict) -> Dict[str, float]:
    """Each limited number's worst over the judged folders (NaN where none
    gave it)."""
    out = {}
    for name, lim in limits.items():
        vals = [r[name] for r in rows if name in r]
        if not vals:
            out[name] = float("nan")
        elif lim["better"] == "lower":
            out[name] = max(vals)
        else:
            out[name] = min(vals)
    return out


class SecondPasses:
    """Keeps what the program's second pass derived during a stitch (the
    re-extracted features and the re-verified graph of each component that
    `pipeline.second_pass_component` returns), so that the reference judges
    those matches too. `install()` wraps the program's function; `take()`
    hands over, and forgets, what the last stitch kept. Where the program
    has no such function, nothing is kept and `missing` says so."""

    def __init__(self):
        self.kept: list = []
        self.missing = False
        self._undo = None

    def install(self):
        from autopanostitch_tpu_torch.models import pipeline

        fn = getattr(pipeline, "second_pass_component", None)
        if fn is None:
            self.missing = True
            return self

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            if out is not None:  # (comp_set, images, feats, graph): the images are not kept
                self.kept.append((out[2], out[3]))
            return out

        pipeline.second_pass_component = recorded

        def undo():
            pipeline.second_pass_component = fn

        self._undo = undo
        return self

    def take(self) -> list:
        out, self.kept = self.kept, []
        return out

    def uninstall(self):
        if self._undo is not None:
            self._undo()
            self._undo = None


def judge(folder, result, config: dict, second_passes=()) -> Dict[str, float]:
    """The numbers the reference compares for one folder's result, by the
    configuration the cell states (`config`: its bundle adjustment's
    objective, its ratios and its matcher, `reference.stated_matcher`); the
    match numbers are the worst over the first pass and each second pass."""
    kind = folder.truth["kind"]
    if kind == "rotational":
        nums = reference.judge_rotational(result, folder.truth)
    else:
        nums = reference.judge_planar(result, folder.truth, config["stitch_config"]["bundle"])
    m = config["stitch_config"]["matching"]
    matcher = reference.stated_matcher(config)
    g = result.graph
    nums.update(reference.match_excess(
        result.features.desc, result.features.mask, g.pairs, g.pair_idx, g.pair_mask, g.counts,
        float(m["ratio_threshold"]), float(m["pairwise_rescue_ratio"]), matcher=matcher))
    for feats, g2 in second_passes:
        r = float(m["ratio_threshold"])
        sp = reference.match_excess(feats.desc, feats.mask, g2.pairs, g2.pair_idx, g2.pair_mask,
                                    g2.counts, r, r, pairwise_only=True, matcher=matcher)
        for k in ("match_excess", "match_missing"):
            nums[k] = max(nums[k], sp[k])
    nums["second_passes"] = float(len(second_passes))
    return nums


def _passes(value: float, lim: dict) -> bool:
    if value is None or math.isnan(value):
        return False
    return value <= lim["limit"] if lim["better"] == "lower" else value >= lim["limit"]


def run_cell(bench: dict, workload: dict, seed: int, seconds: float, trace: bool,
             device: str, t_process: float, traffic: Optional[dict] = None,
             config: Optional[dict] = None, limits: Optional[dict] = None,
             stated: Optional[dict] = None) -> dict:
    """Set-up, window and check of one run; returns the result line's object.
    `traffic`, `config` and `limits` replace the cell's files (tests);
    `config` is what the program runs, `stated` the configuration its
    results are judged by: the cell's file unless given."""
    from autopanostitch_tpu_torch import api
    from autopanostitch_tpu_torch.models import bundle

    name = workload["name"]
    traffic = traffic if traffic is not None else spec.traffic(workload["traffic"])
    stated = stated if stated is not None else spec.config_file(bench, workload["config"])
    config = config if config is not None else stated
    limits = (limits if limits is not None else spec.limits(name))["checks"]
    cfg = spec.stitch_config(config)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from autopanostitch_tpu_torch.kernels import _build

        _build.library()
    pool = [scenes.make(traffic, seed, i, dev) for i in range(int(traffic["pool"]))]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5EED]))
    order = [int(i) for i in rng.permutation(len(pool))]
    if on_card:  # the peak is the program's, not that of making the pool
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def stitch(folder, timer=None):
        res = api.stitch(folder.iset, cfg, seed=folder.stitch_seed, device=device,
                         timer=timer)
        if on_card:
            torch.cuda.synchronize(dev)
        return res

    second = SecondPasses().install()
    for j in order:
        stitch(pool[j])
        second.take()
    setup_s = time.perf_counter() - t_process

    metric_entries = spec.per_layer(bench, name) if trace else []
    metric_mods = {m["name"]: spec.metric_module(m["name"]) for m in metric_entries}
    store: dict = {}
    restore = []
    for mod in metric_mods.values():
        if hasattr(mod, "install"):
            restore.append(mod.install(store))
    timer_cls = _timer_class() if trace else None
    stages: Dict[str, float] = {}
    captures0 = bundle.graph_captures
    kept: Dict[int, tuple] = {}
    seen = [0] * len(pool)
    times: List[float] = []
    attempted = failed = 0
    mark = torch.profiler.record_function(devtrace.WINDOW)

    def end_trace():
        """Stop profiling: the trace's events; the metrics' hooks undone."""
        mark.__exit__(None, None, None)
        ev = devtrace.stop()
        for undo in restore:
            if undo is not None:
                undo()
        return ev

    # the profile covers the window's first two passes over the pool
    traced = 2 * len(pool) if trace else 0
    events = None
    if trace:
        devtrace.start(on_card)
        mark.__enter__()
    t_w0 = t_end = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t_w0 < seconds:
        j = order[k % len(pool)]
        timer = timer_cls(dev if on_card else None) if trace else None
        attempted += 1
        t = time.perf_counter()
        try:
            res = stitch(pool[j], timer)
        except Exception:  # a folder that fails is counted, and the run is not correct
            failed += 1
            res = None
            traceback.print_exc(file=sys.stderr)
        t_end = time.perf_counter()
        times.append(t_end - t)
        passes = second.take()
        if timer is not None:
            for s, v in timer.report().items():
                stages[s] = stages.get(s, 0.0) + v
        if res is not None:
            seen[j] += 1
            if rng.integers(seen[j]) == 0:  # one result of each folder, uniformly
                kept[j] = (res, passes)
        del res, passes
        k += 1
        if k == traced:
            events = end_trace()
    window_s = t_end - t_w0
    second.uninstall()
    print(f"window: {attempted} stitches in {window_s:.3f} s: "
          + " ".join(f"{x:.4f}" for x in times), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    tr = None
    if trace:
        if events is None:  # a window shorter than two passes: the profile ends with it
            events = end_trace()
        t = time.perf_counter()
        tr = devtrace.Trace(events)
        print(f"trace: {len(events)} events of {min(k, traced)} stitches read in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
        del events
    completed = attempted - failed
    out_metrics: Dict[str, dict] = {}
    breakdown = None
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = Context(folders=completed, stages=stages,
                      counters={"ba_graph_captures": bundle.graph_captures - captures0},
                      trace=tr, device_kind=device_info["kind"], store=store)
        for m in metric_entries:
            v = metric_mods[m["name"]].read(ctx)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
        del tr
    elif completed:
        e2e = {"stitch_s": window_s / completed,
               "stitch_p90_s": statistics.quantiles(times, n=10, method="inclusive")[8]
               if len(times) > 1 else times[0],
               "setup_s": setup_s}
        for m in spec.end_to_end(bench, name):
            out_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    store.clear()
    if on_card:
        torch.cuda.empty_cache()
    if second.missing:
        print("harness: the program has no pipeline.second_pass_component; second passes "
              "are judged only through the panoramas", file=sys.stderr)
    rows = [judge(pool[j], res, stated, passes) for j, (res, passes) in sorted(kept.items())]
    kept.clear()
    worst = worst_of(rows, limits)
    checks = {c: {"value": worst[c], "limit": lim["limit"]} for c, lim in limits.items()}
    correct = (failed == 0 and bool(rows)
               and all(_passes(worst[c], lim) for c, lim in limits.items()))
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": out_metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["folders_judged"] = len(rows)
    line["second_passes_judged"] = int(sum(r.get("second_passes", 0) for r in rows))
    line["checks"] = checks
    return line


def check_lines(line: dict) -> List[str]:
    """Each number compared beside its limit, one a line."""
    return [f"check {c}: {v['value']!r} limit {v['limit']!r}"
            for c, v in line["checks"].items()]
