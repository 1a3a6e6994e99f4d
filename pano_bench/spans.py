"""The program's own spans and counters in a traced window, for the
per-layer metrics that read them (`metrics/idle_s.*`, `host_syncs`,
`ransac_accept_share`, `lm_iterations`).

`install(store)` subscribes to the program's tracer
(`autopanostitch_tpu_torch.utils.trace`) once for all of those metrics:
each stitch that ends while the window is profiled is kept in
`store[KEY]` as a `Kept` (its root span's host interval, every span's name
and interval, its counters). It returns the undo the first time and None
after; where the program has no tracer it keeps nothing, and the readers
return None. The harness undoes it when the profile stops, so the kept
stitches are the profiled ones: a metric "a folder" divides by them.

Host intervals come from the spans, device intervals from the trace
(`devtrace.Trace.segments`); both are ns on the same clock, the host's
`time.time_ns()`, which the profiler's events carry.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

KEY = "program_stitches"

# the stage spans of each group, as the `stage_s.*` metrics group them
GROUPS: Dict[str, Tuple[str, ...]] = {
    "features": ("features",),
    "matching": ("matching",),
    "ransac": ("ransac",),
    "recognition": ("pairwise_rescue", "second_pass"),
    "ba": ("bundle_adjustment", "bundle_adjustment_h"),
    "render": ("gain", "render"),
}

# host runtime calls that wait for the device (not the `Async` copies)
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}


class Kept(NamedTuple):
    root: Tuple[int, int]
    spans: List[Tuple[str, int, int]]
    counters: Dict[str, float]


def install(store: dict):
    if KEY in store:
        return None
    try:
        from autopanostitch_tpu_torch.utils import trace
    except ImportError:
        return None
    kept = store[KEY] = []

    def keep(rec):
        kept.append(Kept((rec.root.start_ns, rec.root.end_ns),
                         [(s.name, s.start_ns, s.end_ns) for s in rec.spans[1:]],
                         dict(rec.counters)))

    return trace.subscribe(keep)


def stitches(ctx) -> Optional[List[Kept]]:
    """The kept stitches, or None where there are none."""
    kept = ctx.store.get(KEY)
    return kept or None


def busy_ns(segments: np.ndarray, a: int, b: int) -> int:
    """Device-busy ns inside [a, b], of the device's sorted, disjoint busy
    segments (`devtrace.Trace.segments`)."""
    i = int(np.searchsorted(segments[:, 1], a, "right"))
    j = int(np.searchsorted(segments[:, 0], b, "left"))
    if j <= i:
        return 0
    return int((np.clip(segments[i:j, 1], a, b) - np.clip(segments[i:j, 0], a, b)).sum())


def idle_ns(segments: np.ndarray, a: int, b: int) -> int:
    """ns inside [a, b] in which the device was idle."""
    return (b - a) - busy_ns(segments, a, b)


def idle_s(ctx, group: str) -> Optional[float]:
    """Device idle seconds a folder while the host was inside the group's
    stage spans (`GROUPS`), or, for "other", inside the root span but in no
    group's. A stitch's stages run one after another under its root, so
    their spans do not overlap, and "other" is the root's idle time less
    theirs."""
    kept = stitches(ctx)
    if kept is None or ctx.trace is None:
        return None
    seg = ctx.trace.segments
    names = (tuple(n for g in GROUPS.values() for n in g) if group == "other"
             else GROUPS[group])
    total = 0
    for k in kept:
        inside = sum(idle_ns(seg, a, b) for n, a, b in k.spans if n in names)
        total += idle_ns(seg, *k.root) - inside if group == "other" else inside
    return total * 1e-9 / len(kept)


def is_sync(name: str) -> bool:
    """A host runtime call that waits for the device (`SYNCS`, with or
    without a `_v<n>` version suffix)."""
    return re.sub(r"_v\d+$", "", name) in SYNCS


def host_syncs(ctx) -> Optional[float]:
    """The device trace's host calls that wait for the device (`SYNCS`)
    that start inside a root span, a folder."""
    kept = stitches(ctx)
    if kept is None or ctx.trace is None:
        return None
    tr = ctx.trace
    starts = np.array([s for s, n in zip(tr.host_start.tolist(), tr.host_name) if is_sync(n)],
                      np.int64)
    n = 0
    for k in kept:
        a, b = k.root
        n += int(np.searchsorted(starts, b, "right") - np.searchsorted(starts, a, "left"))
    return n / len(kept)


def counter(ctx, name: str) -> Optional[float]:
    """The counter summed over the kept stitches."""
    kept = stitches(ctx)
    if kept is None:
        return None
    return float(sum(k.counters.get(name, 0) for k in kept))
