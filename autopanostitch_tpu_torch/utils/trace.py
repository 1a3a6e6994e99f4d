"""Spans and counters of a stitch: the port's one tracer.

A span is a named block of host work: its id, its parent's, the id of the
stitch it belongs to (every span of one `pipeline.stitch` call shares it),
the folder's tag (12 hex characters of `cache.fingerprint` over the image
names and sizes, a colon, the number of views), and its host start and end
in ns on `time.time_ns()`, the clock that the profiler's events carry. A
counter adds a value the host already holds to the innermost open span.
When a stitch ends, its spans (`Stitch`) go to every subscriber
(`subscribe`); nothing is written while it runs. Where a `torch.profiler`
session is active, each span also opens `record_function("apst:" + name)`,
so a profiler trace shows it.

A stitch records only while something subscribed. Otherwise `span` is one
read of a module-level integer that returns the shared `NULL` context, and
`count` one read and a return. Each thread keeps its own open stitch and
span stack.

`stage(name, device)` is the span beneath `StageTimer`, which exists
whether or not the stitch records: on a CUDA device it
also records a CUDA event on the current stream where the host enters and
where it leaves, and its seconds are the stream time between the two,
resolved when read (`Span.seconds`); elsewhere host seconds. No other span
records an event, and no span synchronises the device.

`summary` and `format_table` give, for each span name, its count, total,
self time (its duration less what its children cover), the device's idle
time inside it and the host calls inside it that wait for the device
(`SYNCS`); `format_counters` each stitch's counters (`cli --profile`).
"""

from __future__ import annotations

import itertools
import re
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

PREFIX = "apst:"
# host runtime calls that wait for the device (not the `Async` copies)
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}

_live = 0  # subscribers + stitches recording now; 0: nothing records
_subscribers: List[Callable] = []
_lock = threading.Lock()
_local = threading.local()  # .rec: this thread's open Stitch, or absent
_ids = itertools.count(1)


class _Null:
    """The context of a span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


class Span:
    """One block of host work (times in ns on `time.time_ns()`)."""

    __slots__ = ("name", "id", "parent", "stitch", "folder", "start_ns", "end_ns", "tags",
                 "counters", "events")

    def __init__(self, name: str, sid: int, parent: Optional[int], stitch: Optional[int],
                 folder: Optional[str], tags: dict):
        self.name, self.id, self.parent = name, sid, parent
        self.stitch, self.folder, self.tags = stitch, folder, tags
        self.start_ns = self.end_ns = 0
        self.counters: Dict[str, float] = {}
        self.events = None  # (start, end) CUDA events of a stage timed on the device

    def seconds(self) -> float:
        """The stream time between the stage's CUDA events (waiting for the
        end event), or the host seconds."""
        if self.events is not None:
            e0, e1 = self.events
            e1.synchronize()
            return e0.elapsed_time(e1) / 1e3
        return (self.end_ns - self.start_ns) * 1e-9


class Stitch:
    """What one stitch recorded: its spans, the root (`stitch`) first and
    every parent before its children."""

    __slots__ = ("id", "folder", "spans", "stack")

    def __init__(self, sid: Optional[int], folder: Optional[str]):
        self.id, self.folder = sid, folder
        self.spans: List[Span] = []
        self.stack: List[Span] = []

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def counters(self) -> Dict[str, float]:
        """Every counter summed over the stitch's spans."""
        out: Dict[str, float] = {}
        for sp in self.spans:
            for k, v in sp.counters.items():
                out[k] = out.get(k, 0) + v
        return out


def subscribe(fn: Callable[[Stitch], None]) -> Callable[[], None]:
    """Hand every stitch that ends from now on, in any thread, to fn.
    Returns the undo."""
    global _live
    with _lock:
        _subscribers.append(fn)
        _live += 1

    def undo():
        global _live
        with _lock:
            if fn in _subscribers:
                _subscribers.remove(fn)
                _live -= 1

    return undo


class _SpanCtx:
    __slots__ = ("rec", "name", "tags", "sid", "span", "rf")

    def __init__(self, rec: Stitch, name: str, tags: dict, sid: Optional[int] = None):
        self.rec, self.name, self.tags, self.sid = rec, name, tags, sid
        self.rf = None

    def __enter__(self) -> Span:
        rec = self.rec
        parent = rec.stack[-1].id if rec.stack else None
        sp = Span(self.name, self.sid or next(_ids), parent, rec.id, rec.folder, self.tags)
        rec.spans.append(sp)
        rec.stack.append(sp)
        self.span = sp
        sp.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        return sp

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        self.span.end_ns = time.time_ns()
        self.rec.stack.pop()
        return False


def span(name: str, **tags):
    """A span of the open stitch of this thread, under its innermost open
    span; `NULL` where nothing records."""
    if not _live:
        return NULL
    rec = getattr(_local, "rec", None)
    if rec is None:
        return NULL
    return _SpanCtx(rec, name, tags)


def count(name: str, value=1) -> None:
    """Add value to the counter `name` of the innermost open span."""
    if not _live:
        return
    rec = getattr(_local, "rec", None)
    if rec is None or not rec.stack:
        return
    c = rec.stack[-1].counters
    c[name] = c.get(name, 0) + value


def tag(**tags) -> None:
    """Set tags on the innermost open span."""
    if not _live:
        return
    rec = getattr(_local, "rec", None)
    if rec is not None and rec.stack:
        rec.stack[-1].tags.update(tags)


class _Stage:
    """`stage`'s context: a span that exists also where nothing records (a
    timed stitch that nobody subscribed to, a timer's block outside a
    stitch), with CUDA events on a CUDA device."""

    __slots__ = ("ctx", "stream")

    def __init__(self, name: str, device):
        rec = getattr(_local, "rec", None)
        self.ctx = _SpanCtx(rec if rec is not None else Stitch(None, None), name, {})
        cuda = device is not None and device.type == "cuda"
        self.stream = torch.cuda.current_stream(device) if cuda else None

    def __enter__(self) -> Span:
        sp = self.ctx.__enter__()
        if self.stream is not None:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(self.stream)
            sp.events = (e0, None)
        return sp

    def __exit__(self, *exc):
        sp = self.ctx.span
        if self.stream is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(self.stream)
            sp.events = (sp.events[0], e1)
        return self.ctx.__exit__(*exc)


def stage(name: str, device=None) -> _Stage:
    """A stage span for a timer (`pipeline.StageTimer`); `device` a
    torch.device or None (host seconds)."""
    return _Stage(name, device)


class _Root:
    __slots__ = ("rec", "ctx", "prev", "launches")

    def __init__(self, names, sizes, tags: dict):
        from autopanostitch_tpu_torch.utils.cache import fingerprint

        sid = next(_ids)
        self.rec = Stitch(sid, f"{fingerprint(names, sizes, '')[:12]}:{len(sizes)}")
        self.ctx = _SpanCtx(self.rec, "stitch", tags, sid)

    def __enter__(self) -> Stitch:
        global _live
        from autopanostitch_tpu_torch import kernels

        self.prev = getattr(_local, "rec", None)
        _local.rec = self.rec
        with _lock:
            _live += 1
        self.launches = kernels.launch_counts()
        self.ctx.__enter__()
        return self.rec

    def __exit__(self, exc_type, *exc):
        global _live
        from autopanostitch_tpu_torch import kernels

        root = self.rec.root
        for k, v in kernels.launch_counts().items():
            if v != self.launches.get(k, 0):
                root.counters["launches." + k] = v - self.launches.get(k, 0)
        if exc_type is not None:
            root.tags["failed"] = True
        self.ctx.__exit__(exc_type, *exc)
        _local.rec = self.prev
        with _lock:
            _live -= 1
            subs = list(_subscribers)
        for fn in subs:
            fn(self.rec)
        return False


def stitch(names, sizes, **tags):
    """The root span of one stitch of the folder (names, sizes): records
    where something subscribed; `NULL` else."""
    if not _subscribers:
        return NULL
    return _Root(names, sizes, tags)


def busy_ns(segments: np.ndarray, a: int, b: int) -> int:
    """Device-busy ns inside [a, b] of sorted, disjoint (S, 2) intervals."""
    i = int(np.searchsorted(segments[:, 1], a, "right"))
    j = int(np.searchsorted(segments[:, 0], b, "left"))
    if j <= i:
        return 0
    s = np.clip(segments[i:j, 0], a, b)
    e = np.clip(segments[i:j, 1], a, b)
    return int((e - s).sum())


def merge_intervals(iv) -> np.ndarray:
    """The union of (start, end) intervals: sorted, disjoint (S, 2) int64."""
    iv = np.asarray(sorted((int(s), int(e)) for s, e in iv if e > s), np.int64).reshape(-1, 2)
    if len(iv) == 0:
        return iv
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    ends = reach[np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]]
    return np.stack([iv[new, 0], ends], 1)


def is_sync(name: str) -> bool:
    """A host runtime call that waits for the device (`SYNCS`, with or
    without a `_v<n>` version suffix)."""
    return re.sub(r"_v\d+$", "", name) in SYNCS


def summary(records: List[Stitch], busy: Optional[np.ndarray] = None,
            syncs: Optional[np.ndarray] = None) -> List[list]:
    """For each span name over the records: [name, count, total s, self s,
    device idle s inside, syncs inside], largest total first. The idle time
    is None without `busy`, the device's merged busy intervals in ns; the
    syncs None without `syncs`, the sorted start ns of the host's calls
    that wait for the device."""
    rows: Dict[str, list] = {}
    for rec in records:
        kids: Dict[int, list] = {}
        for sp in rec.spans:
            kids.setdefault(sp.parent, []).append((sp.start_ns, sp.end_ns))
        for sp in rec.spans:
            dur = sp.end_ns - sp.start_ns
            covered = merge_intervals(kids.get(sp.id, ()))
            child = int((np.clip(covered[:, 1], sp.start_ns, sp.end_ns)
                         - np.clip(covered[:, 0], sp.start_ns, sp.end_ns)).sum())
            row = rows.setdefault(sp.name, [sp.name, 0, 0.0, 0.0, 0.0, 0])
            row[1] += 1
            row[2] += dur * 1e-9
            row[3] += (dur - child) * 1e-9
            if busy is not None:
                row[4] += (dur - busy_ns(busy, sp.start_ns, sp.end_ns)) * 1e-9
            if syncs is not None:
                row[5] += int(np.searchsorted(syncs, sp.end_ns, "right")
                              - np.searchsorted(syncs, sp.start_ns, "left"))
    out = sorted(rows.values(), key=lambda r: -r[2])
    for r in out:
        r[4] = None if busy is None else r[4]
        r[5] = None if syncs is None else r[5]
    return out


def format_table(rows: List[list]) -> str:
    lines = [f"{'span':<28} {'count':>6} {'total_s':>10} {'self_s':>10} {'idle_s':>10} "
             f"{'syncs':>6}"]
    for name, n, tot, own, idle, syncs in rows:
        idle_s = "-" if idle is None else f"{idle:10.4f}"
        lines.append(f"{name:<28} {n:>6} {tot:>10.4f} {own:>10.4f} {idle_s:>10} "
                     f"{'-' if syncs is None else syncs:>6}")
    return "\n".join(lines)


def format_counters(records: List[Stitch]) -> str:
    """One line for each stitch: its id, its folder and its counters,
    summed over its spans."""
    return "\n".join(f"counters of stitch {rec.id} ({rec.folder}): " + " ".join(
        f"{k}={v:g}" for k, v in sorted(rec.counters.items())) for rec in records)
