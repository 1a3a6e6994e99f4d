"""Reading a `torch.profiler` trace of the measured window.

The harness profiles the window with CPU and CUDA activities, marks the
window itself with the annotation `WINDOW` and each pipeline stage with
`STAGE_PREFIX + name` (from its stage timer). This module reads the raw
Kineto events (not `key_averages`, which builds a tree of every event and is
slow on a long window): the device's kernels, copies and sets, the host's
operators and runtime calls, and those annotations.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

WINDOW = "bench:window"
STAGE_PREFIX = "stage:"
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_KINDS = {"cpu_op", "cuda_runtime", "cuda_driver"}


def start(cuda: bool) -> None:
    """Start recording host and (with `cuda`) device activity. The raw
    recorder of `torch.profiler`, without its parse of every event into a
    tree at the end, which takes minutes on a long window."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                _enable_profiler, _prepare_profiler)

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)


def stop() -> list:
    """Stop recording; the Kineto events."""
    from torch.autograd import _disable_profiler

    return _disable_profiler().events()


def _kind(e) -> str:
    """An event's Kineto activity type; where this PyTorch's events lack
    `activity_type` (2.11 has none), from the device and the name: the
    harness's own annotations by name, host events as operators, device
    events as operations."""
    at = getattr(e, "activity_type", None)
    name = e.name()
    on_host = str(e.device_type()).endswith("CPU")
    if name == WINDOW or name.startswith(STAGE_PREFIX):
        return "user_annotation" if on_host else "gpu_user_annotation"
    if at is not None:
        return at()
    ann = getattr(e, "is_user_annotation", None)
    if ann is not None and ann():
        return "user_annotation" if on_host else "gpu_user_annotation"
    return "cpu_op" if on_host else "kernel"


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without its leading `void` and its
    parameter list, at most `width` characters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


def kernel_id(name: str) -> str:
    """A kernel's bare identifier: its name without `void`, namespaces,
    template arguments and parameters (`knn_kernel<4, 128>(PooledArgs)` ->
    `knn_kernel`)."""
    return short_name(name, len(name)).split("<", 1)[0].rsplit("::", 1)[-1].strip()


class Trace:
    """The device's busy time, its operations and its idle gaps in a window."""

    def __init__(self, events):
        dev: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        stages: List[Tuple[int, int, str]] = []
        window = None
        t_min, t_max = None, None
        for e in events:
            kind = _kind(e)
            s, t = e.start_ns(), e.end_ns()
            if kind in DEVICE_KINDS:
                dev.append((s, t, e.name()))
            elif kind in HOST_KINDS:
                host.append((s, t, e.name()))
            elif kind == "user_annotation":
                name = e.name()
                if name == WINDOW:
                    window = (s, t)
                elif name.startswith(STAGE_PREFIX):
                    stages.append((s, t, name[len(STAGE_PREFIX):]))
            t_min = s if t_min is None else min(t_min, s)
            t_max = t if t_max is None else max(t_max, t)
        self.t0, self.t1 = window if window is not None else (t_min or 0, t_max or 0)
        dev.sort()
        self.dev_start = np.array([d[0] for d in dev], np.int64)
        self.dev_end = np.array([d[1] for d in dev], np.int64)
        self.dev_name = [d[2] for d in dev]
        host.sort()
        self.host_start = np.array([h[0] for h in host], np.int64)
        self.host_end = np.array([h[1] for h in host], np.int64)
        self.host_name = [h[2] for h in host]
        stages.sort()
        self.stage_start = np.array([s[0] for s in stages], np.int64)
        self.stage_end = np.array([s[1] for s in stages], np.int64)
        self.stage_name = [s[2] for s in stages]
        self.segments = self._merge()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def _merge(self) -> np.ndarray:
        """The union of device intervals inside the window: (S, 2) ns."""
        s = np.clip(self.dev_start, self.t0, self.t1)
        e = np.clip(self.dev_end, self.t0, self.t1)
        keep = e > s
        s, e = s[keep], e[keep]
        if len(s) == 0:
            return np.zeros((0, 2), np.int64)
        reach = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        ends = reach[np.r_[np.nonzero(new)[0][1:] - 1, len(s) - 1]]
        return np.stack([starts, ends], 1)

    @property
    def busy_s(self) -> float:
        return float((self.segments[:, 1] - self.segments[:, 0]).sum()) * 1e-9

    def device_seconds(self, pick: Callable[[str], bool]) -> float:
        """Summed duration of the device operations whose name `pick` takes,
        clipped to the window."""
        s = np.clip(self.dev_start, self.t0, self.t1)
        e = np.clip(self.dev_end, self.t0, self.t1)
        mask = np.array([pick(n) for n in self.dev_name], bool)
        return float(np.clip(e - s, 0, None)[mask].sum()) * 1e-9 if len(mask) else 0.0

    def top_ops(self, n: int = 10) -> List[list]:
        """The n device operations that took most time, by name: [[name, s]]."""
        s = np.clip(self.dev_start, self.t0, self.t1)
        e = np.clip(self.dev_end, self.t0, self.t1)
        tot: Dict[str, float] = defaultdict(float)
        for name, d in zip(self.dev_name, (e - s).tolist()):
            if d > 0:
                tot[short_name(name)] += d * 1e-9
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def _label(self, t: int) -> str:
        """What the host was doing at time t: the pipeline stage and the
        innermost host operation or runtime call that covers t."""
        stage = "outside stages"
        k = int(np.searchsorted(self.stage_start, t, "right")) - 1
        if k >= 0 and self.stage_end[k] >= t:
            stage = self.stage_name[k]
        op = "python"
        i = int(np.searchsorted(self.host_start, t, "right")) - 1
        for j in range(i, max(i - 256, -1), -1):
            if self.host_end[j] >= t:
                op = self.host_name[j]
                break
        return f"{stage} / {op}"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window summed by what the host was
        doing at each gap's middle; the n largest: [[label, s]]."""
        seg = self.segments
        if len(seg) == 0:
            return [["no device operation", self.window_s]]
        starts = np.r_[self.t0, seg[:, 1]]
        ends = np.r_[seg[:, 0], self.t1]
        tot: Dict[str, float] = defaultdict(float)
        for s, e in zip(starts.tolist(), ends.tolist()):
            if e > s:
                tot[self._label((s + e) // 2)] += (e - s) * 1e-9
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
