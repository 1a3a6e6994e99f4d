"""Logging and device instrumentation of the CLI (port of the JAX package's
`utils/timing.py`).

- `Tee`: stdout duplicated to a log file (the reference's `diary log.txt`).
- `device_profile`: a `torch.profiler` trace of the block (CPU and, on a
  card, CUDA activity) written as a Chrome trace, where the reference takes
  a `jax.profiler` trace, and the tracer's table of the stitches in it
  (`utils/trace.py`).
- `report_device_memory`: the card's memory in use, the peak since the
  process began (or the last reset) and its capacity.
- `graph_ms`, `launch_floor_ms`: a call's device time from a CUDA graph of
  back-to-back calls, and an empty kernel's (the launch floor), for
  `chip_smoke.py`.

The per-stage timer is `models/pipeline.StageTimer`, on the tracer's stage
spans: on a card a stage's seconds are the stream time between CUDA events
recorded where it starts and ends, so it adds no synchronize.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Optional, TextIO

import numpy as np
import torch

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.txt"


@contextlib.contextmanager
def device_profile(trace_dir: Optional[str]):
    """Capture a `torch.profiler` trace of the block into
    trace_dir/trace.json (view with Perfetto or chrome://tracing; the
    tracer's spans show as `apst:` ranges), and print the tracer's table of
    the stitches in the block (`trace.summary`: each span's count, total,
    self time and, on a card, the device's idle time and the host's waits
    for the device inside it), then each stitch's counters
    (`trace.format_counters`), also written to trace_dir/spans.txt. No-op
    when trace_dir is None, the zero-cost default.

    >>> with device_profile("trace"):
    ...     result = pipeline.stitch(...)
    """
    if not trace_dir:
        yield
        return
    from torch import profiler

    from autopanostitch_tpu_torch.utils import trace

    acts = [profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    records: list = []
    undo = trace.subscribe(records.append)
    try:
        with profiler.profile(activities=acts) as prof:
            yield
    finally:
        undo()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    busy = syncs = None
    if cuda:
        events = prof.profiler.kineto_results.events()
        # the device's kernels, copies and sets (not the ranges' device rows)
        busy = trace.merge_intervals(
            (e.start_ns(), e.end_ns()) for e in events
            if not str(e.device_type()).endswith("CPU") and not e.is_user_annotation())
        syncs = np.sort(np.array([e.start_ns() for e in events if trace.is_sync(e.name())],
                                 np.int64))
    text = (trace.format_table(trace.summary(records, busy, syncs)) + "\n"
            + trace.format_counters(records))
    with open(os.path.join(trace_dir, SPANS_FILE), "w") as f:
        f.write(text + "\n")
    print(text)


class Tee:
    """Duplicate stdout to a log file (the reference's `diary log.txt`)."""

    def __init__(self, path: str):
        self.file = open(path, "a")
        self.stdout = sys.stdout

    def write(self, data):
        self.file.write(data)
        self.stdout.write(data)

    def flush(self):
        self.file.flush()
        self.stdout.flush()

    def close(self):
        sys.stdout = self.stdout
        self.file.close()

    def __enter__(self):
        sys.stdout = self
        return self

    def __exit__(self, *a):
        self.close()


def report_device_memory(out: Optional[TextIO] = None, device=None) -> Optional[Dict[str, float]]:
    """Print and return the card's memory in MB: allocated by tensors now,
    the peak allocation (`torch.cuda.max_memory_allocated`) and the card's
    capacity (`torch.cuda.mem_get_info`) (the reference's
    `utils/reportGPUMemory.m`). None without CUDA."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda") if device is None else torch.device(device)
    free, total = torch.cuda.mem_get_info(dev)
    used = torch.cuda.memory_allocated(dev) / 1e6
    peak = torch.cuda.max_memory_allocated(dev) / 1e6
    limit = total / 1e6
    print(f"Device memory: {used:.0f} / {limit:.0f} MB in use, peak {peak:.0f} MB, "
          f"{free / 1e6:.0f} MB free", file=out or sys.stdout)
    return {"used_mb": used, "limit_mb": limit, "peak_mb": peak}


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call of fn on the current CUDA device, ms: a CUDA
    graph holding n back-to-back calls (captured after a warm-up on the
    capture stream), replayed once to warm and then `reps` times between
    CUDA events; the median replay over n. No host work of fn runs in a
    replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[len(times) // 2]


def launch_floor_ms(n: int = 20) -> float:
    """`graph_ms` of an empty kernel (`apst_noop` of the port's kernel
    library): what a graph's kernel node costs with no work, ms."""
    from autopanostitch_tpu_torch.kernels import _build

    lib = _build.library()
    return graph_ms(lambda: _build.check(lib.apst_noop(torch.cuda.current_stream().cuda_stream),
                                         "apst_noop"), n)
