"""Logging and device instrumentation of the CLI (port of the JAX package's
`utils/timing.py`).

- `Tee`: stdout duplicated to a log file (the reference's `diary log.txt`).
- `device_profile`: a `torch.profiler` trace of the block (CPU and, on a
  card, CUDA activity) written as a Chrome trace, where the reference takes
  a `jax.profiler` trace.
- `report_device_memory`: the card's memory in use, the peak since the
  process began (or the last reset) and its capacity.

The per-stage timer is `models/pipeline.StageTimer`, which ends each stage
with a device synchronize.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Optional, TextIO

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_profile(trace_dir: Optional[str]):
    """Capture a `torch.profiler` trace of the block into
    trace_dir/trace.json (view with Perfetto or chrome://tracing). No-op
    when trace_dir is None, the zero-cost default.

    >>> with device_profile("trace"):
    ...     result = pipeline.stitch(...)
    """
    if not trace_dir:
        yield
        return
    from torch import profiler

    acts = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


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
