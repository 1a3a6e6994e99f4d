"""The tracer on a card (`cuda` tests; they skip without one, and import
neither JAX nor the JAX package, so they run on a machine without them:
`python -m pytest --noconftest -m cuda tests/test_torch_trace_card.py`).

- The tracer's stamps and the profiler's events lie on one clock: a span's
  start and its `apst:` range's start within 100 us.
- A stage timed on the card reads the stream time between its events, with
  no synchronize: the host leaves the stage long before the card ends it.
"""

import time

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_stamps_share_the_profilers_clock(card):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1024, 1024, device=card)
    names, sizes = ["a"], np.array([[4, 4]], np.int32)
    undo = trace.subscribe(lambda rec: None)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with trace.stitch(names, sizes) as rec:
                for _ in range(6):
                    with trace.span("probe"):
                        (x @ x).sum().item()
                        time.sleep(0.001)
    finally:
        undo()
    events = prof.profiler.kineto_results.events()
    host = sorted(e.start_ns() for e in events
                  if e.name() == trace.PREFIX + "probe" and str(e.device_type()).endswith("CPU"))
    on_card = [e for e in events
               if e.name() == trace.PREFIX + "probe" and not str(e.device_type()).endswith("CPU")]
    mine = sorted(s.start_ns for s in rec.spans if s.name == "probe")
    assert len(host) == len(mine) == 6
    assert on_card and all(e.is_user_annotation() for e in on_card)
    # the first range of a process pays the profiler's set-up
    assert max(abs(a - b) for a, b in zip(host[1:], mine[1:])) < 100_000


def test_stage_timer_reads_the_stream(card, monkeypatch):
    def work(x):
        for _ in range(20):
            x = x @ x
            x = x / x.norm()
        return x

    x = torch.randn(4096, 4096, device=card)
    work(x).sum().item()  # the kernels loaded, the library's handles and workspaces made
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    timer = tpipe.StageTimer(card)
    t0 = time.perf_counter()
    with timer.stage("work"):
        work(x)
    host_s = time.perf_counter() - t0
    device_s = timer.report()["work"]
    print(f"host {host_s:.6f} s, stream {device_s:.6f} s")
    assert calls == []
    assert device_s > 2 * host_s  # the host enqueued; the card's stream took the time
