"""The benchmark's readers of the program's spans and counters
(`pano_bench/spans.py`, `pano_bench/metrics/idle_s.*`, `host_syncs`,
`ransac_accept_share`, `lm_iterations`) on hand-made stitches and a
hand-made trace, with known answers (times in ms written as ns / 1e6)."""

from types import SimpleNamespace

import numpy as np
import pytest

from pano_bench import spans, spec

MS = 1_000_000


def _trace(busy=(), host=()):
    """A stand-in for `devtrace.Trace`: merged device segments and the
    host's runtime calls, sorted by start."""
    host = sorted(host, key=lambda h: h[1])
    return SimpleNamespace(segments=np.array(sorted((a * MS, b * MS) for a, b in busy),
                                             np.int64).reshape(-1, 2),
                           host_start=np.array([h[1] * MS for h in host], np.int64),
                           host_end=np.array([h[2] * MS for h in host], np.int64),
                           host_name=[h[0] for h in host])


def _kept(root, spans_ms, counters=None):
    return spans.Kept((root[0] * MS, root[1] * MS),
                      [(n, a * MS, b * MS) for n, a, b in spans_ms], counters or {})


def _ctx(kept, trace):
    return SimpleNamespace(store={spans.KEY: kept}, trace=trace)


def _read(name, ctx):
    return spec.metric_module(name).read(ctx)


def test_idle_in_a_stage():
    """A ba span of [0, 10] ms with the device busy over [2, 5] ms reads 7 ms."""
    ctx = _ctx([_kept((0, 12), [("bundle_adjustment", 0, 10)])], _trace([(2, 5)]))
    assert _read("idle_s.ba", ctx) == pytest.approx(7e-3)
    assert _read("idle_s.features", ctx) == 0.0
    assert _read("idle_s.other", ctx) == pytest.approx(2e-3)  # [10, 12]


def test_idle_groups_split_the_root():
    """Seven groups: each stage's idle, the rest of the root under "other",
    a sub-span inside its stage, and all of it a folder (two stitches)."""
    one = [("features", 0, 10), ("upload", 1, 2), ("matching", 10, 14), ("matching.knn", 10, 13),
           ("ransac", 14, 20), ("pairwise_rescue", 20, 21), ("second_pass", 21, 25),
           ("bundle_adjustment_h", 25, 40), ("ba_h.lm", 26, 39), ("gain", 40, 41),
           ("render", 42, 50), ("canvas", 41, 42), ("crop", 50, 52)]
    busy = [(2, 8), (11, 12), (30, 35), (44, 50)]
    k1 = _kept((0, 52), one)
    k2 = _kept((100, 152), [(n, a + 100, b + 100) for n, a, b in one])
    ctx = _ctx([k1, k2], _trace(busy + [(a + 100, b + 100) for a, b in busy]))
    want = {"features": 4, "matching": 3, "ransac": 6, "recognition": 5, "ba": 10,
            "render": 1 + 2, "other": 1 + 2}
    got = {g: _read(f"idle_s.{g}", ctx) for g in want}
    for g, ms in want.items():
        assert got[g] == pytest.approx(ms * 1e-3), g
    # the seven cover the root's idle time exactly
    idle_root = 52 - (6 + 1 + 5 + 6)
    assert sum(got.values()) == pytest.approx(idle_root * 1e-3)


def test_idle_silent_without_spans():
    ctx = SimpleNamespace(store={}, trace=_trace([(0, 1)]))
    assert _read("idle_s.render", ctx) is None
    assert _read("host_syncs", ctx) is None
    assert _read("lm_iterations", ctx) is None
    assert _read("ransac_accept_share", ctx) is None
    assert _read("idle_s.ba", _ctx([_kept((0, 1), [])], None)) is None


def test_host_syncs_inside_roots_only():
    """A cudaStreamSynchronize outside every root span is not counted, nor
    an asynchronous copy; the blocking copy and the event wait are."""
    host = [("cudaStreamSynchronize", 1, 2), ("cudaMemcpyAsync", 3, 4), ("cudaMemcpy", 5, 6),
            ("cudaLaunchKernel", 6, 7), ("cudaStreamSynchronize", 12, 13),
            ("cudaEventSynchronize", 21, 22), ("cudaDeviceSynchronize", 35, 36)]
    ctx = _ctx([_kept((0, 10), []), _kept((20, 30), [])], _trace([], host))
    assert _read("host_syncs", ctx) == pytest.approx(3 / 2)


def test_counter_metrics():
    ctx = _ctx([_kept((0, 1), [], {"ransac.pairs": 10, "ransac.accepted": 7,
                                   "ba.lm_iterations": 40}),
                _kept((2, 3), [], {"ransac.pairs": 10, "ransac.accepted": 9,
                                   "ba.lm_iterations": 44})], None)
    assert _read("ransac_accept_share", ctx) == pytest.approx(80.0)
    assert _read("lm_iterations", ctx) == pytest.approx(42.0)


def test_install_subscribes_once():
    """Every reader shares one subscription: the first install returns the
    undo, later ones None; a stitch then lands in the store."""
    from autopanostitch_tpu_torch.utils import trace

    store = {}
    undo = spec.metric_module("idle_s.ba").install(store)
    assert undo is not None
    assert spec.metric_module("host_syncs").install(store) is None
    try:
        with trace.stitch(["a"], np.array([[4, 4]], np.int32)):
            with trace.span("render"):
                trace.count("render.tiles", 3)
    finally:
        undo()
    (k,) = store[spans.KEY]
    assert [n for n, _, _ in k.spans] == ["render"]
    assert k.counters == {"render.tiles": 3}
    assert k.root[0] <= k.spans[0][1] <= k.spans[0][2] <= k.root[1]


def test_busy_ns_clips_to_the_interval():
    """Busy time inside [a, b] counts only the parts of the segments that
    lie inside it; idle time is the rest."""
    seg = np.array([[0, 10], [20, 30], [40, 50]], np.int64)
    assert spans.busy_ns(seg, 5, 45) == 5 + 10 + 5
    assert spans.busy_ns(seg, 10, 20) == 0
    assert spans.busy_ns(seg, 22, 28) == 6
    assert spans.idle_ns(seg, 5, 45) == 40 - 20
    assert spans.busy_ns(np.zeros((0, 2), np.int64), 0, 10) == 0


def test_idle_other_leaves_out_every_stage():
    """"other" is the root's idle time less that of all stage spans; a
    plain span (`canvas`) and a sub-span (`ba.phase`) do not take from it."""
    ctx = _ctx([_kept((0, 30), [("features", 0, 10), ("canvas", 12, 14),
                                ("bundle_adjustment", 20, 30), ("ba.phase", 21, 29)])],
               _trace([(5, 15)]))
    assert _read("idle_s.features", ctx) == pytest.approx(5e-3)
    assert _read("idle_s.ba", ctx) == pytest.approx(10e-3)
    assert _read("idle_s.other", ctx) == pytest.approx(5e-3)  # [10, 20] less [10, 15]
