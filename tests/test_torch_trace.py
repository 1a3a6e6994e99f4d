"""The port's tracer (`autopanostitch_tpu_torch/utils/trace.py`) on the CPU:
nothing recorded where nothing listens, the span tree, the folder tag and
the counters of small `parity_scenes` stitches, the stage timer without
a synchronize, one clock with the profiler's events, and the tally of
kernel launches."""

import time

import numpy as np
import pytest
import torch

import parity_scenes
from autopanostitch_tpu_torch import device as device_mod
from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.utils import trace
from test_torch_pipeline import one_torch_thread  # noqa: F401

STAGES = {"features", "matching", "ransac", "pairwise_rescue", "second_pass",
          "bundle_adjustment", "bundle_adjustment_h", "gain", "render"}


@pytest.fixture(scope="module")
def runs():
    """config1 stitched untraced (counting the spans opened), twice with a
    subscriber, and config4 once with a subscriber."""
    pair, pair_cfg = parity_scenes.config1_planar_pair()
    multi, multi_cfg = parity_scenes.config4_multipano()
    opened = []
    ctx = trace._SpanCtx

    class Counting(ctx):
        __slots__ = ()

        def __enter__(self):
            opened.append(self.name)
            return super().__enter__()

    trace._SpanCtx = Counting
    try:
        tpipe.stitch(pair, pair_cfg, seed=0, device="cpu")
        untraced = list(opened)
        records = []
        undo = trace.subscribe(records.append)
        try:
            res_a = tpipe.stitch(pair, pair_cfg, seed=0, device="cpu")
            res_b = tpipe.stitch(pair, pair_cfg, seed=1, device="cpu")
            res_c = tpipe.stitch(multi, multi_cfg, seed=0, device="cpu")
        finally:
            undo()
    finally:
        trace._SpanCtx = ctx
    return {"untraced": untraced, "records": records, "results": (res_a, res_b, res_c),
            "cfg": pair_cfg}


def test_untraced_stitch_records_nothing(runs):
    assert runs["untraced"] == []
    assert trace._live == 0
    assert trace.span("features") is trace.NULL
    assert trace.stitch(["a"], np.zeros((1, 2), np.int32)) is trace.NULL
    trace.count("ransac.pairs", 3)  # nothing open: a no-op


def test_span_tree(runs):
    recs = runs["records"]
    assert len(recs) == 3
    for rec in recs:
        root = rec.root
        assert root.name == "stitch" and root.parent is None and root.id == rec.id
        assert [s.name for s in rec.spans].count("stitch") == 1
        assert all(s.stitch == rec.id and s.folder == rec.folder for s in rec.spans)
        by_id = {s.id: s for s in rec.spans}
        for s in rec.spans[1:]:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        stages = [s for s in rec.spans if s.name in STAGES]
        assert {"features", "matching", "ransac", "bundle_adjustment_h", "render"} <= {
            s.name for s in stages}
        assert all(s.parent == root.id for s in stages)
    assert len({rec.id for rec in recs}) == 3


def test_folder_tag(runs):
    a, b, c = runs["records"]
    assert a.folder == b.folder
    assert a.folder != c.folder
    fp, views = a.folder.split(":")
    assert len(fp) == 12 and int(fp, 16) >= 0 and views == "2"
    assert c.folder.endswith(":4")


def test_ransac_counters(runs):
    """Where no second pass ran, the accepted pairs counted are the graph's."""
    (a, _, c), (res_a, _, res_c) = runs["records"], runs["results"]
    assert "second_pass" not in {s.name for s in a.spans}
    cnt = a.counters
    assert cnt["ransac.accepted"] == int(res_a.graph.accepted.sum())
    assert cnt["ransac.pairs"] == len(res_a.graph.pairs)
    assert cnt["ransac.trials"] > 0
    # config4's two components each take a second pass, whose verifications count too
    assert c.counters["second_pass.runs"] == 2
    assert c.counters["ransac.pairs"] > len(res_c.graph.pairs)


def test_lm_iterations_planar(runs):
    """The planar path runs the homography loop alone, max_iter_lm times."""
    a = runs["records"][0]
    assert a.counters["ba.lm_iterations"] == runs["cfg"].bundle.max_iter_lm
    assert a.counters["ba.phases"] == 1
    assert a.counters["render.bands"] >= 1
    assert {"ba_h.chain", "ba_h.upload", "ba_h.lm", "ba_h.readback", "render.band"} <= {
        s.name for s in a.spans}


def test_stage_timer_adds_no_synchronize(monkeypatch):
    iset, cfg = parity_scenes.config1_planar_pair()
    calls = []
    monkeypatch.setattr(device_mod, "synchronize", lambda dev: calls.append(dev))
    timer = tpipe.StageTimer("cpu")
    tpipe.stitch(iset, cfg, seed=0, device="cpu", timer=timer)
    assert calls == []
    rep = timer.report()
    assert {"features", "bundle_adjustment_h", "render"} <= set(rep)
    assert all(v > 0 for v in rep.values())
    assert [n for n, _ in timer.durations] == [s.name for s in timer.spans]


def test_summary_self_and_idle():
    """The table's self time leaves out the children; its idle time what the
    device's busy intervals cover."""
    rec = trace.Stitch(1, "f:1")
    spans = [("stitch", 1, None, 0, 100), ("render", 2, 1, 10, 60), ("render.batch", 3, 2, 20, 30),
             ("render.batch", 4, 2, 40, 50)]
    for name, sid, parent, s, e in spans:
        sp = trace.Span(name, sid, parent, 1, "f:1", {})
        sp.start_ns, sp.end_ns = s, e
        rec.spans.append(sp)
    busy = trace.merge_intervals([(25, 45), (0, 5), (40, 42)])
    rows = {r[0]: r for r in trace.summary([rec], busy)}
    assert rows["render"][1:4] == [1, pytest.approx(50e-9), pytest.approx(30e-9)]
    assert rows["render"][5] is None
    assert rows["render.batch"][1] == 2
    assert rows["render"][4] == pytest.approx(30e-9)  # 50 less [25, 45]
    assert rows["stitch"][4] == pytest.approx(75e-9)  # 100 less [0, 5] and [25, 45]
    assert "render.batch" in trace.format_table(list(rows.values()))


def test_summary_syncs_and_counters():
    """The table counts the waits inside each span (its children's too),
    and `format_counters` gives each stitch's counters on one line."""
    rec = trace.Stitch(1, "f:1")
    for name, sid, parent, s, e in [("stitch", 1, None, 0, 100), ("ransac", 2, 1, 10, 60),
                                    ("ransac.readback", 3, 2, 40, 60)]:
        sp = trace.Span(name, sid, parent, 1, "f:1", {})
        sp.start_ns, sp.end_ns = s, e
        rec.spans.append(sp)
    rec.spans[2].counters["ransac.pairs"] = 4
    rec.spans[0].counters["launches.knn"] = 2
    syncs = np.array([15, 45, 70, 120], np.int64)
    rows = {r[0]: r for r in trace.summary([rec], syncs=syncs)}
    assert (rows["stitch"][5], rows["ransac"][5], rows["ransac.readback"][5]) == (3, 2, 1)
    assert rows["ransac"][4] is None
    assert trace.summary([rec])[0][5] is None
    assert trace.format_counters([rec]) == (
        "counters of stitch 1 (f:1): launches.knn=2 ransac.pairs=4")
    assert trace.is_sync("cudaStreamSynchronize") and trace.is_sync("cudaMemcpy_v2")
    assert not trace.is_sync("cudaMemcpyAsync")


def test_launch_tally_reaches_the_stitch():
    """Launches added to the tally inside a recorded stitch are its root's
    `launches.<name>` counters; launches outside any stitch, and those
    recorded into a graph being captured, are not; a reset zeroes the tally
    and keeps every kernel's name."""
    records = []
    undo = trace.subscribe(records.append)
    try:
        trace.launched("knn")
        with trace.stitch(["a", "b"], np.array([[4, 4], [4, 4]], np.int32)):
            with trace.span("matching"):
                trace.launched("knn", 2)
                trace.launched("ba_system", captured=True)
            trace.launched("render_sample")
        trace.launched("knn")
    finally:
        undo()
    assert {k: v for k, v in records[0].root.counters.items() if k.startswith("launches.")} == {
        "launches.knn": 2, "launches.render_sample": 1}
    assert records[0].spans[1].counters == {}
    assert trace.launch_counts()["knn"] >= 4
    assert trace.launch_counts(captured=True)["ba_system"] >= 1
    trace.reset_launch_counts()
    counts = trace.launch_counts()
    assert {"knn", "render_sample"} <= set(counts) and not any(counts.values())
    assert trace.launch_counts(captured=True) == {}


def test_stamps_share_the_profilers_clock():
    """A span's start and its `apst:` range's start in the profiler's events
    lie within 1 ms: one clock."""
    from torch.profiler import ProfilerActivity, profile

    names, sizes = ["a", "b"], np.array([[4, 4], [4, 4]], np.int32)
    undo = trace.subscribe(lambda rec: None)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.stitch(names, sizes) as rec:
                for _ in range(3):
                    with trace.span("probe"):
                        torch.ones(8).sum()
                        time.sleep(0.001)
    finally:
        undo()
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == trace.PREFIX + "probe")
    mine = sorted(s.start_ns for s in rec.spans if s.name == "probe")
    assert len(starts) == len(mine) == 3
    assert max(abs(a - b) for a, b in zip(starts, mine)) < 1_000_000


def test_render_slot_counters():
    """`render_tile_list` counts, for each launch, its tiles' C slots
    (`render.slots`) and those that hold an image (`render.slots_live`, the
    true entries of `sel_ok`); nothing records where nothing listens."""
    from autopanostitch_tpu_torch.models import render as trender

    n, h, w, f = 3, 48, 64, 60.0
    rng = np.random.default_rng(0)
    imgs = torch.as_tensor(rng.uniform(size=(n, h, w, 3)), dtype=torch.float32)
    feathers = torch.ones((n, h, w))
    c, s = np.cos(0.6 * np.arange(n)), np.sin(0.6 * np.arange(n))
    R = np.zeros((n, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1], R[:, 2, 0], R[:, 2, 2] = c, -s, 1, s, c
    K = np.tile(np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]], np.float32),
                (n, 1, 1))
    sizes = np.array([[h, w]] * n, np.int32)
    canvas = trender.compute_canvas(R, K, sizes, "spherical")
    tile = (16, 32)
    sel, ok, origins = trender.tile_contributors(canvas, R, K, sizes, tile)
    T, C = sel.shape
    assert 0 < ok.sum() < T * C
    args = (imgs, feathers, R, K, np.ones((n, 3), np.float32), None, sel, ok, origins, canvas,
            tile, "linear", 3, 1.0, "bilinear", 3)
    assert trace.stitch(["a", "b", "c"], sizes) is trace.NULL
    trender.render_tile_list(*args)  # nothing listens
    records = []
    undo = trace.subscribe(records.append)
    try:
        with trace.stitch(["a", "b", "c"], sizes):
            trender.render_tile_list(*args)
    finally:
        undo()
    (rec,) = records
    cnt = rec.counters
    assert cnt["render.tiles"] == T
    assert cnt["render.tile_batches"] == -(-T // 3)
    assert cnt["render.slots"] == T * C
    assert cnt["render.slots_live"] == int(ok.sum())


def test_gain_chunk_counter():
    """`overlap_statistics_imagespace` counts its grid chunks (`gain.chunks`,
    read by `cli --profile`)."""
    from autopanostitch_tpu_torch.models import gain as tgain

    n, h, w = 3, 30, 40
    imgs = torch.rand((n, h, w, 3))
    K = torch.tensor([[50.0, 0, 19.5], [0, 50.0, 14.5], [0, 0, 1]]).expand(n, 3, 3)
    R = torch.eye(3).expand(n, 3, 3)
    sizes = torch.tensor([[h, w]] * n, dtype=torch.int32)
    records = []
    undo = trace.subscribe(records.append)
    try:
        with trace.stitch(["a", "b", "c"], sizes.numpy()):
            tgain.overlap_statistics_imagespace(imgs, torch.ones((n, h, w)), sizes, R, K, 3,
                                                max_elems=9 * 25)
    finally:
        undo()
    points = 10 * 14  # the stride-3 grid of a 30 x 40 image
    assert records[0].counters["gain.chunks"] == -(-points // 25)
