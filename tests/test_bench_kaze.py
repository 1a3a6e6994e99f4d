"""KAZE's spans and counters (`ops/kaze.py`, `ops/doh.py`), the benchmark's
readers of them (`metrics/kaze_roofline.py`, `metrics/idle_s.kaze.py`,
`work_kaze.py`), and the files of the `kaze800.ring38` and
`rot800.pano100` cells: the configuration pinned as `rot800` with KAZE,
the 100-view ring's traffic, and a small KAZE ring through
`harness.run_cell` on the CPU, traced."""

import copy
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.config import DetectorConfig
from autopanostitch_tpu_torch.ops import kaze
from autopanostitch_tpu_torch.utils import trace
from pano_bench import harness, kaze_reference, scenes, spans, spec, work, work_kaze

BENCH = spec.load_benchmark()
CELL, PANO = "kaze800.ring38", "rot800.pano100"
SPANS = ("kaze.contrast", "kaze.scale_space", "kaze.detect", "doh.detect", "doh.window")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _recorded(fn):
    """What one stitch's root span records around fn()."""
    got = []
    undo = trace.subscribe(got.append)
    try:
        with trace.stitch(["a"], np.array([[4, 4]], np.int32)):
            fn()
    finally:
        undo()
    (rec,) = got
    return rec


@pytest.mark.parametrize("views,groups", [(8, 1), (10, 2)])
def test_kaze_spans_and_counters(views, groups):
    """One of each KAZE span a group of 8 images, the DoH spans beneath
    kaze.detect, and 11 FED cycles of 137 steps a group at sigma = 1.6."""
    imgs = torch.rand(views, 48, 64, generator=torch.Generator().manual_seed(3))
    cfg = DetectorConfig(detector="KAZE", max_keypoints=64)
    rec = _recorded(lambda: kaze.extract_kaze_batch(imgs, cfg))
    names = [s.name for s in rec.spans]
    for name in SPANS:
        assert names.count(name) == groups, (name, names)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name in ("doh.detect", "doh.window"):
            assert by_id[s.parent].name == "kaze.detect"
        if s.name.startswith("kaze."):
            assert by_id[s.parent].name == "stitch"
    c = rec.counters
    assert (c["kaze.groups"], c["kaze.fed_cycles"], c["kaze.fed_steps"]) == (
        groups, 11 * groups, 137 * groups)
    assert work_kaze.fed_counts(kaze_reference.sigmas()) == (11, 137)


def test_work_kaze_is_a_hand_count():
    """A (2, 16, 24) group over the 8-level ladder: a pixel takes the base
    blur (11 taps an axis: 44), 11 conductivities (7-tap blur 28, gradient
    4, g 6: 38 each) and 137 steps of 22; the group is read once and its 8
    levels written once."""
    sig = kaze_reference.sigmas()
    px = 2 * 16 * 24
    assert work_kaze.scale_space_ops((2, 16, 24), sig) == px * (44 + 11 * 38 + 137 * 22)
    assert work_kaze.scale_space_ops((2, 16, 24), sig) == 2_669_568
    assert work_kaze.scale_space_bytes((2, 16, 24), sig) == 4 * px * 9 == 27_648
    peaks = work.PEAKS[H100]
    bound = work_kaze.scale_space_bound_s((8, 600, 800), sig, peaks["fp32_flop_s"],
                                          peaks["hbm_byte_s"])
    assert bound == pytest.approx(8 * 600 * 800 * 3476 / 67e12)  # operations bound it


class _Event:
    """A stand-in for a CUDA event pair's reading."""

    def __init__(self, ms=0.0):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _ctx(store=None, trace_=None, kind=H100):
    return SimpleNamespace(store=store or {}, trace=trace_, device_kind=kind)


def test_kaze_roofline_reads_the_events():
    """100 x the summed bounds over the summed event times; None without a
    call, or on a card not in the table of peaks."""
    read = spec.metric_module("kaze_roofline").read
    sig = kaze_reference.sigmas()
    calls = [((8, 600, 800), sig, _Event(0.0), _Event(80.0)),
             ((6, 600, 800), sig, _Event(100.0), _Event(160.0))]
    peaks = work.PEAKS[H100]
    bound = sum(work_kaze.scale_space_bound_s(c[0], sig, peaks["fp32_flop_s"],
                                              peaks["hbm_byte_s"]) for c in calls)
    assert read(_ctx({"kaze_calls": calls})) == pytest.approx(100.0 * bound / 0.140)
    assert 0 < read(_ctx({"kaze_calls": calls})) < 100
    assert read(_ctx({"kaze_calls": calls}, kind="cpu")) is None
    assert read(_ctx()) is None
    assert read(_ctx({"kaze_calls": []})) is None


def test_kaze_roofline_records_no_cpu_call():
    """The reader's hook passes a CPU call through and records nothing, and
    its undo restores the program's function."""
    mod = spec.metric_module("kaze_roofline")
    store = {}
    fn = kaze.nonlinear_scale_space
    undo = mod.install(store)
    try:
        out = kaze.nonlinear_scale_space(torch.rand(1, 24, 32), kaze_reference.sigmas()[:3])
    finally:
        undo()
    assert out.shape == (1, 3, 24, 32) and store["kaze_calls"] == []
    assert kaze.nonlinear_scale_space is fn


MS = 1_000_000


def test_idle_s_kaze():
    """Idle ns inside the kept kaze.scale_space spans over the kept stitches;
    None where no stitch has one."""
    read = spec.metric_module("idle_s.kaze").read
    seg = np.array([[2 * MS, 5 * MS], [12 * MS, 20 * MS]], np.int64)
    tr = SimpleNamespace(segments=seg)
    k1 = spans.Kept((0, 30 * MS), [("features", 0, 25 * MS), ("kaze.scale_space", 0, 10 * MS),
                                   ("kaze.scale_space", 11 * MS, 21 * MS)], {})
    k2 = spans.Kept((40 * MS, 50 * MS), [("features", 40 * MS, 45 * MS)], {})
    # 7 ms idle in [0, 10], 2 ms in [11, 21]; over 2 stitches
    assert read(_ctx({spans.KEY: [k1, k2]}, tr)) == pytest.approx(4.5e-3)
    assert read(_ctx({spans.KEY: [k2]}, tr)) is None
    assert read(_ctx({spans.KEY: [k1]}, None)) is None
    assert read(_ctx()) is None


def test_metric_entries():
    """Both metrics list only the KAZE cell, on the layer ops/kaze, and
    their readers say so."""
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ("kaze_roofline", "idle_s.kaze"):
        m, mod = entries[name], spec.metric_module(name)
        assert m["workloads"] == [CELL] and m["moves"] == "stitch_s"
        assert (m["unit"], m["layer"], m["moves"]) == (mod.UNIT, mod.LAYER, mod.MOVES)
        assert name in [e["name"] for e in spec.per_layer(BENCH, CELL)]
        assert name not in [e["name"] for e in spec.per_layer(BENCH, PANO)]


def test_kaze800_is_rot800_with_kaze():
    """kaze800 pins every StitchConfig field and differs from rot800 only
    in detector.detector; nothing reduced."""
    cfg = spec.config_file(BENCH, "kaze800")
    log = io.StringIO()
    assert spec.stitch_config(cfg, log=log).detector.detector == "KAZE"
    assert log.getvalue() == ""
    rot = spec.config_file(BENCH, "rot800")
    a = copy.deepcopy(cfg["stitch_config"])
    a["detector"]["detector"] = "SIFT"
    assert a == rot["stitch_config"]
    assert cfg["reduced"] == [] and all(k in cfg["assumed"] for k in (
        "kaze.ladder", "kaze.fed", "kaze.contrast", "kaze.selection", "kaze.descriptor",
        "kaze.groups"))
    entry = next(c for c in BENCH["configs"] if c["name"] == "kaze800")
    assert entry["file"] == "pano_bench/configs/kaze800.json" and entry["reduced"] == []
    assert entry["source"] == cfg["source"] and len(entry["source"]) <= 200


def test_cells_load():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert (cells[CELL]["config"], cells[CELL]["traffic"], cells[CELL]["chips"]) == (
        "kaze800", "ring38", 1)
    assert (cells[PANO]["config"], cells[PANO]["traffic"], cells[PANO]["chips"]) == (
        "rot800", "pano100", 1)
    for name in (CELL, PANO):
        checks = spec.limits(name)["checks"]
        assert set(checks) == set(spec.limits("rot800.ring38")["checks"])
        assert [m["name"] for m in spec.end_to_end(BENCH, name)] == [
            "stitch_s", "stitch_p90_s", "setup_s"]
    pano = spec.traffic("pano100")
    assert {k: pano[k] for k in ("kind", "views", "rings", "distractors", "width", "height",
                                 "focal_px", "env", "cutoff", "content_seed", "pool",
                                 "ingest_limit")} == {
        "kind": "rings", "views": 100, "rings": 1, "distractors": 0, "width": 384,
        "height": 288, "focal_px": 350.0, "env": [768, 2048], "cutoff": 0.08,
        "content_seed": 1, "pool": 4, "ingest_limit": None}


def test_pano100_folder_at_a_small_size():
    """scenes/rings.py makes pano100's 100-view ring: every view in one
    ring, evenly spaced in yaw, at the stated focal; the content is fixed."""
    traffic = spec.traffic("pano100")
    traffic.update(width=48, height=36, env=[24, 64])
    folder = scenes.make(traffic, 2**40 + 3, 2, torch.device("cpu"))
    assert folder.iset.images.shape == (100, 36, 48, 3)
    assert folder.iset.images.dtype == np.uint8
    assert folder.truth["views"] == 100 and folder.truth["focal_px"] == 350.0
    (ring,) = folder.truth["rings"]
    assert list(ring["members"]) == list(range(100))
    yaw = np.arctan2(ring["R"][:, 2, 0], ring["R"][:, 2, 2])
    step = np.remainder(np.diff(yaw), 2 * np.pi)
    assert np.abs(step - 2 * np.pi / 100).max() < 1e-9
    again = scenes.make(traffic, 7, 2, torch.device("cpu"))
    assert np.array_equal(again.iset.images, folder.iset.images)


def test_small_kaze_ring_traced():
    """A 12-view KAZE ring of 320x240 through `harness.run_cell`, traced on
    the CPU: correct, and the line carries `idle_s.kaze` (no device work
    on the CPU, so all of the span) and no `kaze_roofline` (no card)."""
    wl = spec.workload(BENCH, CELL)
    traffic = spec.traffic(wl["traffic"])
    traffic.update({"views": 12, "width": 320, "height": 240, "focal_px": 240.0,
                    "env": [512, 1024], "pool": 1})
    config = copy.deepcopy(spec.config_file(BENCH, wl["config"]))
    config["stitch_config"]["detector"].update({"max_keypoints": 512})
    limits = {"members_wrong": {"limit": 0, "better": "lower"},
              "focal_err_pct": {"limit": 0.5, "better": "lower"},
              "rot_err_deg": {"limit": 0.2, "better": "lower"},
              "psnr_db": {"limit": 45.0, "better": "higher"},
              "match_excess": {"limit": 1e-4, "better": "lower"},
              "match_missing": {"limit": 1e-4, "better": "lower"}}
    line = harness.run_cell(BENCH, wl, 2**33 + 5, 0.01, True, "cpu", 0.0, traffic=traffic,
                            config=config, limits={"checks": limits})
    assert line["correct"] and line["failed"] == 0, line["checks"]
    m = line["metrics"]
    assert m["idle_s.kaze"]["value"] > 0 and "kaze_roofline" not in m
    assert m["stage_s.features"]["value"] > 0
    json.dumps(line)
