"""The approximate pooled matcher's spans and counters
(`ops/matching._approximate_knn`), the benchmark's count of its work
(`work_approx.py`) and readers of it (`metrics/approx_roofline.py`,
`metrics/idle_s.approx.py`), and the files of the `approx800.ring38` cell:
the configuration pinned as `rot800` with `matching.method =
"approximate"`, and a small approximate ring through `harness.run_cell` on
the CPU, traced."""

import copy
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autopanostitch_tpu_torch.ops import matching as mt
from autopanostitch_tpu_torch.utils import trace
from pano_bench import harness, spans, spec, work, work_approx
from pano_bench.tests.small_cells import LIMITS, RING, small_config, small_traffic

BENCH = spec.load_benchmark()
CELL = "approx800.ring38"
H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pool(N, K, D=128, seed=4):
    g = torch.Generator().manual_seed(seed)
    desc = torch.rand(N * K, D, generator=g)
    desc /= desc.norm(dim=1, keepdim=True)
    mask = torch.rand(N * K, generator=g) > 0.2
    ids = torch.arange(N, dtype=torch.int32).repeat_interleave(K)
    return desc, mask, ids


def _recorded(fn):
    """What one stitch's root span records around fn(), and fn's result."""
    got, out = [], []
    undo = trace.subscribe(got.append)
    try:
        with trace.stitch(["a"], np.array([[4, 4]], np.int32)):
            out.append(fn())
    finally:
        undo()
    (rec,) = got
    return rec, out[0]


@pytest.mark.parametrize("N, K, block, k", [
    (5, 64, 128, 4),  # F = 320: blocks of 128, 128 and 64; 32 candidates a row
    (2, 12, 10, 4),  # F = 24 < 8k: blocks of 10, 10 and 4; 24 candidates a row
])
def test_approx_spans_and_counters(N, K, block, k):
    """One `matching.approx` span a call with one `.project` and a `.rank` and
    a `.rerank` a query block beneath it, and the counters from the shapes:
    ceil(F / block) blocks, F rows, F min(8k, F) candidates and the sum of
    b F over the blocks of b rows sorted keys (F^2)."""
    desc, mask, ids = _pool(N, K)
    F = N * K
    rec, _ = _recorded(lambda: mt._approximate_knn(desc, mask, ids, k, block, "float32"))
    names = [s.name for s in rec.spans]
    blocks = -(-F // block)
    assert names.count("matching.approx") == 1 and names.count("matching.approx.project") == 1
    assert names.count("matching.approx.rank") == names.count("matching.approx.rerank") == blocks
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name.startswith("matching.approx."):
            assert by_id[s.parent].name == "matching.approx"
    sizes = [min(block, F - s) for s in range(0, F, block)]
    assert sum(b * F for b in sizes) == F * F
    assert rec.counters == {"matching.approx_blocks": blocks, "matching.approx_rows": F,
                            "matching.approx_candidates": F * min(8 * k, F),
                            "matching.approx_sorted_keys": F * F}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_approx_result_unchanged_by_tracing(compute_dtype):
    """The same neighbours and distances, bit for bit, recorded or not."""
    desc, mask, ids = _pool(5, 64)
    plain = mt.global_knn(desc, mask, ids, k=4, method="approximate", block=128,
                          compute_dtype=compute_dtype)
    _, traced = _recorded(lambda: mt.global_knn(desc, mask, ids, k=4, method="approximate",
                                                block=128, compute_dtype=compute_dtype))
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_work_approx_is_a_brute_force_count():
    """Flops against a loop over every (query, target) pair: 2 m for each
    valid cross-image pair, m = 32, the projection 2 F D m, and 2 D for each
    of min(8k, F) candidates of each valid query; bytes the descriptors read
    and (F, k) int32 indices and float32 distances written."""
    rng = np.random.default_rng(2)
    N, K, D, k = 3, 7, 40, 4
    F = N * K
    ids = np.repeat(np.arange(N), K)
    mask = rng.random(F) > 0.3
    pairs = sum(1 for a in range(F) for t in range(F)
                if mask[a] and mask[t] and ids[a] != ids[t])
    want = 2 * 32 * pairs + 2 * F * D * 32 + 2 * D * int(mask.sum()) * min(8 * k, F)
    assert work_approx.flops(mask, ids, D, k) == want
    assert work_approx.bytes_moved(F, D, k) == 4 * F * D + 8 * F * k
    peaks = work.PEAKS[H100]
    # ring38's folder with every slot valid: ~3.79e11 flops, the TF32 peak bounds it
    ring_ids, ring_mask = np.repeat(np.arange(38), 2048), np.ones(38 * 2048, bool)
    assert work_approx.flops(ring_mask, ring_ids, 128, 4) == pytest.approx(3.787e11, rel=1e-3)
    assert work_approx.bound_s(ring_mask, ring_ids, 128, 4, peaks["tf32_flop_s"],
                               peaks["hbm_byte_s"]) == pytest.approx(0.765e-3, rel=1e-2)


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


def test_approx_roofline_reads_the_events():
    """100 x the summed bounds over the summed event times; None without a
    call, for a call in bf16, or on a card not in the table of peaks."""
    read = spec.metric_module("approx_roofline").read
    ids = torch.arange(38, dtype=torch.int32).repeat_interleave(2048)
    mask = torch.ones(38 * 2048, dtype=torch.bool)
    mask[::7] = False
    calls = [(mask, ids, 128, 4, "float32", _Event(0.0), _Event(600.0)),
             (mask, ids, 128, 4, "float32", _Event(700.0), _Event(1300.0))]
    peaks = work.PEAKS[H100]
    bound = 2 * work_approx.bound_s(mask.numpy(), ids.numpy(), 128, 4, peaks["tf32_flop_s"],
                                    peaks["hbm_byte_s"])
    got = read(_ctx({"approx_calls": calls}))
    assert got == pytest.approx(100.0 * bound / 1.2)
    assert 0 < got < 1
    bf16 = [c[:4] + ("bfloat16",) + c[5:] for c in calls]
    assert read(_ctx({"approx_calls": calls[:1] + bf16[1:]})) is None
    assert read(_ctx({"approx_calls": calls}, kind="cpu")) is None
    assert read(_ctx()) is None
    assert read(_ctx({"approx_calls": []})) is None


def test_approx_roofline_records_no_cpu_call():
    """The reader's hook passes a CPU call through and records nothing, and
    its undo restores the program's function."""
    mod = spec.metric_module("approx_roofline")
    desc, mask, ids = _pool(3, 32)
    want = mt.global_knn(desc, mask, ids, method="approximate", block=64)
    store = {}
    fn = mt._approximate_knn
    undo = mod.install(store)
    try:
        got = mt.global_knn(desc, mask, ids, method="approximate", block=64)
    finally:
        undo()
    assert all(torch.equal(a, b) for a, b in zip(want, got)) and store["approx_calls"] == []
    assert mt._approximate_knn is fn


def test_idle_s_approx():
    """Idle ns inside the kept matching.approx spans over the kept stitches
    (not inside the blocks' spans again); None where no stitch has one."""
    read = spec.metric_module("idle_s.approx").read
    seg = np.array([[2 * MS, 5 * MS], [12 * MS, 20 * MS]], np.int64)
    tr = SimpleNamespace(segments=seg)
    k1 = spans.Kept((0, 30 * MS), [("matching.knn", 0, 25 * MS),
                                   ("matching.approx", 0, 10 * MS),
                                   ("matching.approx.rank", 1 * MS, 9 * MS),
                                   ("matching.approx", 11 * MS, 21 * MS)], {})
    k2 = spans.Kept((40 * MS, 50 * MS), [("matching.knn", 40 * MS, 45 * MS)], {})
    # 7 ms idle in [0, 10], 2 ms in [11, 21]; over 2 stitches
    assert read(_ctx({spans.KEY: [k1, k2]}, tr)) == pytest.approx(4.5e-3)
    assert read(_ctx({spans.KEY: [k2]}, tr)) is None
    assert read(_ctx({spans.KEY: [k1]}, None)) is None
    assert read(_ctx()) is None


def test_metric_entries():
    """Both metrics list only the approximate cell, on the layer
    ops/matching (approximate), and their readers say so."""
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ("approx_roofline", "idle_s.approx"):
        m, mod = entries[name], spec.metric_module(name)
        assert m["workloads"] == [CELL] and m["source"] == "device_trace"
        assert (m["unit"], m["layer"], m["moves"]) == (mod.UNIT, mod.LAYER, mod.MOVES)
        assert name in [e["name"] for e in spec.per_layer(BENCH, CELL)]
        assert name not in [e["name"] for e in spec.per_layer(BENCH, "rot800.ring38")]


def test_approx800_is_rot800_with_the_approximate_matcher():
    """approx800 pins every StitchConfig field and differs from rot800 only in
    matching.method; nothing reduced; the cell runs ring38's traffic on one
    card under ring38's checks."""
    cfg = spec.config_file(BENCH, "approx800")
    log = io.StringIO()
    sc = spec.stitch_config(cfg, log=log)
    assert (sc.matching.method, sc.tpu.match_block, sc.matching.k) == ("approximate", 1024, 4)
    assert log.getvalue() == ""
    rot = spec.config_file(BENCH, "rot800")
    a = copy.deepcopy(cfg["stitch_config"])
    a["matching"]["method"] = "exhaustive"
    assert a == rot["stitch_config"]
    assert set(cfg) == set(rot) and cfg["reduced"] == []
    assert set(rot["assumed"]) < set(cfg["assumed"])
    for key in ("matching.method", "approximate.sketch", "approximate.candidates",
                "approximate.block"):
        assert key in cfg["assumed"]
    entry = next(c for c in BENCH["configs"] if c["name"] == "approx800")
    assert entry["file"] == "pano_bench/configs/approx800.json" and entry["reduced"] == []
    assert entry["source"] == cfg["source"] and len(entry["source"]) <= 200
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("approx800", "ring38", 1)
    assert set(spec.limits(CELL)["checks"]) == set(spec.limits("rot800.ring38")["checks"])
    assert [m["name"] for m in spec.end_to_end(BENCH, CELL)] == [
        "stitch_s", "stitch_p90_s", "setup_s"]


def test_small_approximate_ring_traced():
    """A 12-view ring of 320x240 with the approximate matcher through
    `harness.run_cell`, traced on the CPU and judged by the sketch rule that
    approx800 states: correct, and the line carries `idle_s.approx` (no
    device work on the CPU, so all of the span) and no `approx_roofline`
    (no card)."""
    cell = {**RING, "workload": CELL}
    wl = spec.workload(BENCH, CELL)
    limits = {"checks": {k: v for k, v in LIMITS.items() if k in spec.limits(CELL)["checks"]}}
    line = harness.run_cell(BENCH, wl, 2**33 + 5, 0.01, True, "cpu", 0.0,
                            traffic=small_traffic(cell), config=small_config(cell),
                            limits=limits)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    m = line["metrics"]
    assert m["idle_s.approx"]["value"] > 0 and "approx_roofline" not in m
    assert m["stage_s.matching"]["value"] > 0
    json.dumps(line)
