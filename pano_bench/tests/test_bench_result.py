"""The shape of a run's last line, the trace reader, and the run's refusals
(no card; a checkout without the program)."""

import json
import shutil
import subprocess
import sys

import pytest

from pano_bench import devtrace, harness, spec
from pano_bench.tests.conftest import ROOT

# a planar cell small enough for the CPU (the window's stitches run the
# port's plain kernel versions there)
SMALL_TRAFFIC = {"kind": "planar", "pool": 1, "content_seed": 1, "rows": 3, "cols": 3,
                 "width": 320, "height": 240, "overlap": 0.35}
SMALL_DETECTOR = {"max_keypoints": 256, "num_octaves": 3}


class Event:
    def __init__(self, kind, name, s, e):
        self.kind, self.n, self.s, self.e = kind, name, s, e

    def activity_type(self):
        return self.kind

    def device_type(self):
        return "DeviceType.CPU" if self.kind in ("cpu_op", "user_annotation",
                                                 "cuda_runtime") else "DeviceType.CUDA"

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


def test_trace_reader():
    ev = [Event("user_annotation", devtrace.WINDOW, 0, 1000),
          Event("user_annotation", "stage:features", 0, 400),
          Event("user_annotation", "stage:render", 500, 1000),
          Event("cpu_op", "aten::item", 300, 500),
          Event("cuda_runtime", "cudaStreamSynchronize", 320, 480),
          Event("kernel", "void knn_kernel<4, 128>(PooledArgs)", 100, 300),
          Event("kernel", "void (anonymous namespace)::refine(Rows, long long)", 250, 320),
          Event("gpu_memcpy", "Memcpy HtoD", 600, 700),
          Event("kernel", "late", 1200, 1300)]
    tr = devtrace.Trace(ev)
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(320e-9)  # [100, 320] and [600, 700]
    assert tr.device_seconds(lambda n: devtrace.kernel_id(n) in {"knn_kernel", "refine"}) \
        == pytest.approx(270e-9)
    assert devtrace.kernel_id("void (anonymous namespace)::refine(Rows, long long)") == "refine"
    assert tr.top_ops(2)[0] == ["knn_kernel<4, 128>", pytest.approx(200e-9)]
    gaps = dict(tr.idle_gaps(10))
    assert gaps["features / python"] == pytest.approx(100e-9)
    assert gaps["outside stages / cudaStreamSynchronize"] == pytest.approx(280e-9)
    assert gaps["render / python"] == pytest.approx(300e-9)
    assert sum(gaps.values()) == pytest.approx(680e-9)


def test_last_line_shape():
    bench = spec.load_benchmark()
    wl = spec.workload(bench, "planar800.scan3x3")
    config = json.loads(json.dumps(spec.config_file(bench, "planar800")))
    config["stitch_config"]["detector"].update(SMALL_DETECTOR)
    for trace in (0, 1):
        line = harness.run_cell(bench, wl, 2**33 + 5, 0.01, bool(trace), "cpu", 0.0,
                                traffic=SMALL_TRAFFIC, config=config)
        assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert line["attempted"] >= 1 and line["failed"] == 0
        assert set(line["checks"]) == set(spec.limits(wl["name"])["checks"])
        assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
        names = {m["name"] for m in (spec.per_layer(bench, wl["name"]) if trace
                                     else spec.end_to_end(bench, wl["name"]))}
        assert set(line["metrics"]) <= names
        if not trace:
            assert set(line["metrics"]) == names
        else:
            assert {"stage_s.features", "stage_s.ba", "stage_s.render"} <= set(line["metrics"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        json.dumps(line)


def test_run_refuses_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "pano_bench" / "run.py"), "--workload",
                        "rot800.ring38", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "pano_bench", tmp_path / "pano_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "pano_bench/run.py", "--workload", "rot800.ring38",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
