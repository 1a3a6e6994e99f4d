"""The port's command line (`python -m autopanostitch_tpu_torch.cli`)
against the JAX package's, with `--device cpu` on a tiny synthetic folder:
the same dataset discovery and file names, panoramas within
tests/test_parity.py's tolerances (shape within 2 px, mean within 1.5),
the log, the stage cache (a second run resumes and writes the same pixels)
and the profiler trace.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import synthdata
from autopanostitch_tpu import cli as jcli
from autopanostitch_tpu_torch import cli as tcli
from autopanostitch_tpu_torch.utils import timing
from test_torch_pipeline import REPO, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Two planar crops in root/setA (the reference's CLI test scene)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("data")
    env = synthdata.texture(0, 420, 800)
    d = root / "setA"
    d.mkdir()
    for k, (x, y, w, h) in enumerate([(0, 0, 420, 380), (280, 20, 420, 380)]):
        Image.fromarray((env[y : y + h, x : x + w] * 255).astype(np.uint8)).save(d / f"img_{k}.png")
    return root


ARGS = ["--projections", "planar", "--blend", "linear", "--force-planar", "--size-limit", "512",
        "--show-keypoints", "--show-adjacency"]


@pytest.fixture(scope="module")
def both_runs(dataset_dir, tmp_path_factory):
    from PIL import Image

    out = tmp_path_factory.mktemp("out")
    tdir, jdir, cache = out / "torch", out / "jax", out / "cache"
    assert tcli.main([str(dataset_dir), "--out", str(tdir), "--device", "cpu", "--cache",
                      str(cache), "--log", str(out / "log.txt")] + ARGS) == 0
    assert jcli.main([str(dataset_dir), "--out", str(jdir)] + ARGS) == 0
    again = out / "torch2"
    assert tcli.main([str(dataset_dir), "--out", str(again), "--device", "cpu", "--cache",
                      str(cache), "--profile", str(out / "trace")] + ARGS) == 0

    def read(d):
        return {f: np.asarray(Image.open(d / f)) for f in sorted(os.listdir(d))}

    return read(tdir), read(jdir), read(again), out


def test_find_datasets_matches_jax(dataset_dir):
    for root in (dataset_dir, dataset_dir / "setA"):
        t, j = tcli.find_datasets(str(root)), jcli.find_datasets(str(root))
        assert t == j and len(next(iter(t.values()))) == 2


def test_cli_writes_the_references_files(both_runs):
    t, j, _, out = both_runs
    assert list(t) == list(j)
    assert {"planar_setA_0.png", "adjacency_setA.png", "keypoints_setA_img_0.png",
            "keypoints_setA_img_1.png"} == set(t)
    pt, pj = t["planar_setA_0.png"], j["planar_setA_0.png"]
    np.testing.assert_allclose(pt.shape, pj.shape, atol=2)
    assert abs(float(pt.mean()) - float(pj.mean())) < 1.5
    assert pt.shape[1] > 600  # wider than a single 420 px crop
    assert "execution time" in (out / "log.txt").read_text()


def test_cli_resumes_from_the_cache(both_runs):
    t, _, again, out = both_runs
    assert list(again) == list(t)
    np.testing.assert_array_equal(again["planar_setA_0.png"], t["planar_setA_0.png"])
    stages = sorted(f.split("_", 1)[1] for f in os.listdir(out / "cache"))
    assert stages[1:] == ["features.npz", "graph.npz"] and stages[0].startswith("ba")
    trace = json.loads((out / "trace" / timing.TRACE_FILE).read_text())
    assert trace["traceEvents"]


def test_cli_without_a_card_raises(dataset_dir, tmp_path):
    """--device cuda (the default) on a machine without one: no fallback."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-fallback check needs one without")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main([str(dataset_dir), "--out", str(tmp_path)])
    out = subprocess.run([sys.executable, "-m", "autopanostitch_tpu_torch.cli", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout and "--cache" in out.stdout


def test_tee_and_device_memory(tmp_path, capsys):
    with timing.Tee(str(tmp_path / "log.txt")):
        print("hello")
    assert (tmp_path / "log.txt").read_text() == "hello\n"
    assert "hello" in capsys.readouterr().out
    import torch

    if not torch.cuda.is_available():
        assert timing.report_device_memory() is None


def test_cli_profile_writes_the_span_table(both_runs):
    """--profile writes the tracer's table beside the trace (one stitch, its
    stages; no device idle or waits on the CPU), then the stitch's counters,
    and the trace shows the spans."""
    out = both_runs[3]
    table = (out / "trace" / timing.SPANS_FILE).read_text().splitlines()
    assert table[0].split() == ["span", "count", "total_s", "self_s", "idle_s", "syncs"]
    (counters,) = [line for line in table[1:] if line.startswith("counters ")]
    rows = {line.split()[0]: line.split() for line in table[1:] if line != counters}
    assert rows["stitch"][1] == "1" and rows["stitch"][4:] == ["-", "-"]
    assert {"features", "render"} <= set(rows)
    got = dict(kv.split("=") for kv in counters.split(": ", 1)[1].split())
    assert int(got["ba.lm_iterations"]) > 0 and int(got["render.bands"]) >= 1
    events = json.loads((out / "trace" / timing.TRACE_FILE).read_text())["traceEvents"]
    assert "apst:stitch" in {e.get("name") for e in events}
