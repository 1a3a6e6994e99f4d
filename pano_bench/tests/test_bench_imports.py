"""Nothing the benchmark runs imports JAX or the JAX package: the top-level
name of every module that `pano_bench` and `autopanostitch_tpu_torch`
import, compared whole (the port's name begins with the JAX package's)."""

import subprocess
import sys

from pano_bench import harness
from pano_bench.tests.conftest import ROOT

SCRIPT = r"""
import importlib, pkgutil, sys
import autopanostitch_tpu_torch, pano_bench
for pkg in (autopanostitch_tpu_torch, pano_bench):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if ".tests" in m.name or m.name.endswith((".run", ".calibrate")):
            continue
        importlib.import_module(m.name)
import pano_bench.run, pano_bench.calibrate
from pano_bench import spec
for m in spec.load_benchmark()["per_layer"]:
    spec.metric_module(m["name"])
print(" ".join(sorted({n.split(".", 1)[0] for n in sys.modules})))
"""


def test_no_jax_in_the_benchmark_or_the_port():
    p = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                       cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(p.stdout.split())
    assert "autopanostitch_tpu_torch" in tops and "pano_bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "autopanostitch_tpu"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "autopanostitch_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "autopanostitch_tpu", raising=False)
    assert "autopanostitch_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "autopanostitch_tpu.models", sys)
    assert "autopanostitch_tpu" in harness.forbidden_modules()
