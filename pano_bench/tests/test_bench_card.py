"""On the card: one short run of each cell, correct, with every metric the
cell reports (`python -m pytest -m cuda pano_bench/tests`)."""

import json
import subprocess
import sys

import pytest

from pano_bench import spec
from pano_bench.tests.conftest import ROOT

BENCH = spec.load_benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, wl, trace):
    p = subprocess.run([sys.executable, "pano_bench/run.py", "--workload", wl, "--seed",
                        str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
                       capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    want = spec.per_layer(BENCH, wl) if trace else spec.end_to_end(BENCH, wl)
    assert set(line["metrics"]) == {m["name"] for m in want}
