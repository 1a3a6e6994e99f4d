"""The loaders of every configuration, traffic, limits and metric file, and
BENCHMARK.json against the benchmark's contract."""

import dataclasses
import io
import json
import re

import pytest

from pano_bench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[sec]]
    assert all(NAME.match(n) for n in names)
    for sec in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[sec]}) == len(BENCH[sec])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"stitch_s", "stitch_p90_s", "setup_s"} <= set(e2e)
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    data = spec.config_file(BENCH, cfg["name"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    m = data["stitch_config"]["matching"]
    log = io.StringIO()
    sc = spec.stitch_config(data, log=log)
    assert log.getvalue() == ""  # every field of StitchConfig is pinned
    assert sc.matching.ratio_threshold == m["ratio_threshold"]
    assert sc.tpu.compute_dtype == "float32"
    pinned = {sec: {f.name: getattr(getattr(sc, sec), f.name)
                    for f in dataclasses.fields(getattr(sc, sec))} for sec in data["stitch_config"]}
    assert pinned == {sec: spec._tuples(v) for sec, v in data["stitch_config"].items()}


def test_stitch_config_refuses_an_unknown_field_and_names_an_unpinned_one():
    data = json.loads(json.dumps(spec.config_file(BENCH, "rot800")))
    del data["stitch_config"]["bundle"]["lambda0"]
    log = io.StringIO()
    sc = spec.stitch_config(data, log=log)
    assert "bundle.lambda0 is not pinned" in log.getvalue()
    assert sc.bundle.lambda0 == 1e-3
    data["stitch_config"]["bundle"]["no_such_field"] = 1
    with pytest.raises(ValueError, match="no_such_field"):
        spec.stitch_config(data, log=log)


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files_load(wl):
    assert wl["chips"] == 1 and len(wl["why"]) <= 200
    assert wl["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = spec.traffic(wl["traffic"])
    assert (spec.HERE / "scenes" / f"{traffic['kind']}.py").is_file()
    assert traffic["pool"] >= 1
    limits = spec.limits(wl["name"])["checks"]
    assert {"members_wrong", "psnr_db", "match_excess"} <= set(limits)
    assert limits["members_wrong"]["limit"] == 0
    assert all(v["better"] in ("lower", "higher") for v in limits.values())
    assert spec.end_to_end(BENCH, wl["name"]) and spec.per_layer(BENCH, wl["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    mod = spec.metric_module(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert callable(mod.read)


def test_one_layer_one_name():
    """Metrics of the modules that share a layer name give it letter for letter."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and 1 <= len(x) <= 200 for x in layers)
