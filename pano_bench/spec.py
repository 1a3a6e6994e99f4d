"""Loaders of the benchmark's data: `BENCHMARK.json` at the checkout's root,
and the files that the names in it lead to, one file each:

- `configs/<config>.json` (the entry's `file`): `stitch_config`, every
  field of the port's `StitchConfig` ({section: {field: value}}), so that
  no default of the program moves the deployment; the deployment's
  `source`, `assumed` and `reduced`;
- `traffic/<traffic>.json`: the folders' parameters; `kind` names the scene
  generator `scenes/<kind>.py`;
- `limits/<workload>.json`: the limit of each number that decides `correct`;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx)`, with its
  `UNIT`, `LAYER` and `MOVES`, and optionally `install(ctx)`, run before a
  traced window.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: pathlib.Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(CHECKOUT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(HERE / "limits" / f"{workload_name}.json")


def metric_module(name: str) -> ModuleType:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "pano_bench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, workload_name: str) -> bool:
    return "workloads" not in entry or workload_name in entry["workloads"]


def end_to_end(bench: dict, workload_name: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if applies(m, workload_name)]


def per_layer(bench: dict, workload_name: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, workload_name)}
    return [m for m in bench["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def stitch_config(config: dict, log=None):
    """The port's StitchConfig as the configuration file pins it. A field the
    file names that StitchConfig lacks is an error; a field of StitchConfig
    that the file does not name (one the program added after the file was
    written) takes the program's default and is named on `log` (standard
    error), so that the run says what it did not pin."""
    import dataclasses
    import sys

    from autopanostitch_tpu_torch.config import StitchConfig

    log = sys.stderr if log is None else log
    base = StitchConfig()
    pinned: Dict[str, dict] = config["stitch_config"]
    sections = {f.name for f in dataclasses.fields(base)}
    if set(pinned) - sections:
        raise ValueError(f"{config.get('name')}: no StitchConfig section {sorted(set(pinned) - sections)}")
    out = {}
    for name in sorted(sections):
        sec = getattr(base, name)
        given = pinned.get(name, {})
        have = {f.name for f in dataclasses.fields(sec)}
        if set(given) - have:
            raise ValueError(f"{config.get('name')}: no field {sorted(set(given) - have)} "
                             f"in StitchConfig.{name}")
        for field in sorted(have - set(given)):
            print(f"spec: {config.get('name')}: {name}.{field} is not pinned; the program's "
                  f"default {getattr(sec, field)!r} is taken", file=log)
        out[name] = dataclasses.replace(sec, **_tuples(given))
    return base.replace(**out)


def _tuples(fields: dict) -> dict:
    """JSON lists as the tuples the config's fields hold."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
