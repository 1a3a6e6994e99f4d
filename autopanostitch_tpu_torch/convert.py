"""Carry state from the JAX package into the port.

The pipeline has no learned weights; the state that crosses between the
packages is its configuration and stage output: features, the match graph,
cameras, gains, the homography BA / planar result and the render canvas.
Each function takes the JAX package's object (or anything with the same
fields) holding arrays convertible with numpy, and returns the port's;
the tensor ones put it on the `device` they are given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from autopanostitch_tpu_torch.config import StitchConfig
from autopanostitch_tpu_torch.models.bundle import Cameras
from autopanostitch_tpu_torch.models.pipeline import MatchGraph
from autopanostitch_tpu_torch.ops.sift import SiftFeatures


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def config(cfg) -> StitchConfig:
    """JAX `StitchConfig` (or its `dataclasses.asdict`) -> the port's copy."""
    d = cfg if isinstance(cfg, dict) else dataclasses.asdict(cfg)
    ref = StitchConfig()
    return StitchConfig(**{name: type(getattr(ref, name))(**sub) for name, sub in d.items()})


def sift_features(feats, device) -> SiftFeatures:
    """JAX `SiftFeatures` (or a dict of its fields) -> the port's, on device."""
    out = {}
    for name in SiftFeatures._fields:
        a = np.array(_field(feats, name))  # a writable copy (JAX arrays are read-only)
        out[name] = torch.as_tensor(a if a.dtype == bool else a.astype(np.float32),
                                    device=device)
    return SiftFeatures(**out)


def match_graph(graph) -> MatchGraph:
    """JAX `MatchGraph` (or a dict of its fields) -> the port's (numpy)."""
    return MatchGraph(**{k: np.array(_field(graph, k)) for k in MatchGraph.__dataclass_fields__})


def cameras(cams, device) -> Cameras:
    """JAX `Cameras` (R, f, cx, cy, k1 | None) -> the port's, on device."""
    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    k1 = _field(cams, "k1")
    return Cameras(R=t(_field(cams, "R")), f=t(_field(cams, "f")), cx=t(_field(cams, "cx")),
                   cy=t(_field(cams, "cy")), k1=None if k1 is None else t(k1))


def gains(g) -> np.ndarray:
    """Per-image (N, 3) gains (numpy in both packages)."""
    return np.asarray(g, np.float32)


def homography_ba(hba) -> dict:
    """JAX `run_bundle_adjustment_h` result, or the planar part of a
    panorama dict (`H_abs`, `reachable`, `anchor`), -> the port's fields:
    float32 (n, 3, 3) H_abs, bool reachable, int anchor, and whichever of
    `H_init` / `final_cost` it carries."""
    out = {"H_abs": np.array(_field(hba, "H_abs"), np.float32),
           "anchor": int(_field(hba, "anchor"))}
    if "reachable" in hba:
        out["reachable"] = np.array(hba["reachable"], bool)
    if "H_init" in hba:
        out["H_init"] = np.array(hba["H_init"], np.float32)
    if "final_cost" in hba:
        out["final_cost"] = float(hba["final_cost"])
    return out


def canvas(c) -> dict:
    """JAX `compute_canvas` dict -> the port's: python scalars and a float32
    (3, 3) R_ref (the frame of the planar and stereographic surfaces)."""
    return {"mode": str(c["mode"]), "f_pan": float(c["f_pan"]), "x0": float(c["x0"]),
            "y0": float(c["y0"]), "Hc": int(c["Hc"]), "Wc": int(c["Wc"]),
            "R_ref": np.array(c["R_ref"], np.float32), "ref_idx": int(c["ref_idx"]),
            "uv_abs_cap": float(c.get("uv_abs_cap", 8.0))}
