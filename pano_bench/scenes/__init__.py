"""Scene generators: a traffic file's `kind` names a module of this folder,
whose `make(traffic, seed, index, device)` returns the `Folder` of that
index of a run's pool.

A folder's content (textures, yaw offsets) comes from the traffic file's
`content_seed` and its index, so every run stitches the same folders and
does the same work; the run's seed draws each folder's stitch seed (the
RANSAC draws) and, in the harness, the order in which the pool is cycled.
Content drawn from the run seed made the work itself differ from seed to
seed: the planar scan's pool mean spread by 5 % over twelve seeds, where
one run's stitches spread by about 1 % (PERF.md)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass
class Folder:
    """One photo folder of a pool: what the program is handed (`iset`), the
    seed its stitch takes, and the ground truth the reference judges it by."""

    iset: Any
    stitch_seed: int
    truth: Dict[str, Any]


def folder_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of folder `index` of the pool of run seed `seed` (any
    whole number, also beyond 64 bits)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(index)]))


def stitch_seed(seed: int, index: int) -> int:
    """The stitch seed of folder `index` in a run of seed `seed`."""
    return int(folder_rng(seed, index).integers(0, 2**31))


def make(traffic: dict, seed: int, index: int, device) -> Folder:
    return importlib.import_module(f"pano_bench.scenes.{traffic['kind']}").make(
        traffic, seed, index, device)
