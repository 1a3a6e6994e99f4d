"""Per-stage artifact caching (checkpoint/resume), a copy of the JAX
package's `utils/cache.py` (numpy only; the pipeline moves tensors to and
from numpy at its boundary).

The reference has no checkpointing (each dataset run is monolithic,
SURVEY.md section 5); we add cheap npz-based per-stage caches so expensive
stages (feature extraction, match verification, bundle adjustment) can be
resumed and so stage-parity tests can diff recorded artifacts.

Cache key = dataset fingerprint (file names + sizes + config repr hash).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np


def fingerprint(names, sizes, cfg_repr: str) -> str:
    h = hashlib.sha256()
    for n in names:
        h.update(str(n).encode())
    h.update(np.asarray(sizes).tobytes())
    h.update(cfg_repr.encode())
    return h.hexdigest()[:16]


class StageCache:
    def __init__(self, root: Optional[str]):
        self.root = root
        if root:
            os.makedirs(root, exist_ok=True)

    def _path(self, key: str, stage: str) -> str:
        return os.path.join(self.root, f"{key}_{stage}.npz")

    def load(self, key: str, stage: str):
        if not self.root:
            return None
        p = self._path(key, stage)
        if not os.path.exists(p):
            return None
        with np.load(p, allow_pickle=False) as z:
            return dict(z)

    def save(self, key: str, stage: str, **arrays) -> None:
        if not self.root:
            return
        np.savez_compressed(self._path(key, stage), **arrays)
