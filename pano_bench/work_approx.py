"""The work that the approximate pooled matcher (`matching.method =
"approximate"`, D > 32) is counted with, whatever implements it: one call
takes the pool's F descriptors of width D with their image ids and mask,
and gives each row its k nearest among its min(8k, F) candidates of least
distance in the 32-d sketch desc @ G (`reference._SketchRule` states the
rule).

Flops, m = 32 the sketch's width:
- the projection desc @ G: 2 F D m;
- the sketch distances: 2 m for each valid cross-image (query, target)
  pair, as `work.pooled_flops` counts B1's pairs, at width m;
- the re-rank: 2 D for each candidate of each valid query, min(8k, F) a
  query.

Bytes: the descriptors read once, the (F, k) int32 indices and float32
distances written once. The bound of a call is the larger of its flops at
the TF32 tensor-core peak, the convention of `knn_roofline` (no
float32-accurate implementation beats it, a selection kernel on the tensor
cores included), and its bytes at the memory bandwidth (`work.peak`)."""

from __future__ import annotations

import numpy as np

from pano_bench import sketch, work


def flops(mask: np.ndarray, image_id: np.ndarray, D: int, k: int) -> float:
    """Flops of one call over the pool's (F,) mask and image ids."""
    mask = np.asarray(mask).astype(bool)
    ids = np.where(mask, np.asarray(image_id).astype(np.int64), -2)
    F, m = len(ids), sketch.DIM
    return (2.0 * F * D * m + work.pooled_flops(ids, ids, m)
            + 2.0 * D * int(mask.sum()) * min(8 * k, F))


def bytes_moved(F: int, D: int, k: int) -> float:
    """Bytes of one call: the descriptors read, the indices and distances
    written."""
    return 4.0 * F * D + 8.0 * F * k


def bound_s(mask, image_id, D: int, k: int, flop_s: float, byte_s: float) -> float:
    """The least seconds one call needs."""
    return max(flops(mask, image_id, D, k) / flop_s,
               bytes_moved(len(np.asarray(mask)), D, k) / byte_s)
