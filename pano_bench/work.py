"""The yardstick's arithmetic: the table of device peaks and the work that
kernel B1 (exact k-NN) is counted with, whatever implements it.

B1's work is the distance products its inputs need, 2 D flops for each
(query, target) pair that the rule asks for:
- pooled (`knn`): every valid query against every valid target of another
  image (ids >= 0; -2 marks an invalid row; same-image pairs are masked
  out by the rule, so they are no work of it);
- pair list (`knn_pairs`): every valid slot of image a against every valid
  slot of image b, for each listed pair, once (one product serves both
  directions).
D is the descriptor width before any padding.
"""

from __future__ import annotations

import numpy as np

# Published dense peaks (NVIDIA's data sheet, SXM part, at the 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32_flop_s": 495e12, "bf16_flop_s": 989e12,
                              "fp32_flop_s": 67e12, "hbm_byte_s": 3.35e12},
}


def peak(device_kind: str, key: str):
    """The peak `key` of the named card, or None for a card not in the table."""
    row = PEAKS.get(device_kind)
    return None if row is None else row[key]


def pooled_flops(qid: np.ndarray, tid: np.ndarray, D: int) -> float:
    """Flops of one pooled launch: 2 D for each valid cross-image pair."""
    q = np.asarray(qid).astype(np.int64)
    t = np.asarray(tid).astype(np.int64)
    q, t = q[q >= 0], t[t >= 0]
    n = int(max(q.max(initial=-1), t.max(initial=-1))) + 1
    same = int(np.dot(np.bincount(q, minlength=n), np.bincount(t, minlength=n)))
    return 2.0 * D * (len(q) * len(t) - same)


def pair_flops(valid: np.ndarray, pairs: np.ndarray, D: int) -> float:
    """Flops of one pair-list launch: 2 D for each valid slot pair of each
    listed image pair."""
    v = np.asarray(valid).astype(bool).sum(1).astype(np.int64)
    p = np.asarray(pairs).astype(np.int64).reshape(-1, 2)
    return 2.0 * D * float(np.dot(v[p[:, 0]], v[p[:, 1]]))
