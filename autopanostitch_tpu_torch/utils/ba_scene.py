"""Synthetic inputs of the bundle adjustments (host numpy): a yaw ring of
cameras with noisy matches between neighbours, and a perturbed starting
state, for the rotational BA (`tests/test_torch_ba_normals.py` and
`tools/ba_probe.py` build their phases from these); a planar grid scan for
the homography BA (`models/bundle_h.py`)."""

from __future__ import annotations

import numpy as np


def random_rotation(rng: np.random.Generator, scale: float) -> np.ndarray:
    """A random rotation of about `scale` radians (Rodrigues)."""
    w = rng.normal(0, scale, 3)
    t = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(t, 1e-12)
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


def ring_scene(n: int, hops: int, M: int, seed: int = 0, f: float = 600.0, size=(600, 800),
               fill: float = 0.8) -> dict:
    """A yaw ring of n cameras, each paired with the next `hops`, and M
    match slots a pair (the first `fill` of them real: noisy projections of
    random points of camera i into camera j, the rest zero-weight padding).
    Returns the true (R, f) and the BA inputs as numpy."""
    rng = np.random.default_rng(seed)
    h, w = size
    cx, cy = np.full(n, (w - 1) / 2.0), np.full(n, (h - 1) / 2.0)
    R = []
    for i in range(n):
        a = 2 * np.pi * i / n
        Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        R.append(random_rotation(rng, 0.02) @ Ry.T)
    R = np.stack(R)
    pairs = np.array([(i, (i + d) % n) for i in range(n) for d in range(1, hops + 1)])
    P = len(pairs)
    u_i = np.zeros((P, M, 2), np.float32)
    u_j = np.zeros((P, M, 2), np.float32)
    wm = np.zeros((P, M), np.float32)
    K = np.array([[f, 0, cx[0]], [0, f, cy[0]], [0, 0, 1.0]])
    m_real = int(fill * M)
    for p, (i, j) in enumerate(pairs):
        H = K @ R[j] @ R[i].T @ np.linalg.inv(K)
        pts = rng.uniform([0, 0], [w, h], size=(20 * M, 2))
        q = np.concatenate([pts, np.ones((len(pts), 1))], -1) @ H.T
        ok = q[:, 2] > 0
        q = q[:, :2] / q[:, 2:3]
        ok &= (q[:, 0] > 0) & (q[:, 0] < w) & (q[:, 1] > 0) & (q[:, 1] < h)
        sel = np.nonzero(ok)[0][:m_real]
        u_i[p, : len(sel)] = pts[sel]
        u_j[p, : len(sel)] = q[sel] + rng.normal(0, 0.3, (len(sel), 2))
        wm[p, : len(sel)] = 1.0
    return dict(R=R.astype(np.float32), f=np.full(n, f, np.float32),
                cx=cx.astype(np.float32), cy=cy.astype(np.float32), pairs=pairs,
                u_i=u_i, u_j=u_j, w=wm)


def perturbed_state(sc: dict, seed: int = 1, k1: float = 0.02):
    """A perturbed starting state of `ring_scene`'s cameras: rotations off
    by ~0.01 rad, focals by a few per cent, k1 near `k1`. Returns (R, f, k1)
    float32."""
    rng = np.random.default_rng(seed)
    n = len(sc["f"])
    R = np.stack([random_rotation(rng, 0.01) @ r for r in sc["R"]]).astype(np.float32)
    f = (sc["f"] * rng.uniform(0.96, 1.04, n)).astype(np.float32)
    return R, f, (k1 + rng.normal(0, 0.005, n)).astype(np.float32)


def planar_scene(rows: int, cols: int, M: int, seed: int = 0) -> dict:
    """A rows x cols planar scan of 800 x 600 images at 35 % overlap: image
    k's homography to the canvas is its grid offset with a small random
    linear and projective part; each image is paired with its right, lower
    and both lower diagonal neighbours, M match slots a pair (the first 80 %
    real: random points of image i and their noisy images in j, the rest
    zero-weight padding). Returns a perturbed start params0 (N, 8) (the
    homographies' first 8 entries, H33 = 1) and the pairs' u_i, u_j, w."""
    rng = np.random.default_rng(seed)
    h, w = 600, 800
    step = 0.65 * np.array([w, h])
    H = np.tile(np.eye(3), (rows * cols, 1, 1))
    for k in range(rows * cols):
        H[k, :2, 2] = step * [k % cols, k // cols]
        H[k, :2, :2] += rng.normal(0, 2e-3, (2, 2))
        H[k, 2, :2] = rng.normal(0, 1e-6, 2)
    pairs = np.array([(r * cols + c, (r + dr) * cols + c + dc)
                      for r in range(rows) for c in range(cols)
                      for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1))
                      if r + dr < rows and 0 <= c + dc < cols])
    P = len(pairs)
    u_i = np.zeros((P, M, 2), np.float32)
    u_j = np.zeros((P, M, 2), np.float32)
    wm = np.zeros((P, M), np.float32)
    m_real = int(0.8 * M)
    for p, (i, j) in enumerate(pairs):
        pts = rng.uniform([0, 0], [w, h], size=(40 * M, 2))
        q = np.concatenate([pts, np.ones((len(pts), 1))], -1) @ (np.linalg.inv(H[j]) @ H[i]).T
        q = q[:, :2] / q[:, 2:3]
        ok = (q[:, 0] > 0) & (q[:, 0] < w) & (q[:, 1] > 0) & (q[:, 1] < h)
        sel = np.nonzero(ok)[0][:m_real]
        u_i[p, : len(sel)] = pts[sel]
        u_j[p, : len(sel)] = q[sel] + rng.normal(0, 0.4, (len(sel), 2))
        wm[p, : len(sel)] = 1.0
    noise = np.eye(3) + rng.normal(0, [[1e-3, 1e-3, 0.6], [1e-3, 1e-3, 0.6], [1e-7, 1e-7, 0]],
                                   (rows * cols, 3, 3))
    start = H @ noise
    params0 = (start.reshape(-1, 9)[:, :8] / start[:, 2, 2:3]).astype(np.float32)
    return dict(params0=params0, pairs=pairs, u_i=u_i, u_j=u_j, w=wm)
