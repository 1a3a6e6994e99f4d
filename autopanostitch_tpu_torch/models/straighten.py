"""Automatic panorama straightening.

Mirrors `straightening/straightening.m:74-176`: the global up-vector is the
null direction of the covariance of camera X-axes (Brown-Lowe's heuristic —
horizontal sweeps vary in X, so 'up' is what they never point along); a new
world basis [x̂ up ẑ] is applied to every camera, with the reference's skip
heuristics on up-angle and rotation magnitude.

Host-side numpy: the work is one 3x3 SVD per panorama.
"""

from __future__ import annotations

import numpy as np

from autopanostitch_tpu_torch.config import StraightenConfig


def straighten_rotations(R: np.ndarray, cfg: StraightenConfig = StraightenConfig()):
    """Straighten a set of world->cam rotations.

    Args:
      R: (N, 3, 3) world->cam.

    Returns (R_straightened (N,3,3), applied (bool), S (3,3)).
    """
    if not cfg.enabled or cfg.force_planar_scan or len(R) < 2:
        return R, False, np.eye(3)

    X = R[:, 0, :].T  # (3, N) camera x-axes in world (row 1 of world->cam)
    C = X @ X.T
    _, _, Vt = np.linalg.svd(C)
    up = Vt[-1]  # smallest singular direction

    # flip so up agrees with the average camera Y-axis (straightening.m:94-104)
    avg_y = R[:, 1, :].mean(axis=0)
    avg_y = avg_y / max(np.linalg.norm(avg_y), 1e-12)
    if np.dot(up, avg_y) < 0:
        up = -up

    z_sum = R[:, 2, :].sum(axis=0)
    xhat = np.cross(up, z_sum)
    if np.linalg.norm(xhat) < 1e-12:
        e1 = np.array([1.0, 0, 0])
        if abs(np.dot(up, e1)) > 0.99:
            e1 = np.array([0.0, 0, 1])
        xhat = np.cross(up, e1)
    if np.linalg.norm(xhat) < 1e-12:
        return R, False, np.eye(3)
    xhat /= np.linalg.norm(xhat)
    zhat = np.cross(xhat, up)
    if np.linalg.norm(zhat) < 1e-12:
        return R, False, np.eye(3)
    zhat /= np.linalg.norm(zhat)
    S = np.stack([xhat, up, zhat], axis=1)  # columns

    # skip heuristics (straightening.m:142-163, thresholds inputs.m:89-90)
    theta_deg = np.degrees(np.arccos(np.clip((np.trace(S) - 1) / 2, -1, 1)))
    up_angle = np.degrees(np.arccos(np.clip(abs(np.dot(up, [0, 1.0, 0])), -1, 1)))
    t1, t2, t3 = cfg.up_angle_thresholds
    if t1 < up_angle < t3:
        return R, False, S  # vertical/horizontal pano — intentional
    if up_angle > t2 and theta_deg > cfg.theta_threshold:
        return R, False, S  # extreme distortion
    return R @ S, True, S
