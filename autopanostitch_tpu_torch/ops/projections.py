"""Panorama surface <-> world rays, camera projection and k1 distortion
(port of `ops/projections.py`).

Five projections, as the reference renderer: planar (= perspective),
cylindrical, spherical, equirectangular (spherical with full-range bounds)
and stereographic. Planar and stereographic work in the frame of a
reference camera R_ref. World->camera rotation R, camera looking down +Z,
x right, y down; pano pixel xp sits at surface coordinate x0 + xp / f_pan.

`pano_to_ray`, `project_ray_to_camera` and `distort_pixels` are also the
plain version of the render sampler (`kernels/render.py`), so they round
as `csrc/render.cu` does: every 3-vector product is written out as a
3-term sum (`@` may go to cuBLAS, which sums in another order) and f_pan
divides as a tensor (a Python divisor becomes a reciprocal product on the
card).
"""

from __future__ import annotations

import torch

PROJECTIONS = ("planar", "perspective", "cylindrical", "spherical", "equirectangular",
               "stereographic")
ANGULAR = ("cylindrical", "spherical", "equirectangular")
REF_FRAME = ("planar", "perspective", "stereographic")


def check_mode(mode: str) -> None:
    if mode not in PROJECTIONS:
        raise ValueError(f"unknown projection mode {mode!r}")


def normalize_rays(d):
    n = torch.sqrt((d * d).sum(-1, keepdim=True))
    return d / torch.clamp(n, min=1e-8)


def pano_to_ray(mode: str, xp, yp, f_pan, x0, y0, R_ref=None):
    """Pano pixel grid -> unit world rays (..., 3). R_ref (3, 3) world->ref
    rotation, read by the planar and stereographic modes."""
    check_mode(mode)
    f = torch.as_tensor(f_pan, dtype=torch.float32, device=xp.device)
    u = xp / f + x0
    v = yp / f + y0
    if mode == "cylindrical":
        q = (torch.sin(u), v, torch.cos(u))
    elif mode in ("spherical", "equirectangular"):
        cphi = torch.cos(v)
        q = (cphi * torch.sin(u), torch.sin(v), cphi * torch.cos(u))
    else:  # R_ref^T @ d
        r = torch.as_tensor(R_ref, dtype=torch.float32, device=xp.device)
        if mode in ("planar", "perspective"):
            q = tuple(u * r[0, j] + v * r[1, j] + r[2, j] for j in range(3))
        else:  # stereographic: inverse projection from the plane tangent at +Z
            r2 = u * u + v * v
            den = r2 + 1.0
            s = (2.0 * u / den, 2.0 * v / den, (1.0 - r2) / den)
            q = tuple(s[0] * r[0, j] + s[1] * r[1, j] + s[2] * r[2, j] for j in range(3))
    n = torch.clamp(torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]), min=1e-8)
    return torch.stack([q[0] / n, q[1] / n, q[2] / n], dim=-1)


def ray_to_pano(mode: str, d, R_ref=None):
    """World rays -> surface coordinates (u, v) and validity; planar and
    stereographic rotate the rays into the R_ref frame first."""
    check_mode(mode)
    if mode in REF_FRAME:
        d = d @ R_ref.transpose(-1, -2)  # R_ref @ d
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    if mode == "cylindrical":
        u = torch.atan2(x, z)
        rho = torch.sqrt(x * x + z * z)
        v = y / torch.clamp(rho, min=1e-8)
        valid = rho > 1e-8
    elif mode in ("spherical", "equirectangular"):
        u = torch.atan2(x, z)
        v = torch.atan2(y, torch.sqrt(x * x + z * z))
        valid = torch.ones_like(u, dtype=torch.bool)
    elif mode in ("planar", "perspective"):
        valid = z > 1e-4
        zs = torch.clamp(z, min=1e-4)
        u = x / zs
        v = y / zs
    else:
        n = torch.sqrt(x * x + y * y + z * z)
        xn, yn, zn = x / n, y / n, z / n
        denom = 1.0 + zn
        valid = denom > 1e-6
        ds = torch.clamp(denom, min=1e-6)
        u = xn / ds
        v = yn / ds
    return u, v, valid


def undistort_pixels(u, v, k1, cx, cy):
    """Distorted-image pixel -> pinhole pixel (Brown one-term, exact)."""
    dx = u - cx
    dy = v - cy
    r2 = (dx * dx + dy * dy) / (cx * cx + cy * cy + 1e-12)
    fac = 1.0 + k1 * r2
    return cx + dx * fac, cy + dy * fac


def distort_pixels(u, v, k1, cx, cy, iters: int = 6):
    """Pinhole pixel -> distorted-image pixel by fixed point (inverse of
    undistort_pixels); far-outside queries pass through undistorted."""
    dx = u - cx
    dy = v - cy
    rq2 = (dx * dx + dy * dy) / (cx * cx + cy * cy + 1e-12)
    rp2 = rq2
    for _ in range(iters):
        f = torch.clamp(1.0 + k1 * rp2, min=0.25)
        rp2 = rq2 / (f * f)
    fac = torch.clamp(1.0 + k1 * rp2, min=0.25)
    fac = torch.where(rq2 > 2.25, torch.ones_like(fac), fac)
    return cx + dx / fac, cy + dy / fac


def camera_pixel_rays(K_inv, R, xp, yp, k1=None, cx=None, cy=None):
    """Image pixels -> world rays R^T K^-1 [x, y, 1] (not normalized); with
    k1 the pixels are undistorted first. xp/yp (..., P) with K_inv, R
    (..., 3, 3) and k1/cx/cy (..., 1)."""
    if k1 is not None:
        xp, yp = undistort_pixels(xp, yp, k1, cx, cy)
    p = torch.stack([xp, yp, torch.ones_like(xp)], dim=-1)
    cam = p @ K_inv.transpose(-1, -2)
    return cam @ R


def project_ray_to_camera(d_world, R, K, eps_z: float = 1e-6, k1=None):
    """World unit rays -> (u, v, front, cos_angle) per camera.

    d_world (..., P, 3) rays; R, K (..., 3, 3) cameras and k1 (...,), all
    broadcast against d_world's leading dims. Outputs are (..., P)."""
    d = d_world[..., 0], d_world[..., 1], d_world[..., 2]
    dx, dy, dz = (d[0] * R[..., j, 0, None] + d[1] * R[..., j, 1, None] + d[2] * R[..., j, 2, None]
                  for j in range(3))  # R @ d
    front = dz > eps_z
    dz_safe = torch.clamp(dz, min=eps_z)
    fx = K[..., 0, 0, None]
    fy = K[..., 1, 1, None]
    cx = K[..., 0, 2, None]
    cy = K[..., 1, 2, None]
    u = fx * (dx / dz_safe) + cx
    v = fy * (dy / dz_safe) + cy
    if k1 is not None:
        u, v = distort_pixels(u, v, k1[..., None], cx, cy)
    cos_angle = torch.clamp(dz, min=0.0)
    return u, v, front, cos_angle
