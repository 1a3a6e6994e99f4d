// The per-match arithmetic of the rotational bundle adjustment's
// linearisation, included by `ba_system.cu` (the whole dense system): one
// direction s -> d of a match's residual and
// its closed-form Jacobian (Brown-Lowe Eq. 20-23; kernels/ba.py holds the
// plain PyTorch version and its derivation).

#pragma once

#include <cuda_runtime.h>

namespace {

struct Cam {
  float R[9];
  float f, k1, cx, cy;
};

// One direction s -> d of a match: r = obs_d - pred_d, its Jacobian against
// s's parameters (Js) and d's (Jd), and the depth z of the point in d.
template <int PD>
__device__ __forceinline__ void direction(const Cam& s, const Cam& d, float us, float vs,
                                          float ud, float vd, float (&r)[2], float (&Js)[2][PD],
                                          float (&Jd)[2][PD], float& z) {
  float dxs = 0.f, dys = 0.f, r2s = 0.f, dxd = 0.f, dyd = 0.f, r2d = 0.f;
  if constexpr (PD == 5) {  // observations move into pinhole space first
    dxs = us - s.cx;
    dys = vs - s.cy;
    r2s = (dxs * dxs + dys * dys) / (s.cx * s.cx + s.cy * s.cy + 1e-12f);
    const float fs = 1.0f + s.k1 * r2s;
    us = s.cx + dxs * fs;
    vs = s.cy + dys * fs;
    dxd = ud - d.cx;
    dyd = vd - d.cy;
    r2d = (dxd * dxd + dyd * dyd) / (d.cx * d.cx + d.cy * d.cy + 1e-12f);
    const float fd = 1.0f + d.k1 * r2d;
    ud = d.cx + dxd * fd;
    vd = d.cy + dyd * fd;
  }
  const float x = (us - s.cx) / s.f;
  const float y = (vs - s.cy) / s.f;
  float wv[3], p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) wv[a] = s.R[a] * x + s.R[3 + a] * y + s.R[6 + a];  // Rs^T ray
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = d.R[3 * a] * wv[0] + d.R[3 * a + 1] * wv[1] + d.R[3 * a + 2] * wv[2];
  z = p[2];
  const bool small = fabsf(z) < 1e-6f;
  const float zs = small ? (z < 0.f ? -1e-6f : 1e-6f) : z;
  r[0] = ud - (d.f * p[0] / zs + d.cx);
  r[1] = vd - (d.f * p[1] / zs + d.cy);
  // A = d pred / d p = [[a, 0, c0], [0, a, c1]]; the clamp passes no derivative
  const float a = d.f / zs;
  const float c[2] = {small ? 0.f : -a * p[0] / zs, small ? 0.f : -a * p[1] / zs};
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float AR[3], g[3];  // A Rd, then G = A Rd Rs^T
#pragma unroll
    for (int m = 0; m < 3; ++m) AR[m] = a * d.R[3 * row + m] + c[row] * d.R[6 + m];
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k] = s.R[3 * k] * AR[0] + s.R[3 * k + 1] * AR[1] + s.R[3 * k + 2] * AR[2];
    Js[row][0] = -g[1] + g[2] * y;  // G (e_k x ray)
    Js[row][1] = g[0] - g[2] * x;
    Js[row][2] = -g[0] * y + g[1] * x;
    Js[row][3] = (g[0] * x + g[1] * y) / s.f;
    if constexpr (PD == 5) Js[row][4] = -(g[0] * dxs + g[1] * dys) * r2s / s.f;
  }
  // -A (e_k x p), k = 0, 1, 2; d r / d f_d; d r / d k1_d
  Jd[0][0] = -c[0] * p[1];
  Jd[0][1] = -a * p[2] + c[0] * p[0];
  Jd[0][2] = a * p[1];
  Jd[0][3] = -p[0] / zs;
  Jd[1][0] = a * p[2] - c[1] * p[1];
  Jd[1][1] = c[1] * p[0];
  Jd[1][2] = -a * p[0];
  Jd[1][3] = -p[1] / zs;
  if constexpr (PD == 5) {
    Jd[0][4] = dxd * r2d;
    Jd[1][4] = dyd * r2d;
  }
}

}  // namespace
