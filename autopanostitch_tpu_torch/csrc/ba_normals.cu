// Per-pair normal equations of the rotational bundle adjustment.
//
// Replaces `pair_system` (autopanostitch_tpu/models/bundle.py:682), which
// the JAX package leaves to XLA inside its LM phase program (no Pallas
// kernel), with the Jacobians the JAX package takes from jax.jacrev written
// in closed form (Brown-Lowe Eq. 20-23; kernels/ba.py derives them and
// holds the plain PyTorch version of this kernel). For pair p and each of
// its M matches it computes the bidirectional residual r (4), its Jacobian
// J (4 x 2PD) against [theta_i, f_i(, k1_i), theta_j, f_j(, k1_j)] at
// theta = 0, the Huber weights (w_ji = 0 in the one-direction mode), the
// front-facing mask (z > 1e-4 both ways) and the match weight w, and sums
//   JtJ[p] = sum_m J^T W J (2PD x 2PD, symmetric),
//   Jtg[p] = sum_m J^T W r (2PD),  cost[p] = sum_m r^T W r.
//
// What bounds it on an H100: neither bytes nor operations at the sizes BA
// runs (pb <= 128 pairs x M <= 300 matches: < 0.8 MB in, < 0.04 GFLOP); it is
// latency: one block a pair fills at most pb of the 132 SMs, and a thread
// walks its ~3 matches, each a chain of dependent float32 arithmetic, then
// a reduction. Design: one block of 128 threads a pair, the pair's two
// cameras in shared memory (read as broadcasts, so they take no registers
// beside the NS sums), thread t takes matches t, t + 128, ... into NS =
// (2PD)(2PD+1)/2 + 2PD + 1 register sums (the upper triangle of JtJ, Jtg,
// cost), then a warp shuffle tree and a fixed-order sum of the four warps'
// partials. No float atomics: a repeat launch is bit-identical, which the
// graph-replayed LM relies on to equal its eager run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Cam {
  float R[9];
  float f, k1, cx, cy;
};

__device__ __forceinline__ void load_cam(Cam& m, const float* __restrict__ Rb,
                                         const float* __restrict__ f,
                                         const float* __restrict__ k1,
                                         const float* __restrict__ cx,
                                         const float* __restrict__ cy, long long c) {
  for (int e = 0; e < 9; ++e) m.R[e] = Rb[c * 9 + e];
  m.f = f[c];
  m.k1 = k1[c];
  m.cx = cx[c];
  m.cy = cy[c];
}

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

template <int PD>
__global__ void __launch_bounds__(kThreads, 1)
    ba_normals_kernel(const float* __restrict__ Rb, const float* __restrict__ f,
                      const float* __restrict__ k1, const float* __restrict__ cx,
                      const float* __restrict__ cy, const float2* __restrict__ u_i,
                      const float2* __restrict__ u_j, const float* __restrict__ w,
                      const long long* __restrict__ pij, int M, float sigma, int one_direction,
                      float* __restrict__ JtJ, float* __restrict__ Jtg,
                      float* __restrict__ cost) {
  constexpr int NP = 2 * PD;
  constexpr int NH = NP * (NP + 1) / 2;  // upper triangle of JtJ
  constexpr int NS = NH + NP + 1;        // + Jtg + cost
  __shared__ float part[kWarps][NS];
  __shared__ Cam cams[2];
  const int p = blockIdx.x;
  if (threadIdx.x < 2) load_cam(cams[threadIdx.x], Rb, f, k1, cx, cy, pij[2 * p + threadIdx.x]);
  __syncthreads();
  const Cam& ci = cams[0];
  const Cam& cj = cams[1];

  float acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.f;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const size_t e = (size_t)p * M + m;
    const float2 ui = u_i[e], uj = u_j[e];
    float r[4], rd[2], J[4][NP], Js[2][PD], Jd[2][PD], zj, zi;
    direction<PD>(ci, cj, ui.x, ui.y, uj.x, uj.y, rd, Js, Jd, zj);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      r[row] = rd[row];
#pragma unroll
      for (int k = 0; k < PD; ++k) {
        J[row][k] = Js[row][k];
        J[row][PD + k] = Jd[row][k];
      }
    }
    direction<PD>(cj, ci, uj.x, uj.y, ui.x, ui.y, rd, Js, Jd, zi);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      r[2 + row] = rd[row];
#pragma unroll
      for (int k = 0; k < PD; ++k) {
        J[2 + row][k] = Jd[row][k];
        J[2 + row][PD + k] = Js[row][k];
      }
    }
    const float w_ij = fminf(1.f, sigma / sqrtf(r[0] * r[0] + r[1] * r[1] + 1e-12f));
    const float w_ji =
        one_direction ? 0.f : fminf(1.f, sigma / sqrtf(r[2] * r[2] + r[3] * r[3] + 1e-12f));
    const float wp = w[e] * ((zj > 1e-4f && zi > 1e-4f) ? 1.f : 0.f);
    const float w4[4] = {w_ij * wp, w_ij * wp, w_ji * wp, w_ji * wp};
    int s = 0;
#pragma unroll
    for (int a = 0; a < NP; ++a) {
      float jw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) jw[k] = J[k][a] * w4[k];
#pragma unroll
      for (int b = a; b < NP; ++b)
        acc[s++] += jw[0] * J[0][b] + jw[1] * J[1][b] + jw[2] * J[2][b] + jw[3] * J[3][b];
      acc[NH + a] += jw[0] * r[0] + jw[1] * r[1] + jw[2] * r[2] + jw[3] * r[3];
    }
    acc[NS - 1] += w4[0] * r[0] * r[0] + w4[1] * r[1] * r[1] + w4[2] * r[2] * r[2] +
                   w4[3] * r[3] * r[3];
  }

#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[s] += __shfl_down_sync(0xffffffffu, acc[s], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) part[warp][s] = acc[s];
  }
  __syncthreads();
  for (int s = threadIdx.x; s < NS; s += kThreads) {
    float t = part[0][s];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) t += part[v][s];
    if (s < NH) {
      int a = 0, rest = s;
      while (rest >= NP - a) {
        rest -= NP - a;
        ++a;
      }
      const int b = a + rest;
      JtJ[((size_t)p * NP + a) * NP + b] = t;
      JtJ[((size_t)p * NP + b) * NP + a] = t;
    } else if (s < NH + NP) {
      Jtg[(size_t)p * NP + (s - NH)] = t;
    } else {
      cost[p] = t;
    }
  }
}

}  // namespace

extern "C" int apst_ba_normals(const float* Rb, const float* f, const float* k1, const float* cx,
                               const float* cy, const float* u_i, const float* u_j,
                               const float* w, const long long* pij, int pb, int M, int pd,
                               float sigma, int one_direction, float* JtJ, float* Jtg,
                               float* cost, void* stream) {
  if (pb <= 0) return 0;
  if (M < 0 || (pd != 4 && pd != 5)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* ui = reinterpret_cast<const float2*>(u_i);
  const float2* uj = reinterpret_cast<const float2*>(u_j);
  if (pd == 5)
    ba_normals_kernel<5><<<pb, kThreads, 0, s>>>(Rb, f, k1, cx, cy, ui, uj, w, pij, M, sigma,
                                                 one_direction, JtJ, Jtg, cost);
  else
    ba_normals_kernel<4><<<pb, kThreads, 0, s>>>(Rb, f, k1, cx, cy, ui, uj, w, pij, M, sigma,
                                                 one_direction, JtJ, Jtg, cost);
  return (int)cudaGetLastError();
}
