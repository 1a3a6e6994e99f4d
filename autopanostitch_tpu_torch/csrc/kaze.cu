// KAZE's FED diffusion step: `fed_step`.
//
// Replaces no Pallas kernel: the JAX package runs the step as XLA
// (autopanostitch_tpu/ops/kaze.py:110, `_diffusion_step`). The port's plain
// version, `kernels/kaze.fed_step_plain`, builds it from four edge-replicating
// shifts of g and four of L (a `torch.roll` and an edge copy each) and the
// adds and products between them: about 39 eager kernels a step, each reading
// and writing a whole (G, H, W) stack, 137 steps an image group.
//
// One step, per pixel of each (H, W) image of the group:
//   flux = 0
//   for nb in E (x + 1), W (x - 1), S (y + 1), N (y - 1), in this order:
//     flux = flux + (0.5 * (g + g[nb])) * (L[nb] - L)
//   out = L + tau * flux
// with a neighbour index clamped at the image edge (the plain version's edge
// replication), every sum and product rounded on its own in float32 (no FMA
// contraction: __fadd_rn / __fmul_rn), tau a float32. So the kernel equals the
// plain version on the card bit for bit.
//
// What bounds it on an H100: bytes. A pixel reads L and g and writes out, 12
// bytes, against 22 float32 operations: at (8, 600, 800) 46.1 MB a step, 13.8
// us at 3.35 TB/s (the three stacks nearly fit the 50 MB L2, so a step can
// read faster than that). So the design moves each byte once and launches once
// a step:
//  - one block per kTY x kTX tile of one image, the group folded into the
//    grid (z), so a step is one launch;
//  - the block copies its tile of L and of g with a one-pixel halo into
//    shared memory, rows clamped at the image edge, in 16-byte loads along W
//    where the row allows them (W a multiple of 4, aligned stacks, the float4
//    inside the image), else 4-byte loads with clamped columns (the ragged
//    right edge, W not a multiple of 4, the halo columns);
//  - each warp then computes whole rows of the tile from shared memory, lane
//    by lane along W (no bank conflicts), and writes out once, coalesced.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTX = 128;             // tile columns
constexpr int kTY = 16;              // tile rows
constexpr int kThreads = 256;        // 8 warps: 2 tile rows each
constexpr int kPad = 4;              // tile column c at shared column c + kPad (16-byte aligned)
constexpr int kSX = kTX + 2 * kPad;  // shared row: halo at kPad - 1 and kTX + kPad

struct StepArgs {
  const float* L;
  const float* g;
  float* out;
  int H, W;
  float tau;
  bool vec;  // 16-byte loads allowed: W % 4 == 0 and both stacks 16-byte aligned
};

__device__ __forceinline__ void load_tile(float (*s)[kSX], const float* __restrict__ img,
                                          const StepArgs& a, int y0, int x0) {
  const int tid = threadIdx.x;
  constexpr int kQuads = kTX / 4;
  for (int i = tid; i < (kTY + 2) * kQuads; i += kThreads) {
    const int r = i / kQuads, q = i - r * kQuads;
    const int y = min(max(y0 - 1 + r, 0), a.H - 1);
    const float* row = img + static_cast<size_t>(y) * a.W;
    const int x = x0 + 4 * q;
    float* dst = &s[r][kPad + 4 * q];
    if (a.vec && x + 3 < a.W) {
      *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(row + x));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = __ldg(row + min(x + j, a.W - 1));
    }
  }
  for (int i = tid; i < 2 * (kTY + 2); i += kThreads) {  // the halo columns
    const int r = i >> 1, right = i & 1;
    const int y = min(max(y0 - 1 + r, 0), a.H - 1);
    const int x = right ? min(x0 + kTX, a.W - 1) : max(x0 - 1, 0);
    s[r][right ? kTX + kPad : kPad - 1] = __ldg(img + static_cast<size_t>(y) * a.W + x);
  }
}

__device__ __forceinline__ float term(float gc, float gn, float Lc, float Ln) {
  return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(gc, gn)), __fsub_rn(Ln, Lc));
}

__global__ void __launch_bounds__(kThreads) fed_step_kernel(const StepArgs a) {
  __shared__ __align__(16) float sL[kTY + 2][kSX];
  __shared__ __align__(16) float sg[kTY + 2][kSX];

  const int y0 = blockIdx.y * kTY, x0 = blockIdx.x * kTX;
  const size_t plane = static_cast<size_t>(blockIdx.z) * a.H * a.W;
  load_tile(sL, a.L + plane, a, y0, x0);
  load_tile(sg, a.g + plane, a, y0, x0);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kTY; r += kThreads / 32) {
    const int y = y0 + r;
    if (y >= a.H) break;
    float* orow = a.out + plane + static_cast<size_t>(y) * a.W;
#pragma unroll
    for (int c = lane; c < kTX; c += 32) {
      const int x = x0 + c;
      if (x >= a.W) break;
      const int sr = r + 1, sc = c + kPad;
      const float Lc = sL[sr][sc], gc = sg[sr][sc];
      float flux = __fadd_rn(0.0f, term(gc, sg[sr][sc + 1], Lc, sL[sr][sc + 1]));  // E
      flux = __fadd_rn(flux, term(gc, sg[sr][sc - 1], Lc, sL[sr][sc - 1]));        // W
      flux = __fadd_rn(flux, term(gc, sg[sr + 1][sc], Lc, sL[sr + 1][sc]));        // S
      flux = __fadd_rn(flux, term(gc, sg[sr - 1][sc], Lc, sL[sr - 1][sc]));        // N
      orow[x] = __fadd_rn(Lc, __fmul_rn(a.tau, flux));
    }
  }
}

}  // namespace

// L, g, out: (G, H, W) float32, contiguous; out must not overlap L or g.
// One explicit FED step out = L + tau div(g grad L) on `stream`.
extern "C" int apst_fed_step(const float* L, const float* g, float* out, int G, int H, int W,
                             float tau, void* stream) {
  if (G < 1 || H < 1 || W < 1 || G > 65535 || (H + kTY - 1) / kTY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a{L, g, out, H, W, tau,
             W % 4 == 0 && reinterpret_cast<size_t>(L) % 16 == 0 &&
                 reinterpret_cast<size_t>(g) % 16 == 0};
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, G);
  fed_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
