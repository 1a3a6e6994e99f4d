// SIFT's two window phases, each fused into one kernel that reads its
// keypoints' windows straight from the magnitude/angle stack into shared
// memory and bins them there:
//   orient_hist: the raw 36-bin orientation histogram of each keypoint;
//   descriptor:  the d x d x nbins descriptor (4 x 4 x 8 by default; any
//                d <= 4 and nbins <= 16), normalised, clipped at 0.2 and
//                renormalised.
//
// Replaces the TPU kernel `gather_windows` (autopanostitch_tpu/ops/pallas/
// window_gather.py:78) together with the dense phases that consume its
// windows, `_orientation_hist_dense` (autopanostitch_tpu/ops/sift.py:329-357)
// and `_descriptor_dense` (:388-438). Unfused, each 1,024-keypoint chunk of
// 80 px windows wrote 52 MB of windows to device memory, and the binning
// that followed built dense soft-bin tensors from them (a (1024, 1600, 36)
// one-hot for the histogram, 236 MB; a (1024, 6400, 16) bf16-rounded weight
// tensor for the descriptor, 420 MB in float32). Here no window and no
// soft-bin tensor reaches device memory: a keypoint's window is read once,
// its outputs (36 or 128 floats) are written once, and all keypoints of a
// launch (a whole octave of an image group) are one launch.
//
// The input is the (S, H, W, 2) float32 stack of gradient magnitude and
// angle, the image batch flattened into S as img * S_img + level, with
// EXACT window starts lev[k], y[k], x[k] (the TPU kernel's (8, 128) start
// alignment was a Mosaic DMA constraint). Keypoint k sits at (lx[k], ly[k])
// inside its win x win window.
//
// What bounds it on an H100 (per window pixel; K keypoints of win^2 pixels):
// - bytes: the stack pixels that some window covers (the union of the
//   windows, level by level), read once, and the outputs. At the
//   20-image ring's octave 0 the 80 px windows cover nearly all of the
//   levels they touch, the 40 px ones (which start where the 80 px ones
//   do) a good deal less; chip_smoke.py counts the union of each run;
// - operations, counted from the reference's float32 arithmetic per pixel:
//   orient_hist 20 (rx, ry, r2 as 2 mul + add, neg, div, exp, compare, mask,
//   contrib, /2pi, x36, mod, floor, frac, 1 - f, and the two soft-bin
//   products and sums); descriptor 57 (rx, ry 2; u, v as 2 mul + add + div
//   each 8; rbin, cbin 4; ang, /2pi, x8, mod 4; three soft bins as floor,
//   frac, 1 - f 9; the two range masks of R and C 4; u^2 + v^2, neg, /8 5;
//   exp, contrib 2; seven bf16 roundings 7; bf16(cb R) 2 x (mul, round) 4;
//   bf16(bf16(cb R) C) 4 x (mul, round) 8) at 67 TFLOP/s, plus the
//   descriptor's contraction on the tensor cores, 2 x 16 x 8 bf16 flops a
//   pixel at 989 TFLOP/s. At the ring's shape the descriptor is bound by
//   its float32 arithmetic (~0.29 ms for 40,960 80 px windows) and the
//   histogram by bytes.
//   Measured on an H100 (variants of this source timed in turns, one
//   binning a window over and over, one copying windows and binning none),
//   both kernels are held by their arithmetic, the issue of each pixel's
//   float and integer instructions: binning alone takes as long as the
//   kernel, the copies alone a third of it (descriptor) or two thirds
//   (histogram).
// So the design keeps every pixel's arithmetic to one pass, keeps the
// windows' copies asynchronous beside it, and puts the descriptor's
// contraction on the tensor cores:
// - Persistent blocks walk the keypoints (k = blockIdx.x, + gridDim.x, ...)
//   with a 2-stage ring of windows in shared memory: keypoint k + gridDim.x
//   is copied into one stage while k is binned from the other. Each stage
//   has an mbarrier. The copy is a TMA tiled load of the stack viewed as
//   (S H, 2 W) float32, one thread issuing it, when the rows allow it (W
//   even: TMA needs 16-byte strides; win even). TMA takes any row start but
//   not any column start: a box whose first column is not 16-byte aligned
//   faults (illegal instruction) on the H100, so the box starts at the even
//   float2 column at or left of the window and is 2 float2 wider, (win,
//   2 (win + 2)) floats. Otherwise every thread copies 8-byte cp.async,
//   completing on the same mbarrier (cp.async.mbarrier.arrive.noinc).
//   A window too large for two stages in shared memory (win > 104 for the
//   4 x 4 x 8 descriptor, > 112 for the histogram: sigma or d well above
//   the defaults) is read by each thread straight from the stack (the
//   DIRECT route; no stage, the same arithmetic).
// - orient_hist: one thread a pixel computes contrib and the two circular
//   bins and adds them into its own 36-bin histogram in shared memory
//   (bin-major, so a warp's columns are 32 banks). No float atomics: a warp
//   per bin sums the 128 columns in a fixed order, so a launch is
//   bit-identical to the last. The 2 smoothing passes and the peak search
//   (36 values a keypoint) stay in PyTorch.
// - descriptor: 16 warps; each takes 64 pixels at a time, two a lane (two
//   independent chains for the scheduler). A lane computes each of its
//   pixels' soft-bin record once and writes it as the pixel's row of the
//   warp's tile in shared memory: the d d <= 16 cells
//   (bf16(bf16(cb R) C) on its 2 x 2 cells, 0 elsewhere, padded to 16) and
//   the nbins orientation bins (bf16(O) on its 2 bins, padded to 8 NT),
//   48 bytes (80 for nbins > 8). Then four steps of 16 pixels, each NT
//   mma.sync.m16n8k16 bf16 -> f32, read the tile:
//   M = the 16 cells, N = 8 bins, K = 16 pixels, the A and B fragments
//   loaded by ldmatrix.trans straight from the pixel-major rows, so no lane
//   recomputes or reassembles another's record. The warps need no block
//   barrier until the window is done. A bf16 x bf16 product is exact in
//   float32, so only the order of the float32 sum differs from the
//   reference; the 16 warps' 16 x 8 partial sums are added in a fixed
//   order, and the normalisation runs in the epilogue.
// - The arithmetic follows the reference's roundings, not faster ones:
//   __fmul_rn / __fadd_rn keep the compiler from contracting a product and
//   a sum the reference rounds apart (u, v, r2, the exp arguments); every
//   division is the correctly rounded one (`div_rn`, checked bit for bit
//   against __fdiv_rn by tools/div_rn_probe.cu), the angle's by
//   float32(2 pi); expf / cosf / sinf are the accurate ones; `%` is
//   Python's (fmodf, plus the divisor when the signs differ); the
//   descriptor's soft bins are clipped to zero weight at the edges; and
//   bf16 rounds (to nearest even) exactly where the reference rounds.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "tma.cuh"

namespace {

constexpr float TWO_PI_F = 6.28318530717958647692f;  // float32(2 pi), the reference's divisor
constexpr float INV_TWO_PI_F = 1.0f / TWO_PI_F;      // rn(1 / float32(2 pi)), for div_rn
constexpr int ORI_BINS = 36;
constexpr int ORI_NT = 128;    // orient_hist threads a block
constexpr int DESC_NT = 512;   // descriptor threads a block (16 warps)
constexpr int MAX_WIN = 2048;  // largest window (row_of's exact range)

// How a window reaches the binning: copied into a shared-memory stage by a
// TMA box or by cp.async, or read by each thread straight from the stack.
enum Route { CP_ASYNC = 0, TMA = 1, DIRECT = 2 };

// A stage holds win rows of PITCH(win) float2: the TMA box starts at the even
// column at or left of the window (its start must be 16-byte aligned), so a
// row carries up to 2 columns more than the window.
__host__ __device__ constexpr int pitch(int win) { return win + 2; }
__host__ __device__ constexpr int stage_bytes(int ROUTE, int win) {
  return ROUTE == DIRECT ? 0 : (win * pitch(win) * 8 + 127) / 128 * 128;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128u - (smem_u32(p) & 127u)) & 127u);
}

// ---- mbarriers: one a stage; completion u of a stage is awaited with parity u & 1

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// ---- window copies: a TMA box, or 8-byte cp.async by every thread

struct Windows {
  const float2* src;  // (S, H, W) float2 (magnitude, angle)
  int H, W;
  const int* lev;
  const int* ys;
  const int* xs;
  int win;
};

// Window k into a stage (rows PITCH apart). The TMA box covers columns
// x & ~1 .. (x & ~1) + win + 1 (columns past W are zero-filled and never
// read), so window column c sits at row offset (x & 1) + c; cp.async
// copies the window alone, at offset 0 (`window`).
template <int ROUTE>
__device__ __forceinline__ void load_window(const Windows& w, const CUtensorMap* map, int k,
                                            float2* dst, uint64_t* bar) {
  const int P = pitch(w.win);
  if (ROUTE == TMA) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                   "r"(w.win * P * 8)
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
          "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(2 * (w.xs[k] & ~1)),
          "r"(w.lev[k] * w.H + w.ys[k])
          : "memory");
    }
  } else if (ROUTE == CP_ASYNC) {
    const float2* base = w.src + ((size_t)w.lev[k] * w.H + w.ys[k]) * w.W + w.xs[k];
    const int n = w.win * w.win;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / w.win;
      const int c = e - r * w.win;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst + r * P + c)),
                   "l"(base + (size_t)r * w.W + c)
                   : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
                 : "memory");
  }
}

// Keypoint k's window pixel (0, 0) and its row pitch in float2: in stage
// `st`, or (DIRECT) in the stack itself.
template <int ROUTE>
__device__ __forceinline__ const float2* window(const Windows& w, const float2* st, int k,
                                                int& rp) {
  if (ROUTE == DIRECT) {
    rp = w.W;
    return w.src + ((size_t)w.lev[k] * w.H + w.ys[k]) * w.W + w.xs[k];
  }
  rp = pitch(w.win);
  return st + (ROUTE == TMA ? (w.xs[k] & 1) : 0);
}

// ---- the reference's arithmetic

// Python's float `%` (as jnp.remainder / torch.remainder) for b > 0: fmod,
// plus b when the remainder is negative. For |a| < 2 b fmod is a, a - b or
// a + b, each exact, so the slow general fmodf is left for the rest.
__device__ __forceinline__ float py_mod(float a, float b) {
  float m;
  if (fabsf(a) < 2.f * b)
    m = a >= b ? __fsub_rn(a, b) : (a <= -b ? __fadd_rn(a, b) : a);
  else
    m = fmodf(a, b);
  if (m < 0.f) m = __fadd_rn(m, b);
  return m;
}

// a / b rounded to nearest, as div.rn gives it, from y = rn(1 / b) computed
// once per divisor: q = rn(a y) is within an ulp of a / b, the remainder
// a - q b is exact by FMA, and q + (a - q b) y rounds to rn(a / b)
// (Markstein). Holds away from overflow and underflow: here |a| < 2^8 and
// b is 2 pi or a cell width of a few pixels; a zero quotient may come out
// +0 for -0, which no caller tells apart.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// p / win for 0 <= p < 2^22: a float estimate, corrected to the exact quotient.
__device__ __forceinline__ int row_of(int p, int win, float inv_win) {
  int r = __float2int_rz(__fmul_rn((float)p, inv_win));
  r -= r * win > p;
  r += (r + 1) * win <= p;
  return r;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane adds the same two values (in swapped order, which
  // float addition does not see), so every lane ends with the same sum
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// ---------------------------------------------------------------------------
// orient_hist
// ---------------------------------------------------------------------------

template <int ROUTE>
__global__ void __launch_bounds__(ORI_NT)
    orient_hist_kernel(const __grid_constant__ CUtensorMap map, Windows w,
                       const float* __restrict__ lx, const float* __restrict__ ly,
                       const float* __restrict__ srel, int K, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align128(smem_raw);
  const int sb = stage_bytes(ROUTE, w.win);
  float2* const stage0 = reinterpret_cast<float2*>(base);  // stage s at stage0 + s * stride
  const int stride = sb / (int)sizeof(float2);
  float* hist = reinterpret_cast<float*>(base + 2 * sb);  // [ORI_BINS][ORI_NT]
  uint64_t* bar = reinterpret_cast<uint64_t*>(hist + ORI_BINS * ORI_NT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr bool STAGED = ROUTE != DIRECT;

  if (STAGED && tid == 0) {
    mbar_init(&bar[0], ROUTE == TMA ? 1 : ORI_NT);
    mbar_init(&bar[1], ROUTE == TMA ? 1 : ORI_NT);
    mbar_fence_init();
  }
  __syncthreads();

  int k = blockIdx.x;
  if (STAGED && k < K) load_window<ROUTE>(w, &map, k, stage0, &bar[0]);
  const int P = w.win * w.win;
  float* mine = hist + tid;
  const float inv_win = 1.f / (float)w.win;
  for (int i = 0; k < K; ++i, k += gridDim.x) {
    const int s = i & 1;
    if (STAGED && k + (int)gridDim.x < K)
      load_window<ROUTE>(w, &map, k + gridDim.x, stage0 + (s ^ 1) * stride, &bar[s ^ 1]);

    const float lxk = lx[k], lyk = ly[k];
    const float sw = __fmul_rn(1.5f, srel[k]);
    const float den = __fmul_rn(__fmul_rn(2.f, sw), sw);
    const float inv_den = __frcp_rn(den);
    const float lim = __fmul_rn(3.f, sw);
    const float lim2 = __fmul_rn(lim, lim);
#pragma unroll
    for (int b = 0; b < ORI_BINS; ++b) mine[b * ORI_NT] = 0.f;

    if (STAGED) mbar_wait(&bar[s], (i >> 1) & 1);
    int rp;
    const float2* win = window<ROUTE>(w, stage0 + s * stride, k, rp);
    for (int p = tid; p < P; p += ORI_NT) {
      const int wy = row_of(p, w.win, inv_win);
      const int wx = p - wy * w.win;
      const float rx = __fsub_rn((float)wx, lxk);
      const float ry = __fsub_rn((float)wy, lyk);
      const float r2 = __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry));
      const float2 ma = win[wy * rp + wx];
      const float wgt = r2 <= lim2 ? expf(div_rn(-r2, den, inv_den)) : 0.f;
      const float contrib = __fmul_rn(ma.x, wgt);
      const float binf = py_mod(__fmul_rn(div_rn(ma.y, TWO_PI_F, INV_TWO_PI_F), (float)ORI_BINS),
                                (float)ORI_BINS);
      const float v0 = floorf(binf);
      const float f = __fsub_rn(binf, v0);
      int i0 = (int)v0 % ORI_BINS;
      if (i0 < 0) i0 += ORI_BINS;
      const int i1 = i0 + 1 == ORI_BINS ? 0 : i0 + 1;
      mine[i0 * ORI_NT] = __fadd_rn(mine[i0 * ORI_NT], __fmul_rn(contrib, __fsub_rn(1.f, f)));
      mine[i1 * ORI_NT] = __fadd_rn(mine[i1 * ORI_NT], __fmul_rn(contrib, f));
    }
    __syncthreads();
    // a warp a bin: lane l adds columns l, l + 32, ... in order, then the butterfly
    for (int b = warp; b < ORI_BINS; b += ORI_NT / 32) {
      const float* row = hist + b * ORI_NT + lane;
      float v = row[0];
#pragma unroll
      for (int j = 1; j < ORI_NT / 32; ++j) v = __fadd_rn(v, row[32 * j]);
      v = warp_sum(v);
      if (lane == 0) out[(size_t)k * ORI_BINS + b] = v;
    }
    __syncthreads();  // the stage and the histograms are free again
  }
}

// ---------------------------------------------------------------------------
// descriptor (d <= 4, nbins <= 16)
// ---------------------------------------------------------------------------

// The descriptor grid's constants.
struct Grid {
  int d, nb;         // d x d cells, nb orientation bins
  float half_d, nbf;  // d / 2, nb
  float gden, inv_gden;  // the Gaussian's 2 wsig^2 = d^2 / 2, and rn(1 / it)
};

// Linear soft bins of a non-circular coordinate over d bins: bin i0 =
// floor(x) gets 1 - f and bin i0 + 1 gets f, each zero outside 0..d-1 (the
// reference's clipped edge bins). Returns i0 clamped to -2..d (an index
// that no cell matches stays one) and the two weights rounded to bf16.
__device__ __forceinline__ int edge_bins(float x, float df, float& w0, float& w1) {
  const float v0 = floorf(x);
  const float f = __fsub_rn(x, v0);
  w0 = bf16_round(v0 >= 0.f && v0 < df ? __fsub_rn(1.f, f) : 0.f);
  w1 = bf16_round(v0 >= -1.f && v0 < df - 1.f ? f : 0.f);
  return (int)fminf(fmaxf(v0, -2.f), df);
}

// One pixel's soft-bin record, written as its row of the warp's tile: 16
// cells (bf16(bf16(cb R) C) on its 2 x 2 cells of the d x d, 0 elsewhere),
// then 8 NT orientation bins (bf16(O) on its 2 bins, 0 elsewhere).
template <int ROW>
__device__ __forceinline__ void desc_record(uint16_t* row, float2 ma, int wx, int wy, float lxk,
                                            float lyk, float cs, float sn, float cell,
                                            float inv_cell, float th, const Grid& g) {
  const float rx = __fsub_rn((float)wx, lxk);
  const float ry = __fsub_rn((float)wy, lyk);
  const float u = div_rn(__fadd_rn(__fmul_rn(cs, rx), __fmul_rn(sn, ry)), cell, inv_cell);
  const float v = div_rn(__fadd_rn(__fmul_rn(-sn, rx), __fmul_rn(cs, ry)), cell, inv_cell);
  const float rbin = __fsub_rn(__fadd_rn(v, g.half_d), 0.5f);
  const float cbin = __fsub_rn(__fadd_rn(u, g.half_d), 0.5f);
  const float obin =
      py_mod(__fmul_rn(div_rn(__fsub_rn(ma.y, th), TWO_PI_F, INV_TWO_PI_F), g.nbf), g.nbf);
  const float wgt =
      expf(div_rn(-__fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)), g.gden, g.inv_gden));
  const float cb = bf16_round(__fmul_rn(ma.x, wgt));

  float R0, R1, C0, C1;
  const float df = (float)g.d;
  const int r0 = edge_bins(rbin, df, R0, R1);
  const int c0 = edge_bins(cbin, df, C0, C1);
  const float WR0 = bf16_round(cb * R0);  // bf16 x bf16: exact in float32
  const float WR1 = bf16_round(cb * R1);
  const float o0f = floorf(obin);
  const float fo = __fsub_rn(obin, o0f);
  // obin lies in [0, nb] (py_mod), so i0 % nb is i0, or 0 for i0 = nb
  const int o0 = (int)o0f == g.nb ? 0 : (int)o0f;

  uint4* row4 = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int q = 0; q < ROW / 8; ++q) row4[q] = make_uint4(0u, 0u, 0u, 0u);
  const int d = g.d;
  const bool r0in = r0 >= 0 && r0 < d, r1in = r0 + 1 >= 0 && r0 + 1 < d;
  const bool c0in = c0 >= 0 && c0 < d, c1in = c0 + 1 >= 0 && c0 + 1 < d;
  if (r0in && c0in) row[r0 * d + c0] = (uint16_t)bf16_bits(WR0 * C0);
  if (r0in && c1in) row[r0 * d + c0 + 1] = (uint16_t)bf16_bits(WR0 * C1);
  if (r1in && c0in) row[(r0 + 1) * d + c0] = (uint16_t)bf16_bits(WR1 * C0);
  if (r1in && c1in) row[(r0 + 1) * d + c0 + 1] = (uint16_t)bf16_bits(WR1 * C1);
  // with nb = 1 both weights land on bin 0 and add, as the reference's do
  const float w_o0 = __fsub_rn(1.f, fo);
  const int o1 = o0 + 1 == g.nb ? 0 : o0 + 1;
  row[16 + o0] = (uint16_t)bf16_bits(o1 == o0 ? __fadd_rn(w_o0, fo) : w_o0);
  if (o1 != o0) row[16 + o1] = (uint16_t)bf16_bits(fo);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's tile: 32 DESC_PX pixel rows of desc_row(NT) bf16 (16 cells,
// 8 NT bins), padded to an odd number of 16-byte words (48 or 80 bytes),
// so the 8 rows of an ldmatrix land on 8 disjoint groups of banks.
__host__ __device__ constexpr int desc_row(int NT) {
  return ((16 + 8 * NT) / 8) % 2 ? 16 + 8 * NT : 16 + 8 * NT + 8;
}
constexpr int DESC_PX = 2;  // pixels a lane computes at a time

template <int ROUTE, int NT>
__global__ void __launch_bounds__(DESC_NT)
    descriptor_kernel(const __grid_constant__ CUtensorMap map, Windows w,
                      const float* __restrict__ lx, const float* __restrict__ ly,
                      const float* __restrict__ srel, const float* __restrict__ theta, int K,
                      Grid grid, float* __restrict__ out) {
  constexpr int NW = DESC_NT / 32;
  constexpr int ROW = desc_row(NT);
  constexpr int PS = 16 * 8 * NT;  // a warp's partial sums: 16 cells x 8 NT bins
  constexpr bool STAGED = ROUTE != DIRECT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align128(smem_raw);
  const int sb = stage_bytes(ROUTE, w.win);
  float2* const stage0 = reinterpret_cast<float2*>(base);  // stage s at stage0 + s * stride
  const int stride = sb / (int)sizeof(float2);
  uint16_t* tiles = reinterpret_cast<uint16_t*>(base + 2 * sb);  // [NW][32 DESC_PX][ROW]
  float* part = reinterpret_cast<float*>(tiles);  // [NW][PS] once the pixels are done
  float* red = reinterpret_cast<float*>(tiles + NW * 32 * DESC_PX * ROW);  // [NW]
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + NW);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the lane's fragment row group and column pair
  uint16_t* tile = tiles + warp * 32 * DESC_PX * ROW;
  // ldmatrix row addresses: A's four 8 x 8 blocks (cells 0-7 / 8-15 of
  // pixels 0-7 / 8-15), B's two of each 8 bins (pixels 0-7 / 8-15)
  const int lr = lane & 7, lm = lane >> 3;
  const uint16_t* a_row = tile + ((lm >> 1) * 8 + lr) * ROW + (lm & 1) * 8;
  const uint16_t* b_row = tile + ((lm & 1) * 8 + lr) * ROW + 16;
  const float inv_win = 1.f / (float)w.win;
  const int D = grid.d * grid.d * grid.nb;

  if (STAGED && tid == 0) {
    mbar_init(&bar[0], ROUTE == TMA ? 1 : DESC_NT);
    mbar_init(&bar[1], ROUTE == TMA ? 1 : DESC_NT);
    mbar_fence_init();
  }
  __syncthreads();

  int k = blockIdx.x;
  if (STAGED && k < K) load_window<ROUTE>(w, &map, k, stage0, &bar[0]);
  const int P = w.win * w.win;
  for (int i = 0; k < K; ++i, k += gridDim.x) {
    const int s = i & 1;
    if (STAGED && k + (int)gridDim.x < K)
      load_window<ROUTE>(w, &map, k + gridDim.x, stage0 + (s ^ 1) * stride, &bar[s ^ 1]);

    const float lxk = lx[k], lyk = ly[k];
    const float cell = __fmul_rn(3.f, srel[k]);
    const float inv_cell = __frcp_rn(cell);
    const float th = theta[k];
    const float cs = cosf(th), sn = sinf(th);
    float acc[NT][4] = {};

    if (STAGED) mbar_wait(&bar[s], (i >> 1) & 1);
    int rp;
    const float2* win = window<ROUTE>(w, stage0 + s * stride, k, rp);
    // each warp takes DESC_PX x 32 pixels at a time: a lane writes the rows
    // of DESC_PX pixels (independent chains the scheduler interleaves), then
    // 2 DESC_PX steps of 16 pixels, NT mma each, read the tile
    for (int p0 = warp * 32 * DESC_PX; p0 < P; p0 += NW * 32 * DESC_PX) {
      float2 ma[DESC_PX];
      int wx[DESC_PX], wy[DESC_PX];
#pragma unroll
      for (int j = 0; j < DESC_PX; ++j) {
        const int p = min(p0 + j * 32 + lane, P - 1);
        wy[j] = row_of(p, w.win, inv_win);
        wx[j] = p - wy[j] * w.win;
        ma[j] = win[wy[j] * rp + wx[j]];
      }
#pragma unroll
      for (int j = 0; j < DESC_PX; ++j) {
        uint16_t* row = tile + (j * 32 + lane) * ROW;
        if (p0 + j * 32 + lane < P) {
          desc_record<ROW>(row, ma[j], wx[j], wy[j], lxk, lyk, cs, sn, cell, inv_cell, th, grid);
        } else {  // past the window: no cell, no weight
          uint4* row4 = reinterpret_cast<uint4*>(row);
#pragma unroll
          for (int q = 0; q < ROW / 8; ++q) row4[q] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2 * DESC_PX; ++h) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, a_row + h * 16 * ROW);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, b_row + h * 16 * ROW + 8 * n);
          mma_bf16(acc[n], a, b);
        }
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with its tile

    // the warps' 16 x 8 NT partials, added in warp order; output index
    // cell * nb + bin
    float* mine = part + warp * PS;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      mine[g * 8 * NT + c] = acc[n][0];
      mine[g * 8 * NT + c + 1] = acc[n][1];
      mine[(g + 8) * 8 * NT + c] = acc[n][2];
      mine[(g + 8) * 8 * NT + c + 1] = acc[n][3];
    }
    __syncthreads();
    float v = 0.f;
    if (tid < D) {
      const int cl = tid / grid.nb;
      const int o = cl * 8 * NT + (tid - cl * grid.nb);
      v = part[o];
#pragma unroll
      for (int j = 1; j < NW; ++j) v = __fadd_rn(v, part[j * PS + o]);
    }
    // desc / max(|desc|, 1e-8), clipped at 0.2, renormalised
    for (int pass = 0; pass < 2; ++pass) {
      const float ss = warp_sum(__fmul_rn(v, v));
      if (lane == 0) red[warp] = ss;
      __syncthreads();
      float tot = red[0];
#pragma unroll
      for (int j = 1; j < NW; ++j) tot = __fadd_rn(tot, red[j]);
      v = __fdiv_rn(v, fmaxf(sqrtf(tot), 1e-8f));
      if (pass == 0) v = fminf(v, 0.2f);
      __syncthreads();  // red is read before the next pass writes it
    }
    if (tid < D) out[(size_t)k * D + tid] = v;
    // the last barrier above also frees the stage, the tiles and the partials
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The TMA route's tensor map: the stack as (S H, 2 W) float32, box
// (win, 2 pitch(win)).
int tensor_map(CUtensorMap* map, const float* src, int S, int H, int W, int win) {
  tma::EncodeTiled enc = tma::encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)2 * W, (cuuint64_t)S * H};
  const cuuint64_t strides[1] = {(cuuint64_t)2 * W * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)(2 * pitch(win)), (cuuint32_t)win};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(src), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launch a persistent kernel: as many blocks as fit on the card, at most K.
template <typename Kernel, typename... Args>
int launch(Kernel kern, int threads, size_t smem, int K, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = K < per_sm * sms ? K : per_sm * sms;
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool tma_allowed(const float* src, int W, int win) {
  return W % 2 == 0 && win % 2 == 0 && 2 * pitch(win) <= 256 && ((uintptr_t)src & 15u) == 0;
}

// Dynamic shared memory of each kernel: the alignment slack, the stages,
// then the histograms or the tiles and the reduction slots, then the two
// mbarriers.
size_t orient_smem(int route, int win) {
  return 128 + 2 * (size_t)stage_bytes(route, win) + ORI_BINS * ORI_NT * sizeof(float) + 16;
}

size_t desc_smem(int route, int win, int NT) {
  return 128 + 2 * (size_t)stage_bytes(route, win) +
         (DESC_NT / 32) * (32 * DESC_PX * desc_row(NT) * sizeof(uint16_t) + sizeof(float)) + 16;
}

// The checks both entry points share; builds the TMA route's tensor map.
int prepare(const float* src, int S, int H, int W, int win, int route, CUtensorMap* map) {
  if (S <= 0 || win <= 0 || win > MAX_WIN || win > H || win > W) return (int)cudaErrorInvalidValue;
  if (route < CP_ASYNC || route > DIRECT) return (int)cudaErrorInvalidValue;
  if (route == TMA) {
    if (!tma_allowed(src, W, win)) return (int)cudaErrorInvalidValue;
    return tensor_map(map, src, S, H, W, win);
  }
  return 0;
}

}  // namespace

// route: how windows reach the binning (enum Route): 0 = cp.async into
// shared memory, 1 = TMA (the caller checked that the stack allows it),
// 2 = read straight from the stack (for windows whose two stages do not
// fit in shared memory; a staged route that does not fit fails to launch).
extern "C" int apst_orient_hist(const float* src, int S, int H, int W, const int* lev,
                                const int* ys, const int* xs, const float* lx, const float* ly,
                                const float* srel, int K, int win, int route, float* out,
                                void* stream) {
  if (K <= 0) return 0;
  CUtensorMap map{};
  const int err = prepare(src, S, H, W, win, route, &map);
  if (err) return err;
  const Windows w{reinterpret_cast<const float2*>(src), H, W, lev, ys, xs, win};
  const size_t smem = orient_smem(route, win);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case TMA:
      return launch(orient_hist_kernel<TMA>, ORI_NT, smem, K, s, map, w, lx, ly, srel, K, out);
    case CP_ASYNC:
      return launch(orient_hist_kernel<CP_ASYNC>, ORI_NT, smem, K, s, map, w, lx, ly, srel, K, out);
    default:
      return launch(orient_hist_kernel<DIRECT>, ORI_NT, smem, K, s, map, w, lx, ly, srel, K, out);
  }
}

namespace {

template <int NT>
int launch_descriptor(int route, const CUtensorMap& map, const Windows& w, const float* lx,
                      const float* ly, const float* srel, const float* theta, int K,
                      const Grid& g, float* out, cudaStream_t s) {
  const size_t smem = desc_smem(route, w.win, NT);
  switch (route) {
    case TMA:
      return launch(descriptor_kernel<TMA, NT>, DESC_NT, smem, K, s, map, w, lx, ly, srel, theta,
                    K, g, out);
    case CP_ASYNC:
      return launch(descriptor_kernel<CP_ASYNC, NT>, DESC_NT, smem, K, s, map, w, lx, ly, srel,
                    theta, K, g, out);
    default:
      return launch(descriptor_kernel<DIRECT, NT>, DESC_NT, smem, K, s, map, w, lx, ly, srel,
                    theta, K, g, out);
  }
}

}  // namespace

// d x d cells (1 <= d <= 4), nbins orientation bins (1 <= nbins <= 16);
// out is (K, d d nbins).
extern "C" int apst_sift_descriptor(const float* src, int S, int H, int W, const int* lev,
                                    const int* ys, const int* xs, const float* lx,
                                    const float* ly, const float* srel, const float* theta, int K,
                                    int win, int d, int nbins, int route, float* out,
                                    void* stream) {
  if (K <= 0) return 0;
  if (d < 1 || d > 4 || nbins < 1 || nbins > 16) return (int)cudaErrorInvalidValue;
  CUtensorMap map{};
  const int err = prepare(src, S, H, W, win, route, &map);
  if (err) return err;
  const Windows w{reinterpret_cast<const float2*>(src), H, W, lev, ys, xs, win};
  // the reference's 2 wsig^2 with wsig = d / 2: exact in float32 for d <= 4
  const float gden = 0.5f * (float)(d * d);
  const Grid g{d, nbins, 0.5f * (float)d, (float)nbins, gden, 1.f / gden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nbins <= 8 ? launch_descriptor<1>(route, map, w, lx, ly, srel, theta, K, g, out, s)
                    : launch_descriptor<2>(route, map, w, lx, ly, srel, theta, K, g, out, s);
}
