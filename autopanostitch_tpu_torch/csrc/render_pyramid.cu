// The multiband pyramid's kernels: `mb_reduce` (one Gaussian level down)
// and `mb_collapse` (the blend and collapse of every level, one launch).
//
// Replaces what the JAX package computes in `multiband_blend`
// (autopanostitch_tpu/ops/blend.py:80, with `_blur_nc` :39, `_down2` :69,
// `_up2` :75): XLA fusions there, no Pallas kernel. The plain versions are
// `kernels/render.mb_reduce_plain` and `mb_collapse_plain`.
//
// What bounds them on an H100: bytes. `mb_reduce` reads level l once
// (level 0: the sampler's interleaved colours (B, C, h, w, 3) and raw
// weights (B, C, h, w)) and writes level l + 1 (B, C, 4, h/2, w/2);
// `mb_collapse` reads every level once and writes the uint8 tile and its
// coverage. Both do a few operations a byte, so the designs keep loads in
// flight while the block computes, keep every intermediate out of device
// memory and keep the shared-memory traffic a few words an output.
//
//  1. `mb_reduce`, one launch a level. A work item is one contributor's four
//     planes (R, G, B and the weight, normalised over the contributors at
//     level 0) over one kRTY x kRTX tile of the coarser level. A persistent
//     grid (one block an SM) walks the tiles; a block takes a tile's
//     contributors in turn, so its stages are (tile, contributor), and each
//     stage's source window comes into one of two shared buffers by
//     cp.async while the stage before it computes. Colour comes
//     in as contiguous rows of all three channels. Level 0 runs each tile's
//     contributors twice: first their weights only, summed element by
//     element into a shared plane (each thread sums the elements it copied
//     itself, so those stages need no barrier), then the full stages, which
//     normalise the weights by that sum once per element. The blur (2r + 1
//     taps, replicate borders) and the 2x antialiased linear resize fold
//     into one filter an axis (`kernels/render.folded_taps`, tables built on
//     the host per level), evaluated only at the coarser level's positions:
//     a pass along the rows (a lane a source row of one plane, conflict-free
//     with the row pitches below), then along the columns (a lane an output
//     column: coalesced stores). At sigma 1 (10 folded taps) an instance
//     keeps each output's taps in registers, reloads them only where they
//     change (`*_new`, at the borders), and runs two rows of planes a warp.
//     Each stage's tile tables come into its buffer with its window, so no
//     table load waits on the L2 (the window copies evict them from L1).
//  2. `mb_collapse`, one launch for every level. A work item is one
//     kCTY x kCTX tile of level 0 and its regions at the coarser levels
//     (`kernels/render.collapse_regions`: the rows and columns each finer
//     level's up2 reads). The block streams the contributors through two
//     shared buffers, a stage holding one contributor's planes at every
//     level over the item's regions; it runs up2 of each coarser level's
//     colour along the rows into shared memory and along the columns per
//     pixel, and accumulates sum_c (g_c - up2(g'_c)) w_c and sum_c w_c of
//     levels 0 and 1 in registers and of the coarser levels (at most one
//     pixel a thread) in shared memory, each thread its own words, so that
//     three blocks an SM hold them without spills. After the last
//     contributor it collapses coarse to fine in shared memory (up2 of the
//     coarser result plus the level's blend) and writes level 0's uint8
//     tile and coverage (or the float blend). Level 0's weights are normalised by their sum over the
//     contributors once a pixel, at the end (sum_c lap_c w_c / sum_c w_c),
//     not once a contributor. An item's regions and up2 tables are read into
//     shared memory once, at its first stage. No level's result reaches
//     device memory.
//
// Every output is written by one thread in a fixed order of contributors and
// taps, and no atomics: a tile's bytes do not depend on the tiles launched
// beside it. This file is compiled with FMA contraction (the default): the
// plain versions go through cuDNN and cuBLAS and are held within 1e-5.
//
// Variants for `tools/pyramid_probe.py` only (the `variant` argument; the
// main path passes 0): 1 runs the loads and the pipeline's waits and
// barriers with no arithmetic and no stores, 2 runs the arithmetic and the
// stores on the shared memory as it stands, with no loads but the tables'.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kEps = 1e-8f;
constexpr int kSmemMax = 232448;  // a block's shared memory on an H100

enum Variant { kWhole = 0, kLoadsOnly = 1, kComputeOnly = 2 };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(r, q) for each element of a rows x cols box: a warp a row, a lane a
// column; the same thread gets the same elements of the same box
template <int kWarps, typename F>
__device__ __forceinline__ void for_rows(int rows, int cols, F f) {
  const int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  for (int r = warp; r < rows; r += kWarps)
    for (int q = lane; q < cols; q += 32) f(r, q);
}

// a rows x cols box of a source whose rows are spitch floats apart into
// shared memory at dst + r dpitch + q dstride
template <int kWarps>
__device__ __forceinline__ void copy_rows(float* dst, int dpitch, int dstride, const float* src,
                                          size_t spitch, int rows, int cols) {
  const int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* s = src + static_cast<size_t>(r) * spitch;
    float* d = dst + r * dpitch;
    for (int q = lane; q < cols; q += 32) cp_async4(d + q * dstride, s + q);
  }
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ unsigned char to_u8(float v) {
  return static_cast<unsigned char>(clamp_to(v, 0.f, 1.f) * 255.f + 0.5f);
}

// ------------------------------------------------------------------ reduce

constexpr int kRThreads = 512, kRWarps = kRThreads / 32;
constexpr int kRTY = 16, kRTX = 32;  // a work item's tile of the coarser level
constexpr int kMid = kRTX + 1;  // the row pass's output pitch (odd: conflict-free)
constexpr int kFold = 10;  // the folded taps at sigma 1 (4 + 2 x 3): `fold`'s instance

struct ReduceArgs {
  const float* col;  // level 0: (B, C, h, w, 3)
  const float* w;  // level 0: (B, C, h, w), raw
  const float* planes;  // a coarser level: (B, C, 4, h, w)
  int C, h, w_, h2, w2;
  // the folded filters: output row j reads ny source rows from fy[j] with
  // taps ty[j, :] (fy_new[j]: they differ from row j - 1's); output column
  // i nx source columns from fx[i] with tx[i, :]
  const int* fy;
  const float* ty;
  const int* fy_new;
  int ny;
  const int* fx;
  const float* tx;
  const int* fx_new;
  int nx;
  int span_y, span_x;  // the largest source window of a tile
  int pitch_c, pitch_w;  // shared rows: colour (3 span_x, = 3 mod 32), weight (odd)
  int tiles_y, tiles_x, groups;
  float* out;  // (B, C, 4, h2, w2)
};

// the row pitches of a source window span_x wide: colour lanes f = 3 r + ch
// read f mod 32 distinct banks when the colour pitch is 3 mod 32
__host__ __device__ inline int pitch_c_of(int span_x) {
  return 3 * span_x + ((35 - 3 * span_x % 32) % 32);
}
__host__ __device__ inline int pitch_w_of(int span_x) { return span_x | 1; }

// a stage's copy of its tile's tables, after the window: along x the
// first sources, the new-taps flags (int bits) and the taps of kRTX
// outputs, then along y those of kRTY
__host__ __device__ inline int reduce_tab_floats(int ny, int nx) {
  return 2 * kRTX + kRTX * nx + 2 * kRTY + kRTY * ny;
}

// shared floats: two stage buffers (window and tables), the row pass's
// output, level 0's sums and their reciprocals
inline size_t reduce_smem_floats(int span_y, int span_x, int ny, int nx) {
  const size_t buf = static_cast<size_t>(span_y) * (pitch_c_of(span_x) + pitch_w_of(span_x)) +
                     reduce_tab_floats(ny, nx);
  return 2 * buf + 4 * static_cast<size_t>(span_y) * kMid +
         2 * static_cast<size_t>(span_y) * pitch_w_of(span_x);
}

struct RTile {
  int b, j0, i0, oy, ox;  // the outputs
  int ry0, sy, cx0, sx;  // their source window
};

struct RStage {
  int g, c;
  bool w;  // level 0's weights-only pass
};

__device__ __forceinline__ RTile reduce_tile(const ReduceArgs& a, int g) {
  const int per_b = a.tiles_y * a.tiles_x;
  RTile t;
  t.b = g / per_b;
  const int k = g - t.b * per_b;
  const int ty = k / a.tiles_x;
  t.j0 = ty * kRTY;
  t.i0 = (k - ty * a.tiles_x) * kRTX;
  const int j1 = min(t.j0 + kRTY, a.h2) - 1, i1 = min(t.i0 + kRTX, a.w2) - 1;
  t.oy = j1 - t.j0 + 1;
  t.ox = i1 - t.i0 + 1;
  t.ry0 = __ldg(a.fy + t.j0);
  t.sy = __ldg(a.fy + j1) + a.ny - t.ry0;
  t.cx0 = __ldg(a.fx + t.i0);
  t.sx = __ldg(a.fx + i1) + a.nx - t.cx0;
  return t;
}

__device__ __forceinline__ RStage reduce_next(const ReduceArgs& a, RStage s, bool level0) {
  if (s.c + 1 < a.C) return RStage{s.g, s.c + 1, s.w};
  if (s.w) return RStage{s.g, 0, false};
  return RStage{s.g + static_cast<int>(gridDim.x), 0, level0};
}

// the stage's tables in its buffer (`reduce_tab_floats`)
struct RTabs {
  const int* xf;
  const int* xn;
  const float* xt;
  const int* yf;
  const int* yn;
  const float* yt;
};

__device__ __forceinline__ RTabs reduce_tabs(const ReduceArgs& a, const float* buf) {
  const float* t = buf + a.span_y * (a.pitch_c + a.pitch_w);
  const float* y = t + 2 * kRTX + kRTX * a.nx;
  return RTabs{reinterpret_cast<const int*>(t), reinterpret_cast<const int*>(t + kRTX),
               t + 2 * kRTX, reinterpret_cast<const int*>(y),
               reinterpret_cast<const int*>(y + kRTY), y + 2 * kRTY};
}

// a stage's copies: its tile's tables (full stages) and (data) its window
template <bool kL0>
__device__ __forceinline__ void reduce_issue(const ReduceArgs& a, RStage s, const RTile& t,
                                             float* buf, bool data) {
  const size_t bc = static_cast<size_t>(t.b) * a.C + s.c;
  float* sw = buf + a.span_y * a.pitch_c;
  if (!s.w) {  // the tile's tables (a few words a thread), which the full stages read
    float* tx = sw + a.span_y * a.pitch_w;
    float* ty = tx + 2 * kRTX + kRTX * a.nx;
    const float* fx = reinterpret_cast<const float*>(a.fx + t.i0);
    const float* nx = reinterpret_cast<const float*>(a.fx_new + t.i0);
    const float* fy = reinterpret_cast<const float*>(a.fy + t.j0);
    const float* ny = reinterpret_cast<const float*>(a.fy_new + t.j0);
    const float* txs = a.tx + static_cast<size_t>(t.i0) * a.nx;
    const float* tys = a.ty + static_cast<size_t>(t.j0) * a.ny;
    const int nxt = t.ox * a.nx, nyt = t.oy * a.ny;
    for (int k = threadIdx.x; k < 2 * t.ox + nxt + 2 * t.oy + nyt; k += kRThreads) {
      if (k < t.ox) {
        cp_async4(tx + k, fx + k);
      } else if (k < 2 * t.ox) {
        cp_async4(tx + kRTX + k - t.ox, nx + k - t.ox);
      } else if (k < 2 * t.ox + nxt) {
        cp_async4(tx + 2 * kRTX + k - 2 * t.ox, txs + k - 2 * t.ox);
      } else {
        const int e = k - 2 * t.ox - nxt;
        if (e < t.oy)
          cp_async4(ty + e, fy + e);
        else if (e < 2 * t.oy)
          cp_async4(ty + kRTY + e - t.oy, ny + e - t.oy);
        else
          cp_async4(ty + 2 * kRTY + e - 2 * t.oy, tys + e - 2 * t.oy);
      }
    }
  }
  if (!data) return;
  if (kL0) {
    copy_rows<kRWarps>(sw, a.pitch_w, 1, a.w + (bc * a.h + t.ry0) * a.w_ + t.cx0, a.w_, t.sy,
                       t.sx);
    if (!s.w)
      copy_rows<kRWarps>(buf, a.pitch_c, 1, a.col + ((bc * a.h + t.ry0) * a.w_ + t.cx0) * 3,
                         3 * static_cast<size_t>(a.w_), t.sy, 3 * t.sx);
    return;
  }
  const size_t hw = static_cast<size_t>(a.h) * a.w_;
  const float* src = a.planes + bc * 4 * hw + static_cast<size_t>(t.ry0) * a.w_ + t.cx0;
  for (int p = 0; p < 3; ++p)
    copy_rows<kRWarps>(buf + p, a.pitch_c, 3, src + p * hw, a.w_, t.sy, t.sx);
  copy_rows<kRWarps>(sw, a.pitch_w, 1, src + 3 * hw, a.w_, t.sy, t.sx);
}

// The folded filter of kN taps along kLines lines at once, outputs k0 .. k1
// - 1 in order: output k reads each line from first[k] - origin with taps
// taps[k, :]. The taps stay in registers and are reloaded only where
// fresh[k] says they change (at the borders); two partial sums (even and
// odd taps) halve the chain of dependent FMAs. ld(line, q) reads source q
// of a line, st(line, k, v) writes its output k; the tables are the tile's
// copies in shared memory, indexed by k.
template <int kN, int kLines, typename Ld, typename St>
__device__ __forceinline__ void fold(int k0, int k1, const int* first, const float* taps,
                                     const int* fresh, int origin, Ld ld, St st) {
  float t[kN];
  for (int k = k0; k < k1; ++k) {
    const int ok = first[k] - origin;
    if (k == k0 || fresh[k]) {
#pragma unroll
      for (int m = 0; m < kN; ++m) t[m] = taps[k * kN + m];
    }
#pragma unroll
    for (int ln = 0; ln < kLines; ++ln) {
      float even = 0.f, odd = 0.f;
#pragma unroll
      for (int m = 0; m < kN; m += 2) {
        even = fmaf(t[m], ld(ln, ok + m), even);
        odd = fmaf(t[m + 1], ld(ln, ok + m + 1), odd);
      }
      st(ln, k, even + odd);
    }
  }
}

// the folded filter along the rows: mid[f][i] for each row-plane f of the
// window (f = 3 r + ch for colour, 3 sy + r for the weight) and output
// column i. kN > 0: a warp two chunks of 32 row-planes (f and f + 32) and a
// range of columns (`fold`); kN = 0 (any tap count): a warp 32 row-planes
// and one column at a time.
__device__ __forceinline__ int row_plane(const ReduceArgs& a, const RTile& t, int f, int& stride) {
  if (f < 3 * t.sy) {
    const int r = f / 3;
    stride = 3;
    return r * a.pitch_c + (f - 3 * r);
  }
  stride = 1;
  return a.span_y * a.pitch_c + (f - 3 * t.sy) * a.pitch_w;
}

template <int kN>
__device__ __forceinline__ void reduce_rows(const ReduceArgs& a, const RTile& t, const float* buf,
                                            const RTabs& tb, float* mid) {
  const int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  const int rp = 4 * t.sy, chunks = (rp + 31) >> 5;
  if constexpr (kN > 0) {
    const int pairs = (chunks + 1) >> 1, ranges = max(1, kRWarps / pairs);
    for (int u = warp; u < pairs * ranges; u += kRWarps) {
      const int pair = u % pairs, range = u / pairs;
      int f[2], base[2], stride[2];
#pragma unroll
      for (int ln = 0; ln < 2; ++ln) {
        f[ln] = pair * 64 + ln * 32 + lane;
        base[ln] = row_plane(a, t, min(f[ln], rp - 1), stride[ln]);
      }
      const int ib = range * t.ox / ranges, ie = (range + 1) * t.ox / ranges;
      fold<kN, 2>(
          ib, ie, tb.xf, tb.xt, tb.xn, t.cx0,
          [&](int ln, int q) { return buf[base[ln] + q * stride[ln]]; },
          [&](int ln, int i, float v) {
            if (f[ln] < rp) mid[f[ln] * kMid + i] = v;
          });
    }
  } else {
    for (int chunk = warp; chunk < chunks; chunk += kRWarps) {
      const int f = chunk * 32 + lane;
      int stride;
      const int base = row_plane(a, t, min(f, rp - 1), stride);
      for (int i = 0; i < t.ox; ++i) {
        const float* sp = buf + base + (tb.xf[i] - t.cx0) * stride;
        const float* tp = tb.xt + i * a.nx;
        float acc = 0.f;
        for (int m = 0; m < a.nx; ++m) acc = fmaf(tp[m], sp[m * stride], acc);
        if (f < rp) mid[f * kMid + i] = acc;
      }
    }
  }
}

// the folded filter along the columns, from mid to the level's planes: a
// lane an output column, a warp one plane's range of output rows
template <int kN>
__device__ __forceinline__ void reduce_cols(const ReduceArgs& a, const RTile& t, int c,
                                            const RTabs& tb, const float* mid) {
  const int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  constexpr int kRanges = kRWarps / 4;
  for (int u = warp; u < 4 * kRanges; u += kRWarps) {
    const int p = u & 3, range = u >> 2;
    const int jb = range * t.oy / kRanges, je = (range + 1) * t.oy / kRanges;
    const int fbase = p < 3 ? p : 3 * t.sy, fs = p < 3 ? 3 : 1;
    float* out = a.out + ((static_cast<size_t>(t.b * a.C + c) * 4 + p) * a.h2 + t.j0) * a.w2 +
                 t.i0 + lane;
    const float* col = mid + fbase * kMid + lane;
    if constexpr (kN > 0) {
      fold<kN, 1>(
          jb, je, tb.yf, tb.yt, tb.yn, t.ry0,
          [&](int, int r) { return col[r * fs * kMid]; },
          [&](int, int j, float v) {
            if (lane < t.ox) out[static_cast<size_t>(j) * a.w2] = v;
          });
    } else {
      for (int j = jb; j < je; ++j) {
        const int r0 = tb.yf[j] - t.ry0;
        const float* tp = tb.yt + j * a.ny;
        float acc = 0.f;
        for (int m = 0; m < a.ny; ++m) acc = fmaf(tp[m], col[(r0 + m) * fs * kMid], acc);
        if (lane < t.ox) out[static_cast<size_t>(j) * a.w2] = acc;
      }
    }
  }
}

template <bool kL0, int kVariant, int kN>
__global__ void __launch_bounds__(kRThreads, 1)
    mb_reduce_kernel(const __grid_constant__ ReduceArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int buf_floats = a.span_y * (a.pitch_c + a.pitch_w) + reduce_tab_floats(a.ny, a.nx);
  float* const mid = smem + 2 * buf_floats;  // (4 span_y, kMid)
  float* const wsum = mid + 4 * a.span_y * kMid;  // level 0: (span_y, pitch_w) sums
  float* const winv = wsum + a.span_y * a.pitch_w;  // ... and their reciprocals
  if (kVariant == kComputeOnly) {
    const int n = 2 * buf_floats + 4 * a.span_y * kMid + 2 * a.span_y * a.pitch_w;
    for (int k = threadIdx.x; k < n; k += kRThreads) smem[k] = 0.5f;
    __syncthreads();
  }
  RStage s{static_cast<int>(blockIdx.x), 0, kL0};
  if (s.g >= a.groups) return;
  RTile t = reduce_tile(a, s.g);
  RStage ahead = s;  // the last stage issued, and its tile
  RTile at = t;
  auto advance = [&]() {  // a tile's geometry is read once, when its group comes up
    const RStage n = reduce_next(a, ahead, kL0);
    if (n.g != ahead.g && n.g < a.groups) at = reduce_tile(a, n.g);
    ahead = n;
    return n.g < a.groups;
  };
  // the arithmetic-only variant copies the tables alone
  constexpr bool kData = kVariant != kComputeOnly;
  reduce_issue<kL0>(a, ahead, at, smem, kData);
  cp_commit();
  for (int kb = 0;; kb ^= 1) {  // stage computes in buffer kb while the next loads into the other
    float* const buf = smem + kb * buf_floats;
    float* const sw = buf + a.span_y * a.pitch_c;
    float* const next_buf = smem + (kb ^ 1) * buf_floats;
    const RStage n = reduce_next(a, s, kL0);
    const bool more = n.g < a.groups;
    if (s.w) {
      // the stage issued next writes only this thread's weight elements of
      // the buffer it reuses (the same tile), or colour rows and tables that
      // no weights-only stage reads; only the first weights-only stage of a
      // tile follows full stages, whose column pass reads their tables
      if (s.c == 0) __syncthreads();
      if (advance()) reduce_issue<kL0>(a, ahead, at, next_buf, kData);
      cp_commit();
      cp_wait<1>();
      if (kVariant != kLoadsOnly)
        for_rows<kRWarps>(t.sy, t.sx, [&](int r, int q) {
          const int i = r * a.pitch_w + q;
          // the last contributor's stage keeps max(sum, eps) and its
          // reciprocal (0 where the sum is at most eps)
          const float sum = (s.c == 0 ? 0.f : wsum[i]) + sw[i];
          if (s.c + 1 < a.C) {
            wsum[i] = sum;
          } else {
            wsum[i] = fmaxf(sum, kEps);
            winv[i] = sum > kEps ? 1.f / fmaxf(sum, kEps) : 0.f;
          }
        });
    } else {
      cp_wait<0>();
      if (kL0 && kVariant != kLoadsOnly)  // normalise the weights this thread copied
        for_rows<kRWarps>(t.sy, t.sx, [&](int r, int q) {
          // w / sum, rounded as the division rounds it: the quotient from
          // the reciprocal, corrected by its exact residual
          const int i = r * a.pitch_w + q;
          const float q0 = sw[i] * winv[i];
          sw[i] = fmaf(fmaf(-q0, wsum[i], sw[i]), winv[i], q0);
        });
      __syncthreads();  // the stage's window is in; the stage before it is done
      if (advance()) reduce_issue<kL0>(a, ahead, at, next_buf, kData);
      cp_commit();
      const RTabs tb = reduce_tabs(a, buf);
      if (kVariant != kLoadsOnly) reduce_rows<kN>(a, t, buf, tb, mid);
      __syncthreads();
      if (kVariant != kLoadsOnly) reduce_cols<kN>(a, t, s.c, tb, mid);
    }
    if (!more) break;
    if (n.g != s.g) t = reduce_tile(a, n.g);
    s = n;
  }
  cp_wait<0>();
}

// --------------------------------------------------------------- collapse

constexpr int kCThreads = 256, kCWarps = kCThreads / 32;
constexpr int kCTY = 16, kCTX = 64;  // a work item's tile of level 0
constexpr int kRows0 = kCTY * kCTX / kCThreads;  // level-0 pixels a thread: one column, 4 rows
constexpr int kSlots1 = 2;  // level-1 pixels a thread (its region holds at most 512)
constexpr int kMaxLevels = 8;  // levels >= 2: one pixel a thread (at most 256), sums in A
constexpr int kMaxUp = 2;  // taps of a 2x linear up along one axis

struct CLevel {
  const float* planes;  // levels >= 1: (B, C, 4, h, w)
  const int* rows;  // (tiles_y, 2): each tile row's region at this level, first row and count
  const int* cols;  // (tiles_x, 2)
  // up2 from the next coarser level (l < L - 1): row y reads ny rows of
  // it from fy[y] with taps ty[y, :]; column x nx columns from fx[x]
  const int* fy;
  const float* ty;
  const int* fx;
  const float* tx;
  int h, w, ny, nx;
  int off;  // the level's planes in a stage buffer (floats)
  int aoff;  // levels >= 2: its sums in A (floats), 4 planes of `an`
  int an;  // levels >= 2: the largest region's pixels
  int voff;  // its up2 rows (of the next coarser level's colour) in V
  int toff;  // its up2 taps for the item's region in an item's tables: rows, then columns
};

struct CollapseArgs {
  const float* col;  // level 0: (B, C, H, W, 3)
  const float* w;  // level 0: (B, C, H, W), raw
  int C, L, tiles_y, tiles_x, items;
  int buf_floats, v_floats, o_floats;  // shared memory: two stages, the up2 rows, two results
  int tab_floats;  // and two items' up2 tables (`Up`, 4 floats a row or column), then A
  int kind;  // 1: the float blend, 2: the uint8 tile and its coverage
  float* out;  // kind 1: (B, H, W, 3)
  unsigned char* u8;  // kind 2: (B, H, W, 3)
  unsigned char* covered;  // kind 2: (B, H, W)
  CLevel lv[kMaxLevels];
};

struct Region {
  int r0, rh, c0, cw;
};

__device__ __forceinline__ Region region(const CLevel& v, int ty, int tx) {
  return Region{__ldg(v.rows + 2 * ty), __ldg(v.rows + 2 * ty + 1), __ldg(v.cols + 2 * tx),
                __ldg(v.cols + 2 * tx + 1)};
}

__device__ __forceinline__ void item_tile(const CollapseArgs& a, int item, int& b, int& ty,
                                          int& tx) {
  const int per_b = a.tiles_y * a.tiles_x;
  b = item / per_b;
  const int k = item - b * per_b;
  ty = k / a.tiles_x;
  tx = k - ty * a.tiles_x;
}

// one contributor's planes at every level over the item's regions: level 0
// colour interleaved ((r cw + x) 3 + ch) then its raw weights at 3 n, a
// coarser level's four planes at ch n
// (reg: the item's regions where they are in shared memory, else null)
__device__ __forceinline__ void collapse_issue(const CollapseArgs& a, int item, int c,
                                               const int4* reg, float* buf) {
  int b, ty, tx;
  item_tile(a, item, b, ty, tx);
  const size_t bc = static_cast<size_t>(b) * a.C + c;
  for (int l = 0; l < a.L; ++l) {
    const CLevel& v = a.lv[l];
    const Region g = reg ? Region{reg[l].x, reg[l].y, reg[l].z, reg[l].w} : region(v, ty, tx);
    const int n = g.rh * g.cw;
    float* dst = buf + v.off;
    if (l == 0) {
      copy_rows<kCWarps>(dst, 3 * g.cw, 1, a.col + ((bc * v.h + g.r0) * v.w + g.c0) * 3,
                         3 * static_cast<size_t>(v.w), g.rh, 3 * g.cw);
      copy_rows<kCWarps>(dst + 3 * n, g.cw, 1, a.w + (bc * v.h + g.r0) * v.w + g.c0, v.w, g.rh,
                         g.cw);
    } else {
      const size_t hw = static_cast<size_t>(v.h) * v.w;
      const float* src = v.planes + bc * 4 * hw + static_cast<size_t>(g.r0) * v.w + g.c0;
      for (int p = 0; p < 4; ++p)
        copy_rows<kCWarps>(dst + p * n, g.cw, 1, src + p * hw, v.w, g.rh, g.cw);
    }
  }
}

// one row's or column's up2 from the next coarser level: its first source
// (relative to the coarser region), the second (the same where one tap),
// and their taps
struct Up {
  int f, f1;
  float t0, t1;
};

__device__ __forceinline__ Up up_of(const int* first, const float* taps, int n, int i, int origin) {
  const bool two = n > 1;
  const int f = __ldg(first + i) - origin;
  return Up{f, two ? f + 1 : f, __ldg(taps + static_cast<size_t>(i) * n),
            two ? __ldg(taps + static_cast<size_t>(i) * n + 1) : 0.f};
}

// the item's up2 tables of every level but the coarsest, into tab (its
// rows' `Up`, then its columns')
__device__ __forceinline__ void up_tables(const CollapseArgs& a, int ty, int tx, Up* tab) {
  for (int l = 0; l + 1 < a.L; ++l) {
    const CLevel& v = a.lv[l];
    const Region g = region(v, ty, tx), cg = region(a.lv[l + 1], ty, tx);
    Up* t = tab + v.toff;
    for (int e = threadIdx.x; e < g.rh + g.cw; e += kCThreads)
      t[e] = e < g.rh ? up_of(v.fy, v.ty, v.ny, g.r0 + e, cg.r0)
                      : up_of(v.fx, v.tx, v.nx, g.c0 + e - g.rh, cg.c0);
  }
}

// up2 along the rows: V[ch][r][q] for the rh rows of level l's region and
// the cw' columns of level l + 1's, from three planes X (rh' x cw' each);
// a warp a row of one plane
__device__ __forceinline__ void up_rows(const Region& g, const Region& cg, const Up* rows,
                                        const float* X, float* V) {
  const int warp = static_cast<int>(threadIdx.x) >> 5, lane = static_cast<int>(threadIdx.x) & 31;
  const int n = cg.rh * cg.cw;
  for (int ch = 0; ch < 3; ++ch)
    for (int r = warp; r < g.rh; r += kCWarps) {
      const Up u = rows[r];
      const float* x = X + ch * n;
      float* o = V + (ch * g.rh + r) * cg.cw;
      for (int q = lane; q < cg.cw; q += 32)
        o[q] = fmaf(u.t1, x[u.f1 * cg.cw + q], u.t0 * x[u.f * cg.cw + q]);
    }
}

// up2 at row r and column u of level l's region, from V (3 planes of
// g.rh x cg.cw)
__device__ __forceinline__ void up_at(const Up& u, const float* V, int rh, int cw, int r,
                                      float (&up)[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* row = V + (ch * rh + r) * cw;
    up[ch] = fmaf(u.t1, row[u.f1], u.t0 * row[u.f]);
  }
}

// a coarser level's pixel p (l >= 1): accumulate the stage's contributor,
// or at the item's end (finish) write up2 of the coarser result plus the
// level's blend into Ol
template <bool kFinish>
__device__ __forceinline__ void level_pixel(const CollapseArgs& a, int l, const int4* reg,
                                            const Up* tab, const float* buf, const float* V,
                                            int p, float (&num)[3], float& den, float* Ol) {
  const CLevel& v = a.lv[l];
  const Region g{reg[l].x, reg[l].y, reg[l].z, reg[l].w};
  const int n = g.rh * g.cw;
  if (p >= n) return;
  float up[3] = {0.f, 0.f, 0.f};
  if (l + 1 < a.L) {
    const int r = p / g.cw;
    up_at(tab[v.toff + g.rh + p - r * g.cw], V + v.voff, g.rh, reg[l + 1].w, r, up);
  }
  if (kFinish) {
    const float d = fmaxf(den, kEps);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) Ol[ch * n + p] = up[ch] + num[ch] / d;
    return;
  }
  const float* lv = buf + v.off;
  const float wv = lv[3 * n + p];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) num[ch] = fmaf(lv[ch * n + p] - up[ch], wv, num[ch]);
  den = den + wv;
}

template <int kVariant>
__global__ void __launch_bounds__(kCThreads, 3)
    mb_collapse_kernel(const __grid_constant__ CollapseArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int4 regions[2][kMaxLevels];  // the item's regions, by item parity
  float* const V = smem + 2 * a.buf_floats;  // every level's up2 rows
  float* const O = V + a.v_floats;  // two levels' results, level l's at (l & 1) o_floats
  Up* const tabs = reinterpret_cast<Up*>(O + 2 * a.o_floats);  // the item's up2 tables, by parity
  float* const A = O + 2 * a.o_floats + 2 * a.tab_floats;  // the sums of levels >= 2
  if (kVariant == kComputeOnly) {
    const int n = 2 * a.buf_floats + a.v_floats + 2 * a.o_floats;
    for (int k = threadIdx.x; k < n; k += kCThreads) smem[k] = 0.5f;
    __syncthreads();
  }
  int item = static_cast<int>(blockIdx.x);
  if (item >= a.items) return;
  const int tid = static_cast<int>(threadIdx.x);
  constexpr int kStep0 = kCThreads / kCTX;
  const int x0 = tid % kCTX, y0 = tid / kCTX;  // level 0: a column, rows y0 + kStep0 q
  float n0[kRows0][3], d0[kRows0], n1[kSlots1][3], d1[kSlots1];
  Region g0{}, g1{};
  int b = 0, par = 0;
  if (kVariant != kComputeOnly) collapse_issue(a, item, 0, nullptr, smem);
  cp_commit();
  for (int c = 0, kb = 0;;) {
    const float* const buf = smem + kb * a.buf_floats;
    const int next_item = c + 1 < a.C ? item : item + static_cast<int>(gridDim.x);
    const int next_c = c + 1 < a.C ? c + 1 : 0;
    const bool more = next_item < a.items;
    if (c == 0) {  // a new item: its regions, level 0's up2 columns, zero sums
      int ty, tx;
      item_tile(a, item, b, ty, tx);
      par ^= 1;
      if (tid < a.L) {
        const Region g = region(a.lv[tid], ty, tx);
        regions[par][tid] = make_int4(g.r0, g.rh, g.c0, g.cw);
      }
      up_tables(a, ty, tx, tabs + par * (a.tab_floats / 4));
      g0 = region(a.lv[0], ty, tx);
      if (a.L > 1) g1 = region(a.lv[1], ty, tx);
#pragma unroll
      for (int q = 0; q < kRows0; ++q) n0[q][0] = n0[q][1] = n0[q][2] = d0[q] = 0.f;
#pragma unroll
      for (int q = 0; q < kSlots1; ++q) n1[q][0] = n1[q][1] = n1[q][2] = d1[q] = 0.f;
      for (int l = 2; l < a.L; ++l) {  // each thread its own sums: no barrier
        const CLevel& v = a.lv[l];
        if (tid < v.an)
          for (int k = 0; k < 4; ++k) A[v.aoff + k * v.an + tid] = 0.f;
      }
    }
    const int4* const reg = regions[par];
    const Up* const tab = tabs + par * (a.tab_floats / 4);
    cp_wait<0>();
    __syncthreads();  // the stage's data and the regions are in; the stage before is done
    if (more && kVariant != kComputeOnly)
      collapse_issue(a, next_item, next_c, next_item == item ? reg : nullptr,
                     smem + (kb ^ 1) * a.buf_floats);
    cp_commit();
    if (kVariant != kLoadsOnly)
      for (int l = 0; l + 1 < a.L; ++l)
        up_rows(Region{reg[l].x, reg[l].y, reg[l].z, reg[l].w},
                Region{reg[l + 1].x, reg[l + 1].y, reg[l + 1].z, reg[l + 1].w},
                tab + a.lv[l].toff, buf + a.lv[l + 1].off, V + a.lv[l].voff);
    __syncthreads();
    if (kVariant != kLoadsOnly) {
      if (x0 < g0.cw) {  // level 0: raw weights, normalised at the end
        const int n = g0.rh * g0.cw;
#pragma unroll
        for (int q = 0; q < kRows0; ++q) {
          const int r = y0 + kStep0 * q;
          if (r >= g0.rh) continue;
          float up[3] = {0.f, 0.f, 0.f};
          if (a.L > 1) up_at(tab[g0.rh + x0], V + a.lv[0].voff, g0.rh, g1.cw, r, up);
          const int p = r * g0.cw + x0;
          const float wv = buf[3 * n + p];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            n0[q][ch] = fmaf(buf[3 * p + ch] - up[ch], wv, n0[q][ch]);
          d0[q] = d0[q] + wv;
        }
      }
      if (a.L > 1) {
#pragma unroll
        for (int q = 0; q < kSlots1; ++q)
          level_pixel<false>(a, 1, reg, tab, buf, V, tid + q * kCThreads, n1[q], d1[q], nullptr);
      }
      for (int l = 2; l < a.L; ++l) {
        const CLevel& v = a.lv[l];
        if (tid >= v.an) continue;
        float* const s = A + v.aoff + tid;
        float num[3] = {s[0], s[v.an], s[2 * v.an]}, den = s[3 * v.an];
        level_pixel<false>(a, l, reg, tab, buf, V, tid, num, den, nullptr);
        s[0] = num[0], s[v.an] = num[1], s[2 * v.an] = num[2], s[3 * v.an] = den;
      }
    }
    if (c + 1 == a.C) {  // the item's collapse, coarse to fine
#pragma unroll
      for (int l = kMaxLevels - 1; l >= 0; --l) {
        if (l >= a.L) continue;
        __syncthreads();  // the accumulation (or the coarser level) is done: V is free
        const CLevel& v = a.lv[l];
        float* const Ol = O + (l & 1) * a.o_floats;
        if (l + 1 < a.L) {
          if (kVariant != kLoadsOnly)
            up_rows(Region{reg[l].x, reg[l].y, reg[l].z, reg[l].w},
                    Region{reg[l + 1].x, reg[l + 1].y, reg[l + 1].z, reg[l + 1].w},
                    tab + v.toff, O + ((l + 1) & 1) * a.o_floats, V + v.voff);
          __syncthreads();
        }
        if (kVariant == kLoadsOnly) continue;
        if (l >= 2) {
          if (tid < v.an) {
            const float* const s = A + v.aoff + tid;
            float num[3] = {s[0], s[v.an], s[2 * v.an]}, den = s[3 * v.an];
            level_pixel<true>(a, l, reg, tab, nullptr, V, tid, num, den, Ol);
          }
        } else if (l == 1) {
#pragma unroll
          for (int q = 0; q < kSlots1; ++q)
            level_pixel<true>(a, 1, reg, tab, nullptr, V, tid + q * kCThreads, n1[q], d1[q], Ol);
        } else if (x0 < g0.cw) {
#pragma unroll
          for (int q = 0; q < kRows0; ++q) {
            const int r = y0 + kStep0 * q;
            if (r >= g0.rh) continue;
            float up[3] = {0.f, 0.f, 0.f};
            if (a.L > 1) up_at(tab[g0.rh + x0], V + v.voff, g0.rh, g1.cw, r, up);
            const float s = d0[q];  // the raw weights' sum
            float val[3];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) val[ch] = up[ch] + (s > kEps ? n0[q][ch] / s : 0.f);
            const size_t o = (static_cast<size_t>(b) * v.h + g0.r0 + r) * v.w + g0.c0 + x0;
            const float blended = s > kEps ? 1.f : 0.f;
            if (a.kind == 1) {
#pragma unroll
              for (int ch = 0; ch < 3; ++ch)
                a.out[3 * o + ch] = clamp_to(val[ch], 0.f, 1.f) * blended;
            } else {
              const bool cov = s > 1e-3f;  // as the renderer finishes a tile
#pragma unroll
              for (int ch = 0; ch < 3; ++ch)
                a.u8[3 * o + ch] =
                    to_u8((clamp_to(val[ch], 0.f, 1.f) * blended) * (cov ? 1.f : 0.f));
              a.covered[o] = cov ? 1 : 0;
            }
          }
        }
      }
    }
    if (!more) break;
    item = next_item;
    c = next_c;
    kb ^= 1;
  }
  cp_wait<0>();
}

// a persistent grid: as many blocks as fit on the card, at most `items`
template <typename Kernel, typename Args>
int launch(Kernel kern, int threads, size_t smem, int items, cudaStream_t stream,
           const Args& args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = items < per_sm * sms ? items : per_sm * sms;
  kern<<<grid, threads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <bool kL0, int kN>
int launch_reduce(const ReduceArgs& a, size_t smem, int variant, cudaStream_t s) {
  if (variant == kLoadsOnly)
    return launch(mb_reduce_kernel<kL0, kLoadsOnly, kN>, kRThreads, smem, a.groups, s, a);
  if (variant == kComputeOnly)
    return launch(mb_reduce_kernel<kL0, kComputeOnly, kN>, kRThreads, smem, a.groups, s, a);
  return launch(mb_reduce_kernel<kL0, kWhole, kN>, kRThreads, smem, a.groups, s, a);
}

}  // namespace

// One level down: level (h, w_) -> out (B, C, 4, h2, w2). col / w give level
// 0 (planes null), planes a coarser one (col, w null). fy / ty (h2, ny) and
// fx / tx (w2, nx) are the folded blur-and-resize tables, fy_new / fx_new
// 1 where an output's taps differ from the one before; span_y / span_x the
// largest source window of a kRTY x kRTX output tile.
extern "C" int apst_mb_reduce(const float* col, const float* w, const float* planes, int B,
                              int C, int h, int w_, int h2, int w2, const int* fy,
                              const float* ty, const int* fy_new, int ny, const int* fx,
                              const float* tx, const int* fx_new, int nx, int span_y, int span_x,
                              float* out, int variant, void* stream) {
  const long long groups = static_cast<long long>(B) * ((h2 + kRTY - 1) / kRTY) *
                           ((w2 + kRTX - 1) / kRTX);
  const bool level0 = planes == nullptr;
  if (B < 1 || C < 1 || h < 1 || w_ < 1 || h2 < 1 || w2 < 1 || ny < 1 || nx < 1 ||
      span_y < ny || span_x < nx || span_y > h || span_x > w_ || variant < 0 || variant > 2 ||
      groups > 0x7fffffffLL || (level0 && (col == nullptr || w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = reduce_smem_floats(span_y, span_x, ny, nx) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  ReduceArgs a{col, w, planes, C, h, w_, h2, w2, fy, ty, fy_new, ny, fx, tx, fx_new, nx, span_y,
               span_x, pitch_c_of(span_x), pitch_w_of(span_x), (h2 + kRTY - 1) / kRTY,
               (w2 + kRTX - 1) / kRTX, static_cast<int>(groups), out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fold = ny == kFold && nx == kFold;  // the sliding-window instance
  if (level0)
    return fold ? launch_reduce<true, kFold>(a, smem, variant, s)
                : launch_reduce<true, 0>(a, smem, variant, s);
  return fold ? launch_reduce<false, kFold>(a, smem, variant, s)
              : launch_reduce<false, 0>(a, smem, variant, s);
}

// The whole collapse, one launch: levels 0 .. L - 1 of (B, C) contributors,
// level 0 as col (B, C, H, W, 3) and raw weights w (B, C, H, W), the coarser
// ones as `mb_reduce`'s planes. Host arrays, per level l: ptrs[7 l ..] =
// planes (null at level 0), rows, cols (the kCTY x kCTX tiles' regions),
// fy, ty, fx, tx (up2 from level l + 1; null at the coarsest); ints[6 l ..]
// = h, w, ny, nx, the largest region's rows and columns. kind 1 writes the
// float blend out (B, H, W, 3), kind 2 the uint8 tile u8 (B, H, W, 3) and
// covered (B, H, W).
extern "C" int apst_mb_collapse(const float* col, const float* w, int B, int C, int L,
                                const void* const* ptrs, const int* ints, int kind, float* out,
                                unsigned char* u8, unsigned char* covered, int variant,
                                void* stream) {
  if (B < 1 || C < 1 || L < 1 || L > kMaxLevels || (kind != 1 && kind != 2) ||
      (kind == 1 && out == nullptr) || (kind == 2 && (u8 == nullptr || covered == nullptr)) ||
      col == nullptr || w == nullptr || variant < 0 || variant > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CollapseArgs a{};
  a.col = col;
  a.w = w;
  a.C = C;
  a.L = L;
  a.kind = kind;
  a.out = out;
  a.u8 = u8;
  a.covered = covered;
  long long buf = 0, vf = 0, of = 0, tf = 0, af = 0;
  for (int l = 0; l < L; ++l) {
    CLevel& v = a.lv[l];
    const void* const* p = ptrs + 7 * l;
    const int* n = ints + 6 * l;
    v.planes = static_cast<const float*>(p[0]);
    v.rows = static_cast<const int*>(p[1]);
    v.cols = static_cast<const int*>(p[2]);
    v.fy = static_cast<const int*>(p[3]);
    v.ty = static_cast<const float*>(p[4]);
    v.fx = static_cast<const int*>(p[5]);
    v.tx = static_cast<const float*>(p[6]);
    v.h = n[0];
    v.w = n[1];
    v.ny = n[2];
    v.nx = n[3];
    const long long px = static_cast<long long>(n[4]) * n[5];
    const long long cap = l == 0 ? kCTY * kCTX : l == 1 ? kSlots1 * kCThreads : kCThreads;
    if (v.h < 1 || v.w < 1 || v.rows == nullptr || v.cols == nullptr || px > cap ||
        (l == 0 && (n[4] > kCTY || n[5] > kCTX)) || (l > 0 && v.planes == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    v.off = static_cast<int>(buf);
    buf += 4 * px;
    if (l >= 2) {
      v.aoff = static_cast<int>(af);
      v.an = static_cast<int>(px);
      af += 4 * px;
    }
    if (l + 1 < L) {
      const int* nc = ints + 6 * (l + 1);
      if (v.fy == nullptr || v.ty == nullptr || v.fx == nullptr || v.tx == nullptr ||
          v.ny < 1 || v.ny > kMaxUp || v.nx < 1 || v.nx > kMaxUp)
        return static_cast<int>(cudaErrorInvalidValue);
      v.voff = static_cast<int>(vf);
      vf += 3LL * n[4] * nc[5];
      v.toff = static_cast<int>(tf / 4);
      tf += 4LL * (n[4] + n[5]);
    }
    if (l > 0) of = of > 3 * px ? of : 3 * px;
  }
  a.tiles_y = (a.lv[0].h + kCTY - 1) / kCTY;
  a.tiles_x = (a.lv[0].w + kCTX - 1) / kCTX;
  const long long items = static_cast<long long>(B) * a.tiles_y * a.tiles_x;
  const size_t smem = static_cast<size_t>(2 * buf + vf + 2 * of + 2 * tf + af) * sizeof(float);
  if (items > 0x7fffffffLL || smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  a.items = static_cast<int>(items);
  a.buf_floats = static_cast<int>(buf);
  a.v_floats = static_cast<int>(vf);
  a.o_floats = static_cast<int>(of);
  a.tab_floats = static_cast<int>(tf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kLoadsOnly)
    return launch(mb_collapse_kernel<kLoadsOnly>, kCThreads, smem, a.items, s, a);
  if (variant == kComputeOnly)
    return launch(mb_collapse_kernel<kComputeOnly>, kCThreads, smem, a.items, s, a);
  return launch(mb_collapse_kernel<kWhole>, kCThreads, smem, a.items, s, a);
}
