// Exact k-nearest-neighbour search (squared L2) for descriptor matching, in
// two modes that share one tile loop.
//
// Replaces the TPU kernel `two_nn_pallas` (autopanostitch_tpu/ops/pallas/
// match_kernel.py:129, body `_kernel` :45) and the XLA bodies it stood in
// for: the pooled `global_knn` (autopanostitch_tpu/ops/matching.py:253) and
// the per-pair `two_nn` of `match_pair` (matching.py:65, :89). For each
// query row it finds the k targets with the smallest
//   d = max(|q|^2 + |t|^2 - 2 q.t, 0).
// Masked targets get d = 1e18 and still compete. Ties keep the lower target
// index, as jax.lax.top_k does, so a row with fewer than k valid targets is
// filled with the lowest-index masked targets exactly like the reference.
// Only (rows, k) indices and distances are written: no distance matrix
// reaches device memory.
//
// Modes (the `Rule` template parameter of `knn_tile`):
// - pooled (`apst_knn`): one query set against one target set. A target is
//   masked when it lies in the query's image (tid == qid), is invalid
//   (tid == -2), the query is invalid (qid == -2), or it IS the query
//   (index == self_idx).
// - pair list (`apst_knn_pairs`): N images of Kc descriptor slots, and a
//   list of P image pairs (a, b). Block (p, dir, query block) matches the
//   queries of one image of pair p against all slots of the other, dir 0
//   a -> b and dir 1 b -> a. The three are flattened onto gridDim.x (2^31
//   - 1 blocks), so a whole pair list of any practical length is one
//   launch. Only invalid targets are masked (tag -2): `two_nn` masks
//   targets only and keeps every query's true nearest index; the wrapper
//   masks the distances of invalid queries afterwards. Indices are slots of
//   the target image (0..Kc-1).
//
// What bounds it on an H100: the q.t products, 2 Fq Ft D flops (pooled:
// 4.3e11 at F = 40,960, D = 128; pair list: 6.4e11 for 300 pairs of
// 2048 x 2048 both ways). Device memory traffic is small (~22 MB pooled;
// each block re-reads the targets from L2). The products run on the tensor
// cores in TF32 with a 3xTF32 split, so the bound is 3 x 2 Fq Ft D flops at
// the card's 495 TFLOP/s (2.60 ms pooled, 3.90 ms pair list); the float32
// FMA pipes (67 TFLOP/s: 6.41 / 9.62 ms) were the ceiling of the first,
// scalar design, and warp-level mma.sync, which stays well under the TF32
// peak on an H100, that of the second.
//
// Float32 accuracy on TF32 tensor cores (3xTF32): every operand element x,
// query and target alike, is split into hi = x rounded to TF32 (to nearest,
// ties away) and lo = x - hi, and the products accumulate lo.hi + hi.lo +
// hi.hi in float32. The tensor core truncates each lo to TF32. The dropped
// lo.lo term and that truncation leave a relative error of ~2^-21 per
// product, ~1e-6 in the distance of unit-norm descriptors: below the 1e-5
// tie rule and the 1e-4 distance gate the kernel is held to. On
// small-integer descriptors lo = 0 and every sum is exact, so the result is
// bit-equal to the plain version. (Single-pass TF32 would err ~1e-3.) The
// tensor core also truncates as it accumulates, so q.t comes out a few ulp
// short: an exact duplicate of a query would lie a few 1e-6 away, where
// float32 gives 0 or ~1e-7, and fail the ratio test against a runner-up
// within ~1e-5. So the tensor cores only choose the k winners: a second,
// small kernel recomputes each winner's distance in float32 as
// sum (q - t)^2 of direct differences (0 for a duplicate, as in exact
// arithmetic) and re-sorts the row. The choice can differ from float32's
// only where distances tie within ~1e-6.
//
// Design:
// - A block owns BQ = 128 queries: two warpgroups of 64, each warp 16 rows.
//   A warp's query rows live in registers for the whole block, split once
//   into hi and lo in the A-fragment order of wgmma (8 registers a k-step,
//   128 at D = 128).
// - The targets stream in tiles of BT = 64 through a ring of STAGES = 3
//   shared-memory stages, 16-byte cp.async.cg copies into K-major rows of
//   128 bytes swizzled as wgmma's 128B mode reads them (rows past the end
//   zero-filled, src-size 0). Each thread then splits the chunks it copied
//   in place, hi over the raw value and lo in the stage's second half, so
//   each target element is split once a block, not once a warp.
// - Each warpgroup runs 3 x D / 8 wgmma.m64n64k8 TF32 (A from registers, B
//   from the stage through a 128B-swizzle descriptor) asynchronously, and
//   splits the next tile while they run; 32 float32 accumulators a thread.
// - Each stage has a full and an empty mbarrier: the threads arrive on full
//   when their split is done (after fence.proxy.async, so the tensor cores
//   see it), on empty when done reading; a stage is refilled with the tile
//   two ahead once everyone has read it. No block-wide barrier a tile: a
//   warpgroup may run a tile ahead of the other, so one's epilogue overlaps
//   the other's products. cp.async rather than TMA: the split needs every
//   element in registers once anyway, and no tensor map is built on the
//   host.
// - Epilogue in registers: x = qn + tn - 2 acc; each thread keeps a sorted
//   top-k for each of its 2 query rows (k <= 8 is a template parameter, so
//   the lists stay in registers). A thread sees its targets in ascending
//   index order, so one compare against its list's tail decides, without
//   branches, whether any candidate of the tile could enter; the masks and
//   the insertion run only for warps where one could. An invalid query
//   gets an infinite norm, so its masked row never looks like a candidate.
//   At the end the 4 lanes of a quad (which share a row) merge by shuffles,
//   always by (distance, index).
// - Pooled mode launches clusters of two blocks that share a query block
//   and split the targets; the second block hands its lists to the first
//   through distributed shared memory. 640 blocks at F = 40,960 are 4.8
//   waves on 132 SMs (one block an SM: ~194 KB of shared memory at
//   D = 128), where 320 whole blocks were 2.4, a third wave two fifths full.
// - `refine`: one warp a row reads the query and its k winners once
//   ((k + 1) D floats a row, mostly from L2) and does k D FMAs: bytes-bound
//   and small beside the products.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 128;    // queries per block
constexpr int BT = 64;     // targets per pipeline stage
constexpr int STAGES = 3;  // target tiles in the shared-memory ring
constexpr int NT = 256;    // threads per block: two warpgroups of 64 query rows
constexpr int DMAX = 128;  // largest descriptor width
constexpr float BIG = 1e18f;

// the target ring (hi and lo parts), its ids and norms, its full / empty
// barriers, and slack to align the ring to 1024 bytes for the swizzle
constexpr size_t smem_bytes(int D) {
  return (size_t)STAGES * 2 * BT * D * sizeof(float) + STAGES * BT * 8 + 2 * STAGES * 8 + 1024;
}

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insert (d, i) into the ascending list (bd, bi) of length K, dropping the
// last entry. The caller has checked d < bd[K - 1], and i is larger than
// every index in the list, so an equal distance goes after its equals.
template <int K>
__device__ __forceinline__ void push(float d, int i, float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (d < bd[j - 1]) {
      bd[j] = bd[j - 1];
      bi[j] = bi[j - 1];
    } else if (d < bd[j]) {
      bd[j] = d;
      bi[j] = i;
    }
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = i;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled if !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory barriers (mbarrier) of the target ring: full[s] completes
// when every thread has split its part of stage s, empty[s] when every
// thread has finished reading it. Completion number u of a barrier is
// awaited with parity u & 1.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// The split of queries and targets: x = hi + lo, hi = x rounded to TF32 to
// nearest with ties away (what cvt.rna.tf32.f32 gives for a finite x, in two
// integer ops: the cvt adds a NaN/Inf guard), lo = x - hi exactly, handed to
// the tensor core unrounded: it reads a TF32 operand's top 19 bits, so lo is
// truncated to TF32 there.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzled
// rows: start address, leading offset 1 (unused), 8-row groups 1024 bytes
// apart, swizzle mode 128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d += a b over a 64 x 64 x 8 TF32 tile of a warpgroup: a from registers
// (this warp's 16 rows), b (64 targets x 8) from shared memory; scale_d = 0
// starts from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// One warp per row: |x|^2.
__global__ void row_norms(const float* __restrict__ x, int F, int D, float* __restrict__ out) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= F) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = x[(size_t)row * D + d];
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

// Pooled rule: per-query image ids (-2 = invalid query) and self indices.
struct PooledRule {
  const int* qid;
  const int* qself;
  __device__ int tag(int gq) const { return qid[gq]; }
  __device__ int self(int gq) const { return qself != nullptr ? qself[gq] : -1; }
};

// Pair-list rule: queries carry tag -1, which equals no target tag (0 valid,
// -2 invalid), so only invalid targets are masked; no self exclusion.
struct PairRule {
  __device__ int tag(int) const { return -1; }
  __device__ int self(int) const { return -1; }
};

// The shared tile loop: queries q[q0 .. q0 + BQ) of a set of Fq rows
// against the Ft rows of t, on wgmma. Two warpgroups of 64 query rows; the
// query slice of each warp lives in registers, split into hi and lo once;
// target tiles land raw in the ring (128-byte swizzled, K-major), each
// thread splits the chunks it copied into hi and lo in place, and each
// warpgroup runs 3 x D / 8 wgmma.m64n64k8 on the stage while it splits the
// next one. With SPLIT = 2 the block is one of a cluster of two that share
// the query block and halve the targets. Needs smem_bytes(D).
template <int K, int D, int SPLIT, class Rule>
__device__ __forceinline__ void knn_tile(
    const float* __restrict__ q, const float* __restrict__ qn, int Fq, int q0, Rule rule,
    const float* __restrict__ t, const int* __restrict__ tid, const float* __restrict__ tn,
    int Ft, int* __restrict__ out_idx, float* __restrict__ out_dist) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  constexpr int PART = BT * D;                // floats of one stage's hi (or lo) part
  float* st = smem;                           // [STAGES][hi, lo][D / 32][BT][32] swizzled
  int* s_tid = reinterpret_cast<int*>(st + STAGES * 2 * PART);  // [STAGES][BT]
  float* s_tn = reinterpret_cast<float*>(s_tid + STAGES * BT);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_tn + STAGES * BT);  // [STAGES]: split
  uint64_t* empty = full + STAGES;                                  // [STAGES]: read

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  constexpr int c4n = D / 4;
  int rank = 0;
  if constexpr (SPLIT > 1) rank = (int)cg::this_cluster().block_rank();
  const int n_all = (Ft + BT - 1) / BT;
  const int per = (n_all + SPLIT - 1) / SPLIT;
  const int tile0 = min(rank * per, n_all);
  const int n_tiles = min(n_all - tile0, per);

  // float offset of chunk c (16 bytes) of target row n in a stage part
  auto off = [](int n, int c) { return (c / 8) * BT * 32 + n * 32 + (((c % 8) ^ (n & 7)) << 2); };
  static_assert(BT * c4n % NT == 0, "whole chunks a thread");
  constexpr int CH = BT * c4n / NT;  // chunks a thread copies and splits
  auto load_tile = [&](int it) {
    const int s = it % STAGES, t0 = (tile0 + it) * BT;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + i * NT, n = e / c4n, c = e % c4n;
      const bool ok = t0 + n < Ft;
      cp_async16(st + s * 2 * PART + off(n, c), t + (size_t)(ok ? t0 + n : 0) * D + 4 * c, ok);
    }
    if (threadIdx.x < 2 * BT) {
      const int c = threadIdx.x % BT;
      const bool ok = t0 + c < Ft;
      const int gt = ok ? t0 + c : 0;
      if (threadIdx.x < BT)
        cp_async4(s_tid + s * BT + c, tid + gt, ok);
      else
        cp_async4(s_tn + s * BT + c, tn + gt, ok);
    }
  };
  // split this thread's chunks of tile it in place (hi over the raw value,
  // lo in the stage's lo part), then tell the async proxy and the ring
  auto split_tile = [&](int it) {
    const int s = it % STAGES;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + i * NT;
      float* p = st + s * 2 * PART + off(e / c4n, e % c4n);
      const float4 x = *reinterpret_cast<const float4*>(p);
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(p) = hi;
      *reinterpret_cast<uint4*>(p + PART) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(full + s);
  };

  // the thread's 2 query rows (warp w: rows 16 w + g and + 8), in registers
  // in wgmma's A fragment order: k-step ks holds (row g, k tg), (row g + 8,
  // k tg), (row g, k tg + 4), (row g + 8, k tg + 4), k = dimension 8 ks + k
  const int r0 = 16 * warp + g;
  uint32_t ah[D / 8][4], al[D / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gq = q0 + r0 + 8 * h;
    const float* row = q + (size_t)(gq < Fq ? gq : 0) * D;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const float x0 = gq < Fq ? row[8 * ks + tg] : 0.f;
      const float x1 = gq < Fq ? row[8 * ks + tg + 4] : 0.f;
      split_tf32(x0, ah[ks][h], al[ks][h]);
      split_tf32(x1, ah[ks][2 + h], al[ks][2 + h]);
    }
  }
  float my_qn[2];
  int my_qid[2], my_self[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int gq = q0 + r0 + 8 * ri;
    const bool ok = gq < Fq;
    my_qid[ri] = ok ? rule.tag(gq) : -2;
    // an invalid query's targets are all masked: an infinite norm keeps its
    // distances out of the fast check below (the lists fill with BIG)
    my_qn[ri] = my_qid[ri] == -2 ? __int_as_float(0x7f800000) : qn[gq];
    my_self[ri] = ok ? rule.self(gq) : -1;
  }

  float bd[2][K];
  int bi[2][K];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[ri][j] = __int_as_float(0x7f800000);  // +inf
      bi[ri][j] = INT_MAX;
    }

  if (threadIdx.x < STAGES) {
    mbar_init(full + threadIdx.x, NT);
    mbar_init(empty + threadIdx.x, NT);
  }
  __syncthreads();
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();
  if (n_tiles > 0) {
    cp_async_wait<1>();
    split_tile(0);
  }

  const uint32_t st_addr = smem_addr(st);
  float acc[32];
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    // refill the stage of tile it - 1 with tile it + 2 once all are done with it
    if (it + 2 < n_tiles) {
      if (it >= 1) mbar_wait(empty + (it - 1) % STAGES, ((it - 1) / STAGES) & 1);
      load_tile(it + 2);
    }
    cp_async_commit();
    mbar_wait(full + s, (it / STAGES) & 1);  // every thread's split of tile it

    // 3xTF32 on the tensor cores, asynchronously: per k-step lo.hi, hi.lo,
    // hi.hi. B's descriptor: 128-byte swizzle, 8-row groups 1024 bytes apart,
    // k-step ks at K-block ks / 4, 32 bytes a step inside it
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint32_t b_hi = st_addr + (s * 2 * PART + (ks / 4) * BT * 32) * 4 + (ks % 4) * 32;
      const uint64_t dh = desc_sw128(b_hi), dl = desc_sw128(b_hi + PART * 4);
      wgmma_tf32(acc, al[ks], dh, ks > 0);
      wgmma_tf32(acc, ah[ks], dl, 1);
      wgmma_tf32(acc, ah[ks], dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (it + 1 < n_tiles) {  // split the next tile while the products run
      cp_async_wait<1>();
      split_tile(it + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // epilogue: acc[4 j + e] holds row g + 8 (e / 2) of the warp's 16,
    // target column 8 j + 2 tg + e % 2 of the tile; it becomes x = qn + tn -
    // 2 acc. A candidate enters a list when min(max(x, 0), BIG) < tail, that
    // is (x < tail and tail > 0) or tail > BIG (a masked one enters as BIG).
    // First, without branches, whether any would; most tiles end there for
    // the whole warp. Columns past Ft get tn = inf, so x = inf.
    const int t0 = (tile0 + it) * BT;
    const int nvalid = min(BT, Ft - t0);
    bool enter = false;
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) enter |= bd[ri][K - 1] > BIG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 ttn = *reinterpret_cast<const float2*>(s_tn + s * BT + 8 * j + 2 * tg);
      if (8 * j + 2 * tg >= nvalid) ttn.x = __int_as_float(0x7f800000);
      if (8 * j + 2 * tg + 1 >= nvalid) ttn.y = __int_as_float(0x7f800000);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2;
        float& x = acc[4 * j + e];
        x = fmaf(-2.f, x, my_qn[ri] + (e % 2 ? ttn.y : ttn.x));
        enter |= (x < bd[ri][K - 1]) & (bd[ri][K - 1] > 0.f);
      }
    }
    if (__any_sync(0xffffffffu, enter)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          const int c = 8 * j + 2 * tg + col;
          if (c < nvalid) {
            const int ttid = s_tid[s * BT + c];
            const int gt = t0 + c;
#pragma unroll
            for (int ri = 0; ri < 2; ++ri) {
              const float d0 = fmaxf(acc[4 * j + 2 * ri + col], 0.f);
              if (fminf(d0, BIG) < bd[ri][K - 1]) {
                const bool bad = ttid == my_qid[ri] || ttid == -2 || my_qid[ri] == -2 ||
                                 gt == my_self[ri];
                const float d = bad ? BIG : d0;
                if (d < bd[ri][K - 1]) push<K>(d, gt, bd[ri], bi[ri]);
              }
            }
          }
        }
    }
    mbar_arrive(empty + s);
  }

  // merge: the 4 lanes of a quad share a row (k rounds of a lexicographic
  // min, the winning lane pops its head); with SPLIT = 2 the two blocks'
  // lists of a row then merge in the first block's shared memory
  if constexpr (SPLIT > 1) cg::this_cluster().sync();
  float* m_d = st;                                    // [BQ][SPLIT][K]
  int* m_i = reinterpret_cast<int*>(st + BQ * SPLIT * K);
  if constexpr (SPLIT > 1) {
    m_d = cg::this_cluster().map_shared_rank(m_d, 0);
    m_i = cg::this_cluster().map_shared_rank(m_i, 0);
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = r0 + 8 * ri, gq = q0 + r;
#pragma unroll
    for (int rr = 0; rr < K; ++rr) {
      float wd = bd[ri][0];
      int wi = bi[ri][0];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, wd, o);
        const int oi = __shfl_xor_sync(0xffffffffu, wi, o);
        if (better(od, oi, wd, wi)) {
          wd = od;
          wi = oi;
        }
      }
      if (bd[ri][0] == wd && bi[ri][0] == wi) {
#pragma unroll
        for (int j = 0; j < K - 1; ++j) {
          bd[ri][j] = bd[ri][j + 1];
          bi[ri][j] = bi[ri][j + 1];
        }
        bd[ri][K - 1] = __int_as_float(0x7f800000);
        bi[ri][K - 1] = INT_MAX;
      }
      if (tg == 0) {
        if constexpr (SPLIT > 1) {
          m_d[(r * SPLIT + rank) * K + rr] = wd;
          m_i[(r * SPLIT + rank) * K + rr] = wi;
        } else if (gq < Fq) {
          out_idx[(size_t)gq * K + rr] = wi;
          out_dist[(size_t)gq * K + rr] = wd;
        }
      }
    }
  }
  if constexpr (SPLIT > 1) {
    cg::this_cluster().sync();
    if (rank == 0 && threadIdx.x < BQ && q0 + (int)threadIdx.x < Fq) {
      const int r = threadIdx.x, gq = q0 + r;
      const float* da = st + r * SPLIT * K;
      const int* ia = reinterpret_cast<const int*>(st + BQ * SPLIT * K) + r * SPLIT * K;
      int pa = 0, pb = 0;
      for (int rr = 0; rr < K; ++rr) {
        const float ad = da[pa], bdv = da[K + pb];
        const int ai = ia[pa], bi2 = ia[K + pb];
        const bool take_a = better(ad, ai, bdv, bi2);
        out_idx[(size_t)gq * K + rr] = take_a ? ai : bi2;
        out_dist[(size_t)gq * K + rr] = take_a ? ad : bdv;
        pa += take_a;
        pb += !take_a;
      }
    }
  }
}

// Rows of the pooled output: query row r, target row idx.
struct PooledRows {
  const float* q;
  const float* t;
  int D;
  __device__ const float* query(long long r) const { return q + r * D; }
  __device__ const float* target(long long, int idx) const { return t + (long long)idx * D; }
};

// Rows of the pair-list output (P, 2, Kc, k): row r = (2 p + dir) Kc + slot.
struct PairRows {
  const float* desc;
  const int* pairs;
  int Kc;
  int D;
  __device__ const float* image(long long r, int other) const {
    const long long pd = r / Kc;
    return desc + (long long)pairs[2 * (pd / 2) + (int)((pd + other) % 2)] * Kc * D;
  }
  __device__ const float* query(long long r) const { return image(r, 0) + (r % Kc) * D; }
  __device__ const float* target(long long r, int idx) const {
    return image(r, 1) + (long long)idx * D;
  }
};

// The k winners of each row, their distances recomputed in float32 as
// sum (q - t)^2 and re-sorted by (distance, index); masked entries (BIG)
// stay as they are. One warp a row, rows strided over the grid.
template <class Rows>
__global__ void refine(const Rows rows, long long n_rows, int D, int k, int* __restrict__ idx,
                       float* __restrict__ dist) {
  const int lane = threadIdx.x % 32;
  const long long step = (long long)gridDim.x * (blockDim.x / 32);
  for (long long r = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; r < n_rows;
       r += step) {
    const float* qr = rows.query(r);
    float qv[DMAX / 32];
#pragma unroll
    for (int u = 0; u < DMAX / 32; ++u) qv[u] = lane + 32 * u < D ? qr[lane + 32 * u] : 0.f;
    float bd[8];
    int bi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= k) break;
      bd[j] = dist[r * k + j];
      bi[j] = idx[r * k + j];
      if (!(bd[j] < BIG)) continue;  // the same on every lane
      const float* tr = rows.target(r, bi[j]);
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < DMAX / 32; ++u) {
        if (lane + 32 * u < D) {
          const float e = qv[u] - tr[lane + 32 * u];
          s = fmaf(e, e, s);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      bd[j] = s;
    }
    if (lane != 0) continue;
#pragma unroll
    for (int pass = 1; pass < 8; ++pass)  // bubble sort, static indices (registers)
#pragma unroll
      for (int j = 0; j + 1 < 8; ++j)
        if (j + 1 < k && better(bd[j + 1], bi[j + 1], bd[j], bi[j])) {
          const float d = bd[j];
          const int i = bi[j];
          bd[j] = bd[j + 1];
          bi[j] = bi[j + 1];
          bd[j + 1] = d;
          bi[j + 1] = i;
        }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= k) break;
      dist[r * k + j] = bd[j];
      idx[r * k + j] = bi[j];
    }
  }
}

template <class Rows>
cudaError_t launch_refine(const Rows& rows, long long n_rows, int D, int k, int* idx,
                          float* dist, cudaStream_t s) {
  const long long blocks = (n_rows + 7) / 8;
  refine<<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)), 256, 0, s>>>(rows, n_rows, D, k,
                                                                            idx, dist);
  return cudaGetLastError();
}

struct PooledArgs {
  const float* q;
  const int* qid;
  const int* qself;
  const float* qn;
  int Fq;
  const float* t;
  const int* tid;
  const float* tn;
  int Ft;
  int* out_idx;
  float* out_dist;
};

struct PairArgs {
  const float* desc;
  const int* tag;
  const float* norms;
  int Kc;
  const int* pairs;
  int* out_idx;
  float* out_dist;
};

// Clusters of two blocks: block 2 b + r takes query block b and half r of
// the target tiles.
template <int K, int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT, 1) knn_kernel(const PooledArgs a) {
  knn_tile<K, D, 2>(a.q, a.qn, a.Fq, (blockIdx.x / 2) * BQ, PooledRule{a.qid, a.qself}, a.t,
                    a.tid, a.tn, a.Ft, a.out_idx, a.out_dist);
}

// grid 2 P QB, QB = ceil(Kc / BQ): blockIdx.x = (2 pair + direction) QB +
// query block, so the query blocks of one (pair, direction) run adjacent.
// Output (P, 2, Kc, K).
template <int K, int D>
__global__ void __launch_bounds__(NT, 1) knn_pairs_kernel(const PairArgs a) {
  const int qb_n = (a.Kc + BQ - 1) / BQ;
  const int pd = blockIdx.x / qb_n, qb = blockIdx.x % qb_n;
  const int p = pd / 2, dir = pd % 2;
  const size_t qa = (size_t)a.pairs[2 * p + dir] * a.Kc;
  const size_t tb = (size_t)a.pairs[2 * p + 1 - dir] * a.Kc;
  const size_t out = ((size_t)p * 2 + dir) * a.Kc * K;
  knn_tile<K, D, 1>(a.desc + qa * D, a.norms + qa, a.Kc, qb * BQ, PairRule{}, a.desc + tb * D,
                    a.tag + tb, a.norms + tb, a.Kc, a.out_idx + out, a.out_dist + out);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int K, int D>
cudaError_t launch(const PooledArgs& a, cudaStream_t s) {
  const cudaError_t err = allow_smem(knn_kernel<K, D>, smem_bytes(D));
  if (err != cudaSuccess) return err;
  knn_kernel<K, D><<<2 * ((a.Fq + BQ - 1) / BQ), NT, smem_bytes(D), s>>>(a);
  return cudaGetLastError();
}

template <int K, int D>
cudaError_t launch(const PairArgs& a, int P, cudaStream_t s) {
  const cudaError_t err = allow_smem(knn_pairs_kernel<K, D>, smem_bytes(D));
  if (err != cudaSuccess) return err;
  const unsigned grid = 2u * (unsigned)P * (unsigned)((a.Kc + BQ - 1) / BQ);
  knn_pairs_kernel<K, D><<<grid, NT, smem_bytes(D), s>>>(a);
  return cudaGetLastError();
}

// The kernel of the runtime width D (a multiple of 32, <= DMAX).
template <int K, class... Rest>
cudaError_t launch_d(int D, const Rest&... rest) {
  switch (D) {
    case 32: return launch<K, 32>(rest...);
    case 64: return launch<K, 64>(rest...);
    case 96: return launch<K, 96>(rest...);
    default: return launch<K, 128>(rest...);
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" int apst_knn(const float* q, const int* qid, const int* qself, int Fq,
                        const float* t, const int* tid, int Ft, int D, int k,
                        float* qn, float* tn, int* out_idx, float* out_dist, void* stream) {
  if (D % 32 != 0 || D > DMAX || k < 1 || k > 8 || Fq <= 0 || Ft <= 0)
    return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(t)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_norms<<<(Fq + 7) / 8, 256, 0, s>>>(q, Fq, D, qn);
  if (t != q) row_norms<<<(Ft + 7) / 8, 256, 0, s>>>(t, Ft, D, tn);
  const PooledArgs a{q, qid, qself, qn, Fq, t, tid, t != q ? tn : qn, Ft, out_idx, out_dist};
  cudaError_t err;
  switch (k) {
    case 1: err = launch_d<1>(D, a, s); break;
    case 2: err = launch_d<2>(D, a, s); break;
    case 3: err = launch_d<3>(D, a, s); break;
    case 4: err = launch_d<4>(D, a, s); break;
    case 5: err = launch_d<5>(D, a, s); break;
    case 6: err = launch_d<6>(D, a, s); break;
    case 7: err = launch_d<7>(D, a, s); break;
    default: err = launch_d<8>(D, a, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_refine(PooledRows{q, t, D}, Fq, D, k, out_idx, out_dist, s);
}

// desc (N * Kc, D) row-major, tag (N * Kc) with -2 = invalid slot, pairs
// (P, 2) image indices < N; norms (N * Kc) scratch; out (P, 2, Kc, k).
extern "C" int apst_knn_pairs(const float* desc, const int* tag, int N, int Kc, int D,
                              const int* pairs, int P, int k, float* norms, int* out_idx,
                              float* out_dist, void* stream) {
  if (D % 32 != 0 || D > DMAX || k < 1 || k > 2 || N <= 0 || Kc <= 0 || P <= 0 ||
      2LL * P * ((Kc + BQ - 1) / BQ) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (misaligned(desc)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_norms<<<(N * Kc + 7) / 8, 256, 0, s>>>(desc, N * Kc, D, norms);
  const PairArgs a{desc, tag, norms, Kc, pairs, out_idx, out_dist};
  const cudaError_t err = k == 1 ? launch_d<1>(D, a, P, s) : launch_d<2>(D, a, P, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_refine(PairRows{desc, pairs, Kc, D}, 2LL * P * Kc, D, k, out_idx, out_dist,
                            s);
}

extern "C" const char* apst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
