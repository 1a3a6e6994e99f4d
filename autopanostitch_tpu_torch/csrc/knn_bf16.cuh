// B1's bf16-operand instances (`compute_dtype="bfloat16"` and every binary
// width): their tile loop, kernels and launchers, built in knn_bf16.cu, and
// the declarations knn.cu's entry points call them through. The design is
// described at the head of knn.cu ("The bf16 instances").

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>

#include "knn.cuh"
#include "tma.cuh"

namespace b1 {

constexpr int BF_NT = 384;       // two consumer warpgroups of 64 query rows, one producer warpgroup
constexpr int BF_RING = 200704;  // shared-memory budget of the target ring (196 KB)

// Width of a bf16 copy's rows: D rounded up to whole 128-byte rows (64
// bf16), the TMA box and the swizzle row; the columns past D are zero.
__host__ __device__ constexpr int bf16_width(int D) { return 64 * ((D + 63) / 64); }

// The scratch of F rows that the entry points take as `qn`, `tn` or `norms`
// when bf16 is set: F float32 norms, padded to a multiple of 64 floats (256
// bytes), then the F rows rounded to bf16, bf16_width(D) columns each.
__host__ __device__ constexpr long long bf16_rows_at(long long F) { return (F + 63) / 64 * 64; }

// Targets a tile (the N of the wgmma): 128 where a ring of 5 such stages
// fits (D <= 128), else 64.
__host__ __device__ constexpr int bf_bn(int D) { return D <= 128 ? 128 : 64; }

// bytes of a ring stage: the tile's bf16 rows, its target norms and ids
__host__ __device__ constexpr int bf_stage_bytes(int D) {
  return bf_bn(D) * (2 * bf16_width(D) + 8);
}

// ring stages: as many as the budget holds, at most 8 (5 to 8 for the
// instances built)
__host__ __device__ constexpr int bf_stages(int D) {
  return BF_RING / bf_stage_bytes(D) < 8 ? BF_RING / bf_stage_bytes(D) : 8;
}

// dynamic shared memory: alignment slack, the ring, its full and empty barriers
__host__ __device__ constexpr size_t bf_smem_bytes(int D) {
  return 1024 + (size_t)bf_stages(D) * bf_stage_bytes(D) + 2 * 8 * bf_stages(D);
}

struct Bf16Pooled {
  const __nv_bfloat16* qb;  // (Fq, W) queries rounded to bf16
  const int* qid;
  const int* qself;
  const float* qn;
  int Fq;
  const __nv_bfloat16* tb;  // (Ft, W) targets rounded to bf16, read through the tensor map
  const int* tid;
  const float* tn;
  int Ft;
  int* out_idx;
  float* out_dist;
};

struct Bf16Pairs {
  const __nv_bfloat16* db;  // (N Kc, W) slots rounded to bf16
  const int* tag;
  const float* norms;
  int N;
  int Kc;
  const int* pairs;
  int* out_idx;
  float* out_dist;
};

// The instances (knn_bf16.cu): pooled K = 2, 4, 8, 16, pair list K = 2,
// widths 32 to 256 in steps of 32; cudaErrorInvalidValue for others.
cudaError_t launch_bf16(int K, int D, const Bf16Pooled& a, cudaStream_t s);
cudaError_t launch_bf16(int K, int D, const Bf16Pairs& a, int P, cudaStream_t s);

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// expect `bytes` of copies in the current phase (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// arrive once this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// arrive on the barrier at bar's offset in block `rank` of the cluster
// (release at the block's scope: the stage's reads it covers are this
// block's own; a cluster-scope release made the pooled case 1.5 times as
// slow on an H100)
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// A TMA box (column c0, row c1) of a 2-D map into shared memory at dst of
// every block in `mask` of the cluster, each completing on its barrier at
// bar's offset.
__device__ __forceinline__ void tma_multicast_2d(uint32_t dst, const CUtensorMap* map,
                                                 uint64_t* bar, int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// A TMA box (column c0, slot c1, image c2) of a 3-D map into this block.
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d (+)= a b over a 64 x N x 16 bf16 tile of a warpgroup (N = 64 or 128),
// float32 sums: a from registers (this warp's 16 rows, two bf16 a
// register), b (N targets x 16) from shared memory, K-major (trans-b 0).
// The `_add` forms add to d; the others start from zero, with d an output
// only, so that no plain instruction (a move of the last epilogue's values)
// writes d inside the wgmma's pipeline stage. ptxas serialises every wgmma
// of a kernel where a plain instruction writes (warning C7515) or reads
// (C7514) accumulators inside an open stage, so each warpgroup closes its
// stage (wait_group 0) before its epilogue touches them.
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_bf16_n64_add(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
        "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_bf16_n128_add(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 of the two consumer warpgroups' turns (256 threads).
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator set across
// this point (the wgmma writes them asynchronously).
template <int M>
__device__ __forceinline__ void pin(float (&acc)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// acc = q.t over one tile: KS k-steps of wgmma.m64nBNk16 on the stage at
// shared address `stage` ([NB][BN][64] bf16, 128-byte swizzled rows): k-step
// ks at column block ks / 4, 32 bytes a step inside it, in ascending order;
// the first starts from zero. Committed as one group.
template <int KS, int BN>
__device__ __forceinline__ void bf16_products(float (&acc)[BN / 2], const uint32_t (&aq)[KS][4],
                                              uint32_t stage) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t b = desc_sw128(stage + (ks / 4) * BN * 128 + (ks % 4) * 32);
    if constexpr (BN == 128) {
      if (ks == 0)
        wgmma_bf16_n128(acc, aq[ks], b);
      else
        wgmma_bf16_n128_add(acc, aq[ks], b, 1);
    } else {
      if (ks == 0)
        wgmma_bf16_n64(acc, aq[ks], b);
      else
        wgmma_bf16_n64_add(acc, aq[ks], b, 1);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// knn.cuh's push without branches: every compare reads the list as it was,
// so the K steps are independent selects. d = +inf changes nothing.
template <int K>
__device__ __forceinline__ void push_sel(float d, int i, float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool shift = d < bd[j - 1], here = d < bd[j];
    bd[j] = shift ? bd[j - 1] : here ? d : bd[j];
    bi[j] = shift ? bi[j - 1] : here ? i : bi[j];
  }
  const bool first = d < bd[0];
  bd[0] = first ? d : bd[0];
  bi[0] = first ? i : bi[0];
}

// A bound that no distance of a final top-K of the row can reach: the 4
// lanes of a quad keep lists of the same row, over different columns, and
// together hold K entries no worse than the value returned, each with a
// smaller index than any target to come. A candidate at or beyond it can be
// dropped, though its own lane's list would take it, which cuts a row's
// candidates to about those of one list of the whole row. For K = 2 and 4
// the value is the K-th smallest of the quad's 4 K entries (a merge by
// shuffles); for K = 8 and 16 the largest of the lanes' (K / 4)-th entries.
template <int K>
__device__ __forceinline__ float quad_bound(const float (&bd)[K]) {
  constexpr unsigned full = 0xffffffffu;
  if constexpr (K == 2) {  // the second smallest of two sorted pairs, twice
    const float c0 = __shfl_xor_sync(full, bd[0], 1), c1 = __shfl_xor_sync(full, bd[1], 1);
    const float m0 = fminf(bd[0], c0), m1 = fminf(fmaxf(bd[0], c0), fminf(bd[1], c1));
    const float d0 = __shfl_xor_sync(full, m0, 2), d1 = __shfl_xor_sync(full, m1, 2);
    return fminf(fmaxf(m0, d0), fminf(m1, d1));
  } else if constexpr (K == 4) {
    // the lane pair's 4 smallest, sorted: the bitonic minimum of the two
    // lists, then a bitonic sort of 4
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = fminf(bd[i], __shfl_xor_sync(full, bd[3 - i], 1));
    auto ce = [](float& a, float& b) {
      const float lo = fminf(a, b);
      b = fmaxf(a, b);
      a = lo;
    };
    ce(r[0], r[2]);
    ce(r[1], r[3]);
    ce(r[0], r[1]);
    ce(r[2], r[3]);
    // the 4th smallest of two sorted lists of 4 (the other lane pair's)
    float b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = __shfl_xor_sync(full, r[i], 2);
    return fminf(fminf(fminf(b[3], fmaxf(r[0], b[2])), fminf(fmaxf(r[1], b[1]), fmaxf(r[2], b[0]))),
                 r[3]);
  } else {
    float v = bd[K / 4 - 1];
    v = fmaxf(v, __shfl_xor_sync(full, v, 1));
    return fmaxf(v, __shfl_xor_sync(full, v, 2));
  }
}

// The epilogue of one tile at target t0 with nvalid real columns (knn.cuh's
// formula and rule): acc[4 j + e] holds row g + 8 (e / 2) of the warp's 16,
// column 8 j + 2 tg + e % 2 of the tile, and becomes x = fmaf(-2, acc, qn +
// tn). A candidate enters a list when min(max(x, 0), BIG) < tail, that is
// (x < tail and tail > 0) or tail > BIG (a masked one enters as BIG).
// - First pass, every pair, no branch: x, and one bit a pair in `cand` (bit
//   4 j + e of word j / 8) for the pairs that pass that test against the
//   quad's bound (quad_bound) in place of the tail, which most tiles leave
//   empty for the whole warp. Columns past the targets (zero norms and rows
//   there) may pass; the second pass drops them.
// - Second pass, only for the groups of 4 pairs (one j) where some lane of
//   the warp has a candidate: the exact test, the masks, and a branch-free
//   push (push_sel leaves a list alone unless d < its tail), in ascending
//   column order per row. A warp runs a group for all its lanes, so this
//   pass costs by groups, not by candidates.
template <int K, int BN>
__device__ __forceinline__ void bf16_epilogue(float (&acc)[BN / 2], const float* s_tn,
                                              const int* s_tid, int t0, int nvalid,
                                              const float (&qn)[2], const int (&qid)[2],
                                              const int (&self)[2], float (&bd)[2][K],
                                              int (&bi)[2][K], int tg) {
  constexpr int NW = (BN / 8 + 7) / 8;  // candidate words
  float lim[2];
  bool fill[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const float t = quad_bound<K>(bd[ri]);
    fill[ri] = t > BIG;
    lim[ri] = t > 0.f ? t : -__int_as_float(0x7f800000);
  }
  uint32_t cand[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) cand[w] = 0u;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 ttn = *reinterpret_cast<const float2*>(s_tn + 8 * j + 2 * tg);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = e / 2;
      float& x = acc[4 * j + e];
      x = fmaf(-2.f, x, qn[ri] + (e % 2 ? ttn.y : ttn.x));
      if (x < lim[ri] || fill[ri]) cand[j / 8] |= 1u << (4 * (j % 8) + e);
    }
  }
  uint32_t any = 0u;
#pragma unroll
  for (int w = 0; w < NW; ++w) any |= cand[w];
  if (!__any_sync(0xffffffffu, any != 0u)) return;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const uint32_t bits = (cand[j / 8] >> (4 * (j % 8))) & 0xFu;
    if (!__any_sync(0xffffffffu, bits != 0u)) continue;
    const int2 ttid = *reinterpret_cast<const int2*>(s_tid + 8 * j + 2 * tg);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a push costs more than a vote from K = 8 on
      if constexpr (K >= 8)
        if (!__any_sync(0xffffffffu, (bits >> e) & 1u)) continue;
      const int ri = e / 2, col = e % 2;
      const int c = 8 * j + 2 * tg + col;
      const float d0 = fmaxf(acc[4 * j + e], 0.f);
      const int tt = col ? ttid.y : ttid.x;
      const bool bad = tt == qid[ri] || tt == -2 || qid[ri] == -2 || t0 + c == self[ri];
      const float d = bad ? BIG : d0;
      const bool ok = ((bits >> e) & 1u) && c < nvalid;
      push_sel<K>(ok ? d : __int_as_float(0x7f800000), t0 + c, bd[ri], bi[ri]);
    }
  }
}

// A consumer warp is done with a stage: once all its lanes are, it tells
// the producers of every block of its multicast pair (block ranks half MC
// .. half MC + MC - 1 of the cluster), or of its own block when MC = 1.
template <int MC>
__device__ __forceinline__ void release(uint64_t* empty_s, int lane, int half) {
  __syncwarp();
  if (lane != 0) return;
  if constexpr (MC > 1) {
#pragma unroll
    for (int m = 0; m < MC; ++m) mbar_arrive_at(empty_s, half * MC + m);
  } else {
    mbar_arrive(empty_s);
  }
}

// A producer lane's share of the norms and ids of the tile at t0 (columns
// lane + 32 u) into the stage, by 4-byte cp.async (any alignment; zeros
// past Ft), then its arrival on full once they have landed. The loads'
// latency stays off the producer's path.
template <int U>
__device__ __forceinline__ void copy_cols(const float* __restrict__ tn,
                                          const int* __restrict__ tid, int Ft, int t0, int lane,
                                          float* s_tn, int* s_tid, uint64_t* full) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = lane + 32 * u;
    const bool ok = t0 + c < Ft;
    const int src = ok ? t0 + c : 0;
    cp_async4(s_tn + c, tn + src, ok);
    cp_async4(s_tid + c, tid + src, ok);
  }
  mbar_arrive_on_copies(full);
}

// The bf16 tile loop: queries q0 .. q0 + BQ of a set of Fq rows (bf16 rows
// qb, norms qn, ids and self indices through `rule`) against the Ft targets
// (norms tn, ids tid; image `img` behind the tensor map, 0 for the pooled
// map), BN a tile through a ring of ST stages; the k nearest of each query
// written at out_idx / out_dist rows q0 ...
// - Warps 0-7 (two consumer warpgroups) own 64 query rows each; warp 8 is
//   the producer: per tile it has TMA copy the bf16 rows into a stage
//   (128-byte swizzled, as wgmma reads them) and cp.async the norms and ids.
// - MC = 2 (pooled): the block is rank `rank` of a cluster of 4,
//   member rank % 2 of the multicast pair rank / 2 (`half`). The pair's two
//   blocks own different query blocks and stream the same half of the target
//   tiles: each copies half of each tile's rows to both (multicast), and a
//   stage is refilled once the consumers of both blocks have released it.
//   The two halves' lists of a query block merge at the end through
//   distributed shared memory, into the block of half 0.
// - MC = 1 (pair list): every target tile of image img.
// - The two consumer warpgroups take turns on the tensor cores (ping-pong):
//   one filters a tile while the other's products of it run. Each filters
//   its tiles in ascending order (push needs ascending target indices).
// Needs bf_smem_bytes(D) of dynamic shared memory and BF_NT threads.
template <int K, int D, int MC, class Rule>
__device__ __forceinline__ void knn_bf16_tile(const CUtensorMap* map, int img, int rank,
                                              const __nv_bfloat16* __restrict__ qb,
                                              const float* __restrict__ qn, int Fq, int q0,
                                              Rule rule, const int* __restrict__ tid,
                                              const float* __restrict__ tn, int Ft,
                                              int* __restrict__ out_idx,
                                              float* __restrict__ out_dist) {
  constexpr int BN = bf_bn(D), W = bf16_width(D), NB = W / 64, KS = D / 16;
  constexpr int ST = bf_stages(D);
  constexpr int ROWS = BN / MC;                 // rows of each tile a block copies
  constexpr uint32_t TILE_BYTES = BN * W * 2;  // bf16 bytes a stage receives
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* s_tn = reinterpret_cast<float*>(base + ST * TILE_BYTES);  // [ST][BN]
  int* s_tid = reinterpret_cast<int*>(s_tn + ST * BN);             // [ST][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_tid + ST * BN);   // [ST]: copied
  uint64_t* empty = full + ST;                                     // [ST]: read
  const uint32_t ring = smem_addr(base);                           // [ST][NB][BN][64] bf16

  const int member = rank % MC, half = rank / MC;
  const int n_all = (Ft + BN - 1) / BN;  // this block's half of the tiles
  const int per = (n_all + MC - 1) / MC;
  const int tile0 = min(half * per, n_all);
  const int n_tiles = min(n_all - tile0, per);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 32);        // the producer lanes' copies, and the TMA bytes
      mbar_init(empty + s, 8 * MC);   // the consumer warps of the multicast pair
    }
    mbar_fence_init();
  }
  if constexpr (MC > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(empty + s, (it / ST - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(full + s, TILE_BYTES);
          const int r0 = (tile0 + it) * BN + member * ROWS;
#pragma unroll
          for (int cb = 0; cb < NB; ++cb) {
            const uint32_t dst = ring + ((s * NB + cb) * BN + member * ROWS) * 128;
            if constexpr (MC > 1)
              tma_multicast_2d(dst, map, full + s, 64 * cb, r0,
                               (uint16_t)(((1u << MC) - 1) << (half * MC)));
            else
              tma_3d(dst, map, full + s, 64 * cb, r0, img);
          }
        }
        copy_cols<BN / 32>(tn, tid, Ft, (tile0 + it) * BN, lane, s_tn + s * BN, s_tid + s * BN,
                           full + s);
      }
    }
    if constexpr (MC > 1) {  // the merge's two cluster barriers
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int g = lane / 4, tg = lane % 4;
  const int r0 = 16 * warp + g;
  const int wg = warp / 4;
  float acc[BN / 2];

  // the thread's 2 query rows (warp w: rows 16 w + g and + 8) in wgmma's
  // A fragment order: k-step ks holds the pairs (k, k + 1) at k = 2 tg and
  // 2 tg + 8 of rows g and g + 8, k = column 16 ks + k; zero past Fq
  uint32_t aq[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gq = q0 + r0 + 8 * h;
    const bool ok = gq < Fq;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(qb + (size_t)(ok ? gq : 0) * W);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      aq[ks][h] = ok ? row[8 * ks + tg] : 0u;
      aq[ks][2 + h] = ok ? row[8 * ks + tg + 4] : 0u;
    }
  }
  float my_qn[2];
  int my_qid[2], my_self[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int gq = q0 + r0 + 8 * ri;
    const bool ok = gq < Fq;
    my_qid[ri] = ok ? rule.tag(gq) : -2;
    // an invalid query's targets are all masked: an infinite norm keeps
    // its distances out of the fast check (the lists fill with BIG)
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

  // Tiles in order: wait for the stage; on this warpgroup's turn issue
  // the tile's products and pass the turn to the other warpgroup; wait
  // for the products; filter them (the epilogue) while the other
  // warpgroup's products run; hand the stage back to the producers. The
  // turns (named barriers 1 and 2) alternate the two warpgroups' products
  // on the tensor cores, warpgroup 0 first: warpgroup 1 passes it an
  // opening turn, and warpgroup 0 takes the last one after its loop, so
  // every arrival is matched.
  if (wg == 1 && n_tiles > 0) turn_pass(1);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, t0 = (tile0 + it) * BN;
    mbar_wait(full + s, (it / ST) & 1);
    turn_wait(1 + wg);
    bf16_products<KS, BN>(acc, aq, ring + s * TILE_BYTES);
    turn_pass(2 - wg);
    wgmma_wait<0>();
    pin(acc);
    bf16_epilogue<K, BN>(acc, s_tn + s * BN, s_tid + s * BN, t0, min(BN, Ft - t0), my_qn, my_qid,
                         my_self, bd, bi, tg);
    release<MC>(empty + s, lane, half);
  }
  if (wg == 0 && n_tiles > 0) turn_wait(1);  // warpgroup 1's pass after its last tile

  // merge: the 4 lanes of a quad share a row (k rounds of a lexicographic
  // min, the winning lane pops its head); with MC = 2 the two halves'
  // lists of a row then merge in the shared memory of the block of half 0
  if constexpr (MC > 1) cg::this_cluster().sync();
  float* m_d = reinterpret_cast<float*>(base);  // [BQ][MC][K]
  int* m_i = reinterpret_cast<int*>(m_d + BQ * MC * K);
  if constexpr (MC > 1) {
    m_d = cg::this_cluster().map_shared_rank(m_d, member);
    m_i = cg::this_cluster().map_shared_rank(m_i, member);
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
        if constexpr (MC > 1) {
          m_d[(r * MC + half) * K + rr] = wd;
          m_i[(r * MC + half) * K + rr] = wi;
        } else if (gq < Fq) {
          out_idx[(size_t)gq * K + rr] = wi;
          out_dist[(size_t)gq * K + rr] = wd;
        }
      }
    }
  }
  if constexpr (MC > 1) {
    cg::this_cluster().sync();
    if (half == 0 && threadIdx.x < BQ && q0 + (int)threadIdx.x < Fq) {
      const int r = threadIdx.x, gq = q0 + r;
      const float* da = reinterpret_cast<const float*>(base) + r * MC * K;
      const int* ia = reinterpret_cast<const int*>(base) + BQ * MC * K + r * MC * K;
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

// Pooled: clusters of 4. Rank r takes query block 2 (cluster) + r % 2 and
// target half r / 2.
template <int K, int D>
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(BF_NT, 1)
    knn_bf16_kernel(const __grid_constant__ CUtensorMap map, const Bf16Pooled a) {
  const int rank = (int)cg::this_cluster().block_rank();
  const int q0 = (2 * (int)(blockIdx.x / 4) + rank % 2) * BQ;
  knn_bf16_tile<K, D, 2>(&map, 0, rank, a.qb, a.qn, a.Fq, q0, PooledRule{a.qid, a.qself}, a.tid,
                         a.tn, a.Ft, a.out_idx, a.out_dist);
}

// Pair list: grid 2 P QB, QB = ceil(Kc / BQ), blockIdx.x = (2 pair +
// direction) QB + query block, as knn_pairs_kernel. Output (P, 2, Kc, K).
template <int K, int D>
__global__ void __launch_bounds__(BF_NT, 1)
    knn_pairs_bf16_kernel(const __grid_constant__ CUtensorMap map, const Bf16Pairs a) {
  constexpr int W = bf16_width(D);
  const int qb_n = (a.Kc + BQ - 1) / BQ;
  const int pd = blockIdx.x / qb_n, qb = blockIdx.x % qb_n;
  const int p = pd / 2, dir = pd % 2;
  const int ia = a.pairs[2 * p + dir], ib = a.pairs[2 * p + 1 - dir];
  const size_t qa = (size_t)ia * a.Kc, tb = (size_t)ib * a.Kc;
  const size_t out = ((size_t)p * 2 + dir) * a.Kc * K;
  knn_bf16_tile<K, D, 1>(&map, ib, 0, a.db + qa * W, a.norms + qa, a.Kc, qb * BQ, PairRule{},
                         a.tag + tb, a.norms + tb, a.Kc, a.out_idx + out, a.out_dist + out);
}

// The tensor map of bf16 rows of width W, 128-byte swizzled boxes of 64
// columns: 2-D (W, rows) with boxes of `box_rows`, or 3-D (W, Kc, N) with
// boxes of (64, box_rows, 1) when N > 0. Rows past the end read as zeros.
inline cudaError_t bf16_map(CUtensorMap* map, const __nv_bfloat16* rows, int W, long long F,
                            int Kc, int N, int box_rows) {
  tma::EncodeTiled enc = tma::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)(N > 0 ? Kc : F), (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 2, (cuuint64_t)Kc * W * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N > 0 ? 3 : 2,
                         const_cast<__nv_bfloat16*>(rows), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int K, int D>
cudaError_t launch_bf16_pooled(const Bf16Pooled& a, cudaStream_t s) {
  constexpr size_t bytes = bf_smem_bytes(D);
  CUtensorMap map{};
  cudaError_t err = bf16_map(&map, a.tb, bf16_width(D), a.Ft, 0, 0, bf_bn(D) / 2);
  if (err == cudaSuccess) err = allow_smem(knn_bf16_kernel<K, D>, bytes);
  if (err != cudaSuccess) return err;
  const int qblocks = (a.Fq + BQ - 1) / BQ;
  knn_bf16_kernel<K, D><<<4 * ((qblocks + 1) / 2), BF_NT, bytes, s>>>(map, a);
  return cudaGetLastError();
}

template <int K, int D>
cudaError_t launch_bf16_pairs(const Bf16Pairs& a, int P, cudaStream_t s) {
  constexpr size_t bytes = bf_smem_bytes(D);
  CUtensorMap map{};
  cudaError_t err = bf16_map(&map, a.db, bf16_width(D), 0, a.Kc, a.N, bf_bn(D));
  if (err == cudaSuccess) err = allow_smem(knn_pairs_bf16_kernel<K, D>, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = 2u * (unsigned)P * (unsigned)((a.Kc + BQ - 1) / BQ);
  knn_pairs_bf16_kernel<K, D><<<grid, BF_NT, bytes, s>>>(map, a);
  return cudaGetLastError();
}

// Dispatch a run-time width D to the instances Ds of K.
template <int K, int... Ds>
struct Bf16Widths {
  static cudaError_t pooled(int D, const Bf16Pooled& a, cudaStream_t s) {
    cudaError_t err = cudaErrorInvalidValue;
    ((D == Ds ? (err = launch_bf16_pooled<K, Ds>(a, s), true) : false) || ...);
    return err;
  }
  static cudaError_t pairs(int D, const Bf16Pairs& a, int P, cudaStream_t s) {
    cudaError_t err = cudaErrorInvalidValue;
    ((D == Ds ? (err = launch_bf16_pairs<K, Ds>(a, P, s), true) : false) || ...);
    return err;
  }
};

}  // namespace b1
