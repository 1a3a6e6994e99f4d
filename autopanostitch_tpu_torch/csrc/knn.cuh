// B1, exact k-NN (squared L2): the 3xTF32 tile loop, its kernels and their
// launchers, shared by knn.cu (the C entry points and the instances of
// widths up to 128) and knn_wide.cu (widths 160 to 256); the helpers that
// the bf16 instances (knn_bf16.cuh) share with it. The design is described
// at the head of knn.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace b1 {

constexpr int BQ = 128;    // queries per block
constexpr int BT = 64;     // targets per pipeline stage
constexpr int STAGES = 3;  // target tiles in the shared-memory ring
constexpr int NT = 256;    // threads per block: two warpgroups of 64 query rows
constexpr int DMAX = 256;  // largest descriptor width
constexpr int KMAX = 16;   // longest neighbour list
constexpr int DCHUNK = 128;  // widest slice of a descriptor a ring stage holds
constexpr float BIG = 1e18f;

// The widest chunk of a descriptor an instance holds: 128 columns, or 64
// for the instance of K = 16, whose longer lists need the registers that the
// hi/lo query fragments of 128 columns would take.
__host__ __device__ constexpr int dchunk(int K) { return K > 8 ? 64 : DCHUNK; }

// A descriptor wider than DCH passes the ring in NH chunks of DC columns
// (DC a multiple of 32, columns past D zero-filled): with DCH = 128, 160 and
// 192 as 2 x 96, 224 and 256 as 2 x 128. Up to DCH, NH = 1 and DC = D.
template <int D, int DCH = DCHUNK>
struct Chunks {
  static constexpr int NH = (D + DCH - 1) / DCH;
  static constexpr int DC = 32 * ((D + 32 * NH - 1) / (32 * NH));
};

// the target ring (per stage two parts of BT x DC floats: hi and lo), its
// ids and norms,
// its full / empty barriers, and slack to align the ring to 1024 bytes for
// the swizzle
constexpr size_t smem_bytes(int DC) {
  return (size_t)STAGES * 2 * BT * DC * sizeof(float) + STAGES * BT * 8 + 2 * STAGES * 8 + 1024;
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
// query slice of each warp lives in registers, split into hi and lo (once,
// or once a chunk when D > DC); target tiles land raw in the ring
// (128-byte swizzled, K-major), a chunk of DC columns an item, each thread
// splits the chunks it copied into hi and lo in place, and each warpgroup
// runs 3 x DC / 8 wgmma.m64n64k8 on the stage while it splits the next
// one. The accumulators carry over the NH items of a tile; the epilogue
// runs after its last. With SPLIT = 2 the block is one of a cluster of two
// that share the query block and halve the targets. Needs
// smem_bytes(Chunks<D, dchunk(K)>::DC).
template <int K, int D, int SPLIT, class Rule>
__device__ __forceinline__ void knn_tile(
    const float* __restrict__ q, const float* __restrict__ qn, int Fq, int q0, Rule rule,
    const float* __restrict__ t, const int* __restrict__ tid, const float* __restrict__ tn,
    int Ft, int* __restrict__ out_idx, float* __restrict__ out_dist) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  using Ch = Chunks<D, dchunk(K)>;
  constexpr int NH = Ch::NH, DC = Ch::DC;
  constexpr int PART = BT * DC;  // floats of one stage's part
  // [STAGES][hi, lo][DC / 32][BT][32] floats swizzled
  float* st = smem;
  int* s_tid = reinterpret_cast<int*>(st + STAGES * 2 * PART);  // [STAGES][BT]
  float* s_tn = reinterpret_cast<float*>(s_tid + STAGES * BT);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_tn + STAGES * BT);  // [STAGES]: split
  uint64_t* empty = full + STAGES;                                  // [STAGES]: read

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  constexpr int c4n = DC / 4;
  int rank = 0;
  if constexpr (SPLIT > 1) rank = (int)cg::this_cluster().block_rank();
  const int n_all = (Ft + BT - 1) / BT;
  const int per = (n_all + SPLIT - 1) / SPLIT;
  const int tile0 = min(rank * per, n_all);
  const int n_tiles = min(n_all - tile0, per);
  const int n_items = n_tiles * NH;  // (tile, chunk) pairs through the ring

  // float offset of chunk c (16 bytes) of target row n in a stage part
  auto off = [](int n, int c) { return (c / 8) * BT * 32 + n * 32 + (((c % 8) ^ (n & 7)) << 2); };
  static_assert(BT * c4n % NT == 0, "whole chunks a thread");
  constexpr int CH = BT * c4n / NT;  // chunks a thread copies and splits
  auto load_tile = [&](int it) {
    const int s = it % STAGES, t0 = (tile0 + it / NH) * BT, c0 = (it % NH) * DC;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + i * NT, n = e / c4n, c = e % c4n;
      const bool ok = t0 + n < Ft && c0 + 4 * c < D;
      cp_async16(st + s * 2 * PART + off(n, c), t + (ok ? (size_t)(t0 + n) * D + c0 + 4 * c : 0),
                 ok);
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
  // lo in the stage's lo part); then tell the async proxy and the ring
  auto split_tile = [&](int it) {
    const int s = it % STAGES;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + i * NT, n = e / c4n, c = e % c4n;
      float* p = st + s * 2 * PART + off(n, c);
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

  // the thread's 2 query rows (warp w: rows 16 w + g and + 8), columns
  // c0 .. c0 + DC, in registers in wgmma's A fragment order: TF32 k-step ks
  // holds (row g, k tg), (row g + 8, k tg), (row g, k tg + 4), (row g + 8,
  // k tg + 4), k = dimension c0 + 8 ks + k; zero past D
  const int r0 = 16 * warp + g;
  constexpr int KS = DC / 8;  // k-steps a chunk
  uint32_t ah[KS][4], al[KS][4];
  auto load_q = [&](int c0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = q0 + r0 + 8 * h;
      const float* row = q + (size_t)(gq < Fq ? gq : 0) * D + c0;
      auto x = [&](int k) { return gq < Fq && c0 + k < D ? row[k] : 0.f; };
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        split_tf32(x(8 * ks + tg), ah[ks][h], al[ks][h]);
        split_tf32(x(8 * ks + tg + 4), ah[ks][2 + h], al[ks][2 + h]);
      }
    }
  };
  if constexpr (NH == 1) load_q(0);
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
  if (n_items > 0) load_tile(0);
  cp_async_commit();
  if (n_items > 1) load_tile(1);
  cp_async_commit();
  if (n_items > 0) {
    cp_async_wait<1>();
    split_tile(0);
  }

  const uint32_t st_addr = smem_addr(st);
  float acc[32];
  for (int it = 0; it < n_items; ++it) {
    const int s = it % STAGES, h = it % NH;
    // refill the stage of item it - 1 with item it + 2 once all are done with it
    if (it + 2 < n_items) {
      if (it >= 1) mbar_wait(empty + (it - 1) % STAGES, ((it - 1) / STAGES) & 1);
      load_tile(it + 2);
    }
    cp_async_commit();
    if constexpr (NH > 1) load_q(h * DC);  // the previous item's products are done
    mbar_wait(full + s, (it / STAGES) & 1);  // every thread's split of item it

    // 3xTF32 on the tensor cores, asynchronously: per k-step lo.hi, hi.lo,
    // hi.hi. B's descriptor: 128-byte swizzle, 8-row groups 1024 bytes
    // apart, k-step ks at K-block ks / 4, 32 bytes a step inside it (8 TF32
    // values). A tile's first chunk starts the accumulators from zero, the
    // others add on.
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t b_hi = st_addr + (s * 2 * PART) * 4 + (ks / 4) * BT * 128 + (ks % 4) * 32;
      const uint64_t dh = desc_sw128(b_hi), dl = desc_sw128(b_hi + PART * 4);
      wgmma_tf32(acc, al[ks], dh, ks > 0 || h > 0);
      wgmma_tf32(acc, ah[ks], dl, 1);
      wgmma_tf32(acc, ah[ks], dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (it + 1 < n_items) {  // split the next item while the products run
      cp_async_wait<1>();
      split_tile(it + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (h < NH - 1) {  // more chunks of this tile to add
      mbar_arrive(empty + s);
      continue;
    }

    // epilogue: acc[4 j + e] holds row g + 8 (e / 2) of the warp's 16,
    // target column 8 j + 2 tg + e % 2 of the tile; it becomes x = qn + tn -
    // 2 acc. A candidate enters a list when min(max(x, 0), BIG) < tail, that
    // is (x < tail and tail > 0) or tail > BIG (a masked one enters as BIG).
    // First, without branches, whether any would; most tiles end there for
    // the whole warp. Columns past Ft get tn = inf, so x = inf.
    const int t0 = (tile0 + it / NH) * BT;
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
  constexpr size_t bytes = smem_bytes(Chunks<D, dchunk(K)>::DC);
  const cudaError_t err = allow_smem(knn_kernel<K, D>, bytes);
  if (err != cudaSuccess) return err;
  knn_kernel<K, D><<<2 * ((a.Fq + BQ - 1) / BQ), NT, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int K, int D>
cudaError_t launch(const PairArgs& a, int P, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes(Chunks<D, dchunk(K)>::DC);
  const cudaError_t err = allow_smem(knn_pairs_kernel<K, D>, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = 2u * (unsigned)P * (unsigned)((a.Kc + BQ - 1) / BQ);
  knn_pairs_kernel<K, D><<<grid, NT, bytes, s>>>(a);
  return cudaGetLastError();
}

// The instances: the pooled mode at K = 2, 4, 8 and 16 (a K instance serves
// every k <= K: its first k columns are the k nearest under the strict
// (distance, index) order), the pair list at K = 2; widths 32 to 256 in
// steps of 32. The instances of widths up to DCHUNK are built in knn.cu,
// those of widths above DCHUNK (160, 192, 224 and 256) in knn_wide.cu. K is
// the instance's (2, 4, 8, 16; the pair list 2).
cudaError_t launch_wide(int K, int D, const PooledArgs& a, cudaStream_t s);
cudaError_t launch_wide(int K, int D, const PairArgs& a, int P, cudaStream_t s);

// Dispatch a run-time width D to the instances listed in Ds (with K fixed);
// cudaErrorInvalidValue for a width not listed.
template <int K, int... Ds>
struct Widths {
  template <class... Args>
  static cudaError_t launch_d(int D, const Args&... args) {
    cudaError_t err = cudaErrorInvalidValue;
    ((D == Ds ? (err = launch<K, Ds>(args...), true) : false) || ...);
    return err;
  }
};

// The pooled instance of K (2, 4, 8 or 16) over widths Ds.
template <int... Ds>
cudaError_t launch_pooled(int K, int D, const PooledArgs& a, cudaStream_t s) {
  switch (K) {
    case 2: return Widths<2, Ds...>::launch_d(D, a, s);
    case 4: return Widths<4, Ds...>::launch_d(D, a, s);
    case 8: return Widths<8, Ds...>::launch_d(D, a, s);
    case 16: return Widths<16, Ds...>::launch_d(D, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The pair-list instance (K = 2) over widths Ds.
template <int... Ds>
cudaError_t launch_pairs(int K, int D, const PairArgs& a, int P, cudaStream_t s) {
  return K == 2 ? Widths<2, Ds...>::launch_d(D, a, P, s) : cudaErrorInvalidValue;
}

}  // namespace b1
