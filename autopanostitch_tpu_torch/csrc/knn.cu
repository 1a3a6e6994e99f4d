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
//   launch. Only
//   invalid targets are masked (tag -2): `two_nn` masks targets only and
//   keeps every query's true nearest index; the wrapper masks the
//   distances of invalid queries afterwards. Indices are slots of the
//   target image (0..Kc-1).
//
// What bounds it on an H100: the q.t products, 2 Fq Ft D flops (pooled:
// ~430 GFLOP at F = 41k; pair list: ~320 GFLOP for 300 pairs of 2048 x 2048
// both ways), run on the fp32 FMA pipes (67 TFLOP/s peak) -- tensor cores
// would mean TF32 or bf16 and break parity with the float32 reference, so
// they are left to a later change. Device memory traffic is small (target
// tiles are re-read from L2 by every query block).
//
// Design: a block owns BQ = 64 queries, staged transposed in shared memory
// once. It streams the targets in tiles of BT = 64, 32 dimensions at a time,
// and each of its 256 threads accumulates a 4 x 4 register tile of dot
// products. Each thread keeps, for its 4 queries, a sorted register top-k
// over the targets it has seen (k <= 8 is a template parameter, so the lists
// stay in registers); the 16 threads that share a query hold disjoint target
// subsets, and their lists are merged at the end with k rounds of
// half-warp shuffles. Row norms are computed once per launch for every row.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int BQ = 64;    // queries per block
constexpr int BT = 64;    // targets per tile
constexpr int DC = 32;    // dimensions per staged chunk
constexpr int DMAX = 128; // largest descriptor width the block stages
constexpr int NT = 256;   // threads per block (16 x 16)
constexpr int PAD = 4;    // row padding (keeps float4 alignment)
constexpr float BIG = 1e18f;

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insert (d, i) into the ascending list (bd, bi) of length K, dropping the
// last entry. Fully unrolled so the list stays in registers.
template <int K>
__device__ __forceinline__ void insert(float d, int i, float (&bd)[K], int (&bi)[K]) {
  if (!better(d, i, bd[K - 1], bi[K - 1])) return;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (better(d, i, bd[j - 1], bi[j - 1])) {
      bd[j] = bd[j - 1];
      bi[j] = bi[j - 1];
    } else if (better(d, i, bd[j], bi[j])) {
      bd[j] = d;
      bi[j] = i;
    }
  }
  if (better(d, i, bd[0], bi[0])) {
    bd[0] = d;
    bi[0] = i;
  }
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
// against all Ft rows of t. The base pointers are offset to the two sets by
// the caller; indices written are local to t.
template <int K, class Rule>
__device__ __forceinline__ void knn_tile(
    const float* __restrict__ q, const float* __restrict__ qn, int Fq, int q0, Rule rule,
    const float* __restrict__ t, const int* __restrict__ tid, const float* __restrict__ tn,
    int Ft, int D, int* __restrict__ out_idx, float* __restrict__ out_dist) {
  __shared__ __align__(16) float sq[DMAX][BQ + PAD];
  __shared__ __align__(16) float st[DC][BT + PAD];
  __shared__ int s_tid[BT];
  __shared__ float s_tn[BT];

  const int tx = threadIdx.x % 16;  // target sub-tile
  const int ty = threadIdx.x / 16;  // query sub-tile
  const int d4n = D / 4;

  // stage the query tile transposed: sq[d][r] = q[q0 + r][d]
  for (int e = threadIdx.x; e < BQ * d4n; e += NT) {
    const int r = e / d4n, d4 = e % d4n;
    const int gq = q0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gq < Fq) v = reinterpret_cast<const float4*>(q + (size_t)gq * D)[d4];
    sq[d4 * 4 + 0][r] = v.x;
    sq[d4 * 4 + 1][r] = v.y;
    sq[d4 * 4 + 2][r] = v.z;
    sq[d4 * 4 + 3][r] = v.w;
  }

  float my_qn[4];
  int my_qid[4], my_self[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gq = q0 + ty * 4 + a;
    const bool ok = gq < Fq;
    my_qn[a] = ok ? qn[gq] : 0.f;
    my_qid[a] = ok ? rule.tag(gq) : -2;
    my_self[a] = ok ? rule.self(gq) : -1;
  }

  float bd[4][K];
  int bi[4][K];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[a][j] = __int_as_float(0x7f800000);  // +inf
      bi[a][j] = INT_MAX;
    }

  for (int t0 = 0; t0 < Ft; t0 += BT) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();
      // stage a target chunk transposed: st[dd][c] = t[t0 + c][d0 + dd]
      for (int e = threadIdx.x; e < BT * (DC / 4); e += NT) {
        const int c = e / (DC / 4), d4 = e % (DC / 4);
        const int gt = t0 + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gt < Ft) v = reinterpret_cast<const float4*>(t + (size_t)gt * D + d0)[d4];
        st[d4 * 4 + 0][c] = v.x;
        st[d4 * 4 + 1][c] = v.y;
        st[d4 * 4 + 2][c] = v.z;
        st[d4 * 4 + 3][c] = v.w;
      }
      if (d0 == 0 && threadIdx.x < BT) {
        const int gt = t0 + threadIdx.x;
        s_tid[threadIdx.x] = gt < Ft ? tid[gt] : -2;
        s_tn[threadIdx.x] = gt < Ft ? tn[gt] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DC; ++dd) {
        const float4 av = *reinterpret_cast<const float4*>(&sq[d0 + dd][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&st[dd][tx * 4]);
        const float aa[4] = {av.x, av.y, av.z, av.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(aa[a], bb[b], acc[a][b]);
      }
    }

#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx * 4 + b;
      const int gt = t0 + c;
      if (gt < Ft) {
        const int ttid = s_tid[c];
        const float ttn = s_tn[c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float dist = fmaxf(my_qn[a] + ttn - 2.f * acc[a][b], 0.f);
          const bool bad = ttid == my_qid[a] || ttid == -2 || my_qid[a] == -2 || gt == my_self[a];
          if (bad) dist = BIG;
          insert<K>(dist, gt, bd[a], bi[a]);
        }
      }
    }
  }

  // merge the 16 per-thread lists of each query: k rounds of a half-warp
  // lexicographic min, the winning lane pops its head
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gq = q0 + ty * 4 + a;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float wd = bd[a][0];
      int wi = bi[a][0];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, wd, off, 16);
        const int oi = __shfl_xor_sync(0xffffffffu, wi, off, 16);
        if (better(od, oi, wd, wi)) {
          wd = od;
          wi = oi;
        }
      }
      if (bd[a][0] == wd && bi[a][0] == wi) {
#pragma unroll
        for (int j = 0; j < K - 1; ++j) {
          bd[a][j] = bd[a][j + 1];
          bi[a][j] = bi[a][j + 1];
        }
        bd[a][K - 1] = __int_as_float(0x7f800000);
        bi[a][K - 1] = INT_MAX;
      }
      if (tx == 0 && gq < Fq) {
        out_idx[(size_t)gq * K + r] = wi;
        out_dist[(size_t)gq * K + r] = wd;
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(NT) knn_kernel(
    const float* __restrict__ q, const int* __restrict__ qid, const int* __restrict__ qself,
    const float* __restrict__ qn, int Fq, const float* __restrict__ t,
    const int* __restrict__ tid, const float* __restrict__ tn, int Ft, int D,
    int* __restrict__ out_idx, float* __restrict__ out_dist) {
  knn_tile<K>(q, qn, Fq, blockIdx.x * BQ, PooledRule{qid, qself}, t, tid, tn, Ft, D, out_idx,
              out_dist);
}

// grid 2 P QB, QB = ceil(Kc / BQ): blockIdx.x = (2 pair + direction) QB +
// query block, so the query blocks of one (pair, direction) run adjacent.
// Output (P, 2, Kc, K).
template <int K>
__global__ void __launch_bounds__(NT) knn_pairs_kernel(
    const float* __restrict__ desc, const int* __restrict__ tag, const float* __restrict__ norms,
    int Kc, int D, const int* __restrict__ pairs, int* __restrict__ out_idx,
    float* __restrict__ out_dist) {
  const int qb_n = (Kc + BQ - 1) / BQ;
  const int pd = blockIdx.x / qb_n, qb = blockIdx.x % qb_n;
  const int p = pd / 2, dir = pd % 2;
  const size_t qa = (size_t)pairs[2 * p + dir] * Kc;
  const size_t tb = (size_t)pairs[2 * p + 1 - dir] * Kc;
  const size_t out = ((size_t)p * 2 + dir) * Kc * K;
  knn_tile<K>(desc + qa * D, norms + qa, Kc, qb * BQ, PairRule{}, desc + tb * D,
              tag + tb, norms + tb, Kc, D, out_idx + out, out_dist + out);
}

template <int K>
void launch(const float* q, const int* qid, const int* qself, const float* qn, int Fq,
            const float* t, const int* tid, const float* tn, int Ft, int D, int* out_idx,
            float* out_dist, cudaStream_t s) {
  const int blocks = (Fq + BQ - 1) / BQ;
  knn_kernel<K><<<blocks, NT, 0, s>>>(q, qid, qself, qn, Fq, t, tid, tn, Ft, D, out_idx, out_dist);
}

template <int K>
void launch_pairs(const float* desc, const int* tag, const float* norms, int Kc, int D,
                  const int* pairs, int P, int* out_idx, float* out_dist, cudaStream_t s) {
  const unsigned grid = 2u * (unsigned)P * (unsigned)((Kc + BQ - 1) / BQ);
  knn_pairs_kernel<K><<<grid, NT, 0, s>>>(desc, tag, norms, Kc, D, pairs, out_idx, out_dist);
}

}  // namespace

extern "C" int apst_knn(const float* q, const int* qid, const int* qself, int Fq,
                        const float* t, const int* tid, int Ft, int D, int k,
                        float* qn, float* tn, int* out_idx, float* out_dist, void* stream) {
  if (D % DC != 0 || D > DMAX || k < 1 || k > 8 || Fq <= 0 || Ft <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_norms<<<(Fq + 7) / 8, 256, 0, s>>>(q, Fq, D, qn);
  if (t != q) row_norms<<<(Ft + 7) / 8, 256, 0, s>>>(t, Ft, D, tn);
  const float* tnp = t != q ? tn : qn;
  switch (k) {
    case 1: launch<1>(q, qid, qself, qn, Fq, t, tid, tnp, Ft, D, out_idx, out_dist, s); break;
    case 2: launch<2>(q, qid, qself, qn, Fq, t, tid, tnp, Ft, D, out_idx, out_dist, s); break;
    case 3: launch<3>(q, qid, qself, qn, Fq, t, tid, tnp, Ft, D, out_idx, out_dist, s); break;
    case 4: launch<4>(q, qid, qself, qn, Fq, t, tid, tnp, Ft, D, out_idx, out_dist, s); break;
    case 5: launch<5>(q, qid, qself, qn, Fq, t, tid, tnp, Ft, D, out_idx, out_dist, s); break;
    case 6: launch<6>(q, qid, qself, qn, Fq, t, tid, tnp, Ft, D, out_idx, out_dist, s); break;
    case 7: launch<7>(q, qid, qself, qn, Fq, t, tid, tnp, Ft, D, out_idx, out_dist, s); break;
    default: launch<8>(q, qid, qself, qn, Fq, t, tid, tnp, Ft, D, out_idx, out_dist, s); break;
  }
  return (int)cudaGetLastError();
}

// desc (N * Kc, D) row-major, tag (N * Kc) with -2 = invalid slot, pairs
// (P, 2) image indices < N; norms (N * Kc) scratch; out (P, 2, Kc, k).
extern "C" int apst_knn_pairs(const float* desc, const int* tag, int N, int Kc, int D,
                              const int* pairs, int P, int k, float* norms, int* out_idx,
                              float* out_dist, void* stream) {
  if (D % DC != 0 || D > DMAX || k < 1 || k > 2 || N <= 0 || Kc <= 0 || P <= 0 ||
      2LL * P * ((Kc + BQ - 1) / BQ) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int F = N * Kc;
  row_norms<<<(F + 7) / 8, 256, 0, s>>>(desc, F, D, norms);
  if (k == 1)
    launch_pairs<1>(desc, tag, norms, Kc, D, pairs, P, out_idx, out_dist, s);
  else
    launch_pairs<2>(desc, tag, norms, Kc, D, pairs, P, out_idx, out_dist, s);
  return (int)cudaGetLastError();
}

extern "C" const char* apst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
