// Exact k-nearest-neighbour search (squared L2) for descriptor matching, in
// two modes, each with a 3xTF32 tile loop (knn.cuh) and a bf16 one
// (knn_bf16.cuh).
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
// Modes (the `Rule` template parameter of `knn_tile`, in knn.cuh):
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
//   top-K for each of its 2 query rows (K is a template parameter, so the
//   lists stay in registers). The instances are K = 2, 4, 8 and 16 pooled
//   and K = 2 for the pair list; the wrapper takes the smallest K >= k and
//   keeps the first k columns, exact under the strict (distance, index)
//   order. The 3xTF32 K = 16 instance holds 64 columns of a warp's queries
//   at a time (its 64 list registers would not fit beside 128 columns of
//   hi/lo fragments), in chunks as the wide widths below. A thread sees its targets in ascending
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
// - Widths above 128 (binary descriptors are 256 bits): the registers hold
//   128 columns of a warp's queries at most (256 hi/lo registers would not
//   fit), and three stages of 64 x 256 hi/lo targets would need ~384 KB of
//   shared memory. So such a descriptor passes through in NH = 2 chunks of
//   DC <= 128 columns: each target tile is NH items of the same ring (a
//   stage holds one chunk, so shared memory stays at its D = 128 size), the
//   accumulators add up over a tile's chunks, and before each item a warp
//   reloads and splits its queries' fragments of that chunk (from L1/L2).
//   The epilogue runs once a tile. On {0,1} descriptors every split is
//   exact (lo = 0) and every distance an integer, so ties keep the exact
//   (distance, index) order of the plain version. Those instances are
//   built in knn_wide.cu; the tile loop is in knn.cuh.
// - The bf16 instances (knn_bf16.cuh, built in knn_bf16.cu), for
//   `compute_dtype="bfloat16"`, where the reference rounds both operands of
//   q.t to bf16 and sums in float32, and for every binary width: one bf16
//   product a k-step (float32 sums, k-steps in ascending column order), the
//   expansion-form distance fmaf(-2, acc, qn + tn) from float32 norms,
//   clamped at 0, and no refine (direct float32 differences would give the
//   float32 answer, which the reference's bf16 run does not). Their bound
//   is one product at 989 TFLOP/s (0.43 ms pooled at F = 40,960, D = 128;
//   0.65 ms for the pair list). Beside it stands the epilogue: 4 CUDA-core
//   instructions a (query, target) pair (the add, the fma, the compare,
//   the candidate bit), 1.7e9 pairs pooled, 0.20 ms at the card's issue
//   rate. The design:
//   - Operands are rounded once, in device memory: a prologue
//     (row_prep_bf16) writes each row's float32 norm and the row rounded to
//     bf16, zero-padded to bf16_width(D) (whole 128-byte rows), into the
//     entry point's norm scratch. Blocks then read bf16, half the bytes of
//     float32, and round nothing. Queries share the pool's copy only when
//     they ARE the pool (the rule of the norms above).
//   - TMA from a producer warp: warp 8, of a third warpgroup that setmaxnreg
//     leaves 40 registers a thread (the consumers get 232), has
//     cp.async.bulk.tensor copy each tile's bf16 rows into a ring stage,
//     128-byte swizzled as wgmma reads them, and 4-byte cp.async copy its
//     norms and ids (any alignment; their latency off the producer's path).
//     Rows past the targets read as zeros; the pair list's tensor map is 3-D
//     (W, Kc, N), so a box never runs into the next image. Each stage has a
//     full mbarrier (expect-tx, and the producer lanes' copies) and an empty
//     one; 5 to 8 stages of 128 targets (D <= 128) or 64 (wider).
//   - Pooled, the cluster shares target tiles: clusters of 4 blocks, 2
//     query blocks x 2 target halves. The two blocks of a half stream the
//     same tiles, each copying half of each tile's rows to both
//     (.multicast::cluster), so a tile leaves L2 once for two query blocks;
//     a stage is refilled only when the consumer warps of both blocks have
//     released it (remote mbarrier arrives, at the block's scope: with a
//     cluster-scope release the pooled case took 2.74 ms, not 1.81). The
//     halves' lists
//     merge through distributed shared memory, as the 3xTF32 loop's do. 640
//     blocks at F = 40,960, one an SM (~170 KB of shared memory at D = 128):
//     4.8 waves on 132 SMs. The pair list runs one block a (pair, direction,
//     query block), no cluster: an image's targets are a few hundred KB of
//     L2.
//   - The epilogue overlaps the products by ping-pong: the two consumer
//     warpgroups (64 query rows each) take turns issuing their tile's
//     wgmma (named barriers), so one filters while the other's products
//     run. Each closes its wgmma stage (wait_group 0) before touching the
//     accumulators: two accumulator sets a warpgroup, with tile i + 1's
//     products in flight while tile i is read, made ptxas serialise every
//     wgmma of the kernel (warnings C7514/C7515).
//   - The epilogue filters in two passes. The first, branch-free over every
//     pair, marks the pairs under the quad's bound: the 4 lanes of a quad
//     keep lists of the same row over different columns, and together hold
//     K entries no worse than the K-th smallest of their 4 K entries (K = 2,
//     4; the largest lane's (K / 4)-th for K = 8, 16), so a candidate at or
//     beyond it cannot reach the final K. The second runs only for the
//     groups of 4 pairs where a lane of the warp has a candidate, with a
//     branch-free push. Tiles are filtered in ascending order, so push's
//     ascending-index assumption and the strict (distance, index) order
//     hold. A candidate costs a whole warp a group; that second pass, not
//     the products, still holds the kernel (tools/knn_bf16_probe.py on an
//     H100: without any epilogue the pooled case takes 0.72 ms, with the
//     first pass only 1.13 ms, whole 1.81 ms).
//   - One pass at every width: a warp loads its query fragments for all of
//     D once (D / 4 registers: 64 at D = 256). A tile is wgmma.m64n128k16
//     where a ring of such stages fits (D <= 128), else m64n64k16.

#include "knn_bf16.cuh"

namespace b1 {
namespace {

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

// The prologue of the bf16 instances, row_norms' bf16 form: one warp per
// row writes |x|^2, summed as row_norms sums it, and the row rounded to bf16
// once (to nearest even, as the reference's astype(bfloat16)) into xb, rows
// of W, zero from D on.
__global__ void row_prep_bf16(const float* __restrict__ x, int F, int D, int W,
                              float* __restrict__ out, __nv_bfloat16* __restrict__ xb) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= F) return;
  float s = 0.f;
  for (int d = lane; d < W; d += 32) {
    const float v = d < D ? x[(size_t)row * D + d] : 0.f;
    if (d < D) s = fmaf(v, v, s);
    xb[(size_t)row * W + d] = __float2bfloat16_rn(v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

// The bf16 rows of a scratch laid out as bf16_rows_at says.
__nv_bfloat16* bf16_rows(float* scratch, long long F) {
  return reinterpret_cast<__nv_bfloat16*>(scratch + bf16_rows_at(F));
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
template <int K, class Rows>
__global__ void refine(const Rows rows, long long n_rows, int D, int* __restrict__ idx,
                       float* __restrict__ dist) {
  const int lane = threadIdx.x % 32;
  const long long step = (long long)gridDim.x * (blockDim.x / 32);
  for (long long r = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; r < n_rows;
       r += step) {
    const float* qr = rows.query(r);
    float qv[DMAX / 32];
#pragma unroll
    for (int u = 0; u < DMAX / 32; ++u) qv[u] = lane + 32 * u < D ? qr[lane + 32 * u] : 0.f;
    float bd[K];
    int bi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[j] = dist[r * K + j];
      bi[j] = idx[r * K + j];
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
    for (int pass = 1; pass < K; ++pass)  // bubble sort, static indices (registers)
#pragma unroll
      for (int j = 0; j + 1 < K; ++j)
        if (better(bd[j + 1], bi[j + 1], bd[j], bi[j])) {
          const float d = bd[j];
          const int i = bi[j];
          bd[j] = bd[j + 1];
          bi[j] = bi[j + 1];
          bd[j + 1] = d;
          bi[j + 1] = i;
        }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      dist[r * K + j] = bd[j];
      idx[r * K + j] = bi[j];
    }
  }
}

// refine<K> for the instance's K (2, 4, 8 or KMAX).
template <class Rows>
cudaError_t launch_refine(const Rows& rows, long long n_rows, int D, int k, int* idx,
                          float* dist, cudaStream_t s) {
  const long long blocks = (n_rows + 7) / 8;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  switch (k) {
    case 2: refine<2><<<grid, 256, 0, s>>>(rows, n_rows, D, idx, dist); break;
    case 4: refine<4><<<grid, 256, 0, s>>>(rows, n_rows, D, idx, dist); break;
    case 8: refine<8><<<grid, 256, 0, s>>>(rows, n_rows, D, idx, dist); break;
    default: refine<KMAX><<<grid, 256, 0, s>>>(rows, n_rows, D, idx, dist);
  }
  return cudaGetLastError();
}

// The 3xTF32 instance of (K, D): up to DCHUNK here, above it in
// knn_wide.cu.
template <class Args, class... Rest>
cudaError_t launch_any(int K, int D, const Args& a, const Rest&... rest) {
  if (D > DCHUNK) return launch_wide(K, D, a, rest...);
  if constexpr (sizeof...(Rest) == 1)
    return launch_pooled<32, 64, 96, 128>(K, D, a, rest...);
  else
    return launch_pairs<32, 64, 96, 128>(K, D, a, rest...);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace
}  // namespace b1

using namespace b1;

// k is the instance's K (2, 4, 8 or 16): out (Fq, k). bf16 != 0 runs the
// bf16-operand instance, whose expansion-form distances are the result
// (no refine); qn and tn are then scratches of Fq and Ft rows laid out as
// bf16_rows_at says (knn_bf16.cuh), tn unused when q and t are one set.
extern "C" int apst_knn(const float* q, const int* qid, const int* qself, int Fq,
                        const float* t, const int* tid, int Ft, int D, int k, int bf16,
                        float* qn, float* tn, int* out_idx, float* out_dist, void* stream) {
  if (D % 32 != 0 || D > DMAX || (k != 2 && k != 4 && k != 8 && k != KMAX) || Fq <= 0 ||
      Ft <= 0)
    return (int)cudaErrorInvalidValue;
  if (misaligned(q) || misaligned(t)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one set (the norms once) only when the queries ARE the targets: queries
  // that are a prefix of the targets (one address, Fq < Ft, as a rank's
  // slice of the pool) need the targets' own norms
  const bool same = t == q && Ft == Fq;
  if (bf16) {
    const int W = bf16_width(D);
    __nv_bfloat16* qb = bf16_rows(qn, Fq);
    __nv_bfloat16* tb = same ? qb : bf16_rows(tn, Ft);
    row_prep_bf16<<<(Fq + 7) / 8, 256, 0, s>>>(q, Fq, D, W, qn, qb);
    if (!same) row_prep_bf16<<<(Ft + 7) / 8, 256, 0, s>>>(t, Ft, D, W, tn, tb);
    const Bf16Pooled a{qb, qid, qself, qn, Fq, tb, tid, same ? qn : tn, Ft, out_idx, out_dist};
    return (int)launch_bf16(k, D, a, s);
  }
  row_norms<<<(Fq + 7) / 8, 256, 0, s>>>(q, Fq, D, qn);
  if (!same) row_norms<<<(Ft + 7) / 8, 256, 0, s>>>(t, Ft, D, tn);
  const PooledArgs a{q, qid, qself, qn, Fq, t, tid, same ? qn : tn, Ft, out_idx, out_dist};
  const cudaError_t err = launch_any(k, D, a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_refine(PooledRows{q, t, D}, Fq, D, k, out_idx, out_dist, s);
}

// desc (N * Kc, D) row-major, tag (N * Kc) with -2 = invalid slot, pairs
// (P, 2) image indices < N; norms (N * Kc) scratch, with bf16 set laid out
// as bf16_rows_at says for N * Kc rows; k = 2, out (P, 2, Kc, k); bf16 as in
// apst_knn.
extern "C" int apst_knn_pairs(const float* desc, const int* tag, int N, int Kc, int D,
                              const int* pairs, int P, int k, int bf16, float* norms,
                              int* out_idx, float* out_dist, void* stream) {
  if (D % 32 != 0 || D > DMAX || k != 2 || N <= 0 || Kc <= 0 || P <= 0 ||
      2LL * P * ((Kc + BQ - 1) / BQ) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (misaligned(desc)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    __nv_bfloat16* db = bf16_rows(norms, (long long)N * Kc);
    row_prep_bf16<<<(N * Kc + 7) / 8, 256, 0, s>>>(desc, N * Kc, D, bf16_width(D), norms, db);
    return (int)launch_bf16(k, D, Bf16Pairs{db, tag, norms, N, Kc, pairs, out_idx, out_dist}, P, s);
  }
  row_norms<<<(N * Kc + 7) / 8, 256, 0, s>>>(desc, N * Kc, D, norms);
  const PairArgs a{desc, tag, norms, Kc, pairs, out_idx, out_dist};
  const cudaError_t err = launch_any(k, D, a, P, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_refine(PairRows{desc, pairs, Kc, D}, 2LL * P * Kc, D, k, out_idx, out_dist,
                            s);
}

extern "C" const char* apst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
