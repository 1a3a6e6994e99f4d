// The rotational bundle adjustment's whole linearisation: the dense,
// undamped normal equations H (PD nb x PD nb), g (PD nb) and the robust cost
// of one LM iteration, straight from the phase's cameras and matches.
//
// Replaces what the JAX package computes as `build_normal_eqns`
// (autopanostitch_tpu/models/bundle.py:715): `pair_system` (:682; no Pallas
// kernel, XLA fuses it inside the LM phase program) over the pairs, then
// scatter-adds of each pair's four PD x PD blocks and of g. The per-match
// arithmetic is `ba_direction.cuh`'s; the plain version (`kernels/ba.py`)
// sums per-pair blocks and assembles them by one-hot einsums.
//
// What bounds it on an H100: at BA's sizes (<= 128 pairs of <= 300 match
// slots, 17-22 % of them real on chip_smoke.py's scenes) neither bytes (H's
// (PD nb)^2 floats written, 0.4-1.6 MB: 0.12-0.5 us) nor operations
// (~1,000 float32 a real match: < 0.1 us), but latency: a match's chain of
// dependent float32 and SFU operations, two reductions and the launches.
// Design:
//  1. `pair_sums`: a thread block cluster of kCluster blocks a pair, each of
//     kWarps warps. The pair's real matches (its extent, the last slot with
//     w > 0 plus 1, known on the host) are cut into chunks of kChunk; chunk c
//     runs in warp slot c % kSlots, so consecutive chunks land on different
//     SMs and no slot computes padding. In a warp, lanes 0-15 take direction
//     i -> j of the chunk's 16 matches and lanes 16-31 direction j -> i:
//     each lane runs one direction's residual and Jacobian chain (half of
//     a match's chain) and swaps its depth with its
//     partner for the front-facing mask. A chunk's u_i, u_j, w and the
//     pair's two cameras go in flight together (cp.async into shared
//     memory, after one load of the pair's indices; a slot's next chunk is
//     staged while it computes). Each lane writes its two rows' NS products
//     (upper triangle of J^T W J, J^T W r, r^T W r) as one shared-memory row;
//     lane l then sums columns l, l + 32, l + 64 over the chunk's rows in
//     match order (no shuffle trees). Block rank 0 sums the slots' partials
//     in slot order through distributed shared memory and writes the pair's
//     record: its full 2PD x 2PD block (the triangle index in closed form),
//     its g part and its cost.
//  2. `assemble`: one block a (camera a, kAsmThreads columns) of H's block
//     row a and, past H's last column, g's PD entries of camera a (one
//     thread a column, so no branch keeps a thread of its own for g: ptxas
//     spilled one that did). H[a, b] is the sum, over a's incidence list (pair p, side s) in
//     ascending pair order, of pair p's block (s, t) for each side t whose
//     camera is b: a diagonal block sums a's pairs in list order, an
//     off-diagonal block is its one pair's block (or its transpose) or zero.
//     g likewise; the cost sums the pairs' costs in pair order. It is
//     launched as `pair_sums`' programmatic dependent (Hopper's
//     griddepcontrol): it launches while `pair_sums` runs, reads the lists,
//     then waits for the pairs' records; its launch latency and the lists'
//     dependent loads overlap `pair_sums`.
// Every output entry is written once, by one thread, in a fixed order: no
// float atomics and no zero-fill, so a repeat launch is bit-identical,
// which the graph-replayed LM relies on to equal its eager run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ba_direction.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 16;                 // matches a warp takes at once (one a lane pair)
constexpr int kWarps = 4;                  // warps a block of pair_sums
constexpr int kCluster = 4;                // blocks a pair: a thread block cluster
constexpr int kSlots = kWarps * kCluster;  // warp slots a pair
constexpr int kAsmThreads = 256;           // H columns a block of assemble writes

template <int PD>
struct Sizes {
  static constexpr int NP = 2 * PD;                // parameters of a pair
  static constexpr int NH = NP * (NP + 1) / 2;     // upper triangle of its block
  static constexpr int NS = NH + NP + 1;           // + g part + cost
  static constexpr int LD = NS | 1;                // odd row stride: rows and columns conflict-free
  static constexpr int NREC = NP * NP + NP + 1;    // a pair's record: full block, g part, cost
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int PD>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kWarps * 32)
    pair_sums_kernel(const float* __restrict__ Rb, const float* __restrict__ f,
                     const float* __restrict__ k1, const float* __restrict__ cx,
                     const float* __restrict__ cy, const float2* __restrict__ u_i,
                     const float2* __restrict__ u_j, const float* __restrict__ w,
                     const long long* __restrict__ pij, const long long* __restrict__ ext,
                     int M, float sigma, int one_direction, float* __restrict__ rec) {
  using S = Sizes<PD>;
  constexpr int NP = S::NP, NH = S::NH, NS = S::NS;
  __shared__ float rows[kWarps][32][S::LD];  // a chunk's products, one row a lane
  __shared__ float slot_sum[kWarps][NS];     // each warp slot's sums (read by rank 0)
  __shared__ float total[NS];
  __shared__ float2 st_ui[2][kWarps][kChunk], st_uj[2][kWarps][kChunk];
  __shared__ float st_w[2][kWarps][kChunk];
  __shared__ Cam cams[2];

  // the assembly grid may launch now: it reads the lists while this grid runs
  // and waits for this grid's records at griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int p = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane & 15, dir = lane >> 4;
  const int slot = rank + kCluster * warp;  // chunk c runs in slot c % kSlots
  const int e = static_cast<int>(min(ext[p], static_cast<long long>(M)));
  const int nch = (e + kChunk - 1) / kChunk;

  // lanes 0-15 copy u_i and w of the chunk's matches, lanes 16-31 u_j
  auto stage = [&](int c, int buf) {
    const int m = c * kChunk + half;
    if (m < e) {
      const size_t at = static_cast<size_t>(p) * M + m;
      if (dir == 0) {
        cp_async8(&st_ui[buf][warp][half], &u_i[at]);
        cp_async4(&st_w[buf][warp][half], &w[at]);
      } else {
        cp_async8(&st_uj[buf][warp][half], &u_j[at]);
      }
    }
  };
  if (slot < nch) stage(slot, 0);
  if (threadIdx.x < 26) {  // the pair's two cameras, 13 floats each
    const int side = threadIdx.x / 13, k = threadIdx.x % 13;
    const long long c = pij[2 * p + side];
    const float* src = k < 9 ? Rb + c * 9 + k
                             : (k == 9 ? f : k == 10 ? k1 : k == 11 ? cx : cy) + c;
    cp_async4(reinterpret_cast<float*>(&cams[side]) + k, src);
  }
  cp_async_commit();  // group: the slot's first chunk and the cameras
  if (slot + kSlots < nch) stage(slot + kSlots, 1);
  cp_async_commit();  // group: its second chunk
  cp_async_wait<1>();
  __syncthreads();  // the cameras, for every warp
  const Cam& cs = cams[dir];  // this lane's direction: source and destination
  const Cam& cd = cams[dir ^ 1];

  float acc[3] = {0.f, 0.f, 0.f};  // this lane's sums: entries lane, lane + 32, lane + 64
  int buf = 0;
  for (int c = slot; c < nch; c += kSlots, buf ^= 1) {
    __syncwarp();  // the chunk's copies, landed for each lane, visible to the warp
    const bool live = c * kChunk + half < e;
    const float2 ui = live ? st_ui[buf][warp][half] : make_float2(0.f, 0.f);
    const float2 uj = live ? st_uj[buf][warp][half] : make_float2(0.f, 0.f);
    const float wm = live ? st_w[buf][warp][half] : 0.f;
    const float2 us = dir ? uj : ui, ud = dir ? ui : uj;
    float r[2], Js[2][PD], Jd[2][PD], z;
    direction<PD>(cs, cd, us.x, us.y, ud.x, ud.y, r, Js, Jd, z);
    const float z_other = __shfl_xor_sync(0xffffffffu, z, 16);
    const float hub =
        (dir && one_direction) ? 0.f : fminf(1.f, sigma / sqrtf(r[0] * r[0] + r[1] * r[1] + 1e-12f));
    const float wv = hub * (wm * ((z > 1e-4f && z_other > 1e-4f) ? 1.f : 0.f));
    // the lane's two rows of J against [params_i, params_j]
    float J[2][NP];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
#pragma unroll
      for (int k = 0; k < PD; ++k) {
        J[row][k] = dir ? Jd[row][k] : Js[row][k];
        J[row][PD + k] = dir ? Js[row][k] : Jd[row][k];
      }
    }
    if (live) {
      float* out = rows[warp][lane];
      int s = 0;
#pragma unroll
      for (int a = 0; a < NP; ++a) {
        const float jw0 = J[0][a] * wv, jw1 = J[1][a] * wv;
#pragma unroll
        for (int b = a; b < NP; ++b) out[s++] = jw0 * J[0][b] + jw1 * J[1][b];
        out[NH + a] = jw0 * r[0] + jw1 * r[1];
      }
      out[NS - 1] = wv * r[0] * r[0] + wv * r[1] * r[1];
    }
    __syncwarp();
    const int nv = min(kChunk, e - c * kChunk);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int s = lane + 32 * j;
      if (s < NS) {
        float t = 0.f;
#pragma unroll
        for (int m = 0; m < kChunk; ++m) {
          if (m < nv) t += rows[warp][m][s] + rows[warp][kChunk + m][s];
        }
        acc[j] += t;
      }
    }
    __syncwarp();  // rows and this buffer consumed
    if (c + 2 * kSlots < nch) stage(c + 2 * kSlots, buf);
    cp_async_commit();
    cp_async_wait<1>();  // the slot's next chunk
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (lane + 32 * j < NS) slot_sum[warp][lane + 32 * j] = acc[j];
  }
  cluster.sync();
  if (rank == 0) {
    const int used = min(nch, kSlots);
    for (int s = threadIdx.x; s < NS; s += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        if (q < used) t += cluster.map_shared_rank(&slot_sum[q / kCluster][0], q % kCluster)[s];
      }
      total[s] = t;
    }
    __syncthreads();
    float* out = rec + static_cast<size_t>(p) * S::NREC;
    for (int t = threadIdx.x; t < S::NREC; t += blockDim.x) {
      int s = NH + t - NP * NP;  // g part, cost
      if (t < NP * NP) {
        const int a = t / NP, b = t % NP, lo = min(a, b), hi = max(a, b);
        s = lo * NP - lo * (lo - 1) / 2 + hi - lo;
      }
      out[t] = total[s];
    }
  }
  cluster.sync();  // every block's slot_sum stays alive until rank 0 has read it
}

// Entries e0 .. e0 + n of a camera's incidence list into shared memory (one
// a thread): the pair's record offset, the side, the pair's two cameras.
template <int NREC>
__device__ __forceinline__ void load_entries(const long long* __restrict__ inc,
                                             const long long* __restrict__ pij, long long e0,
                                             int n, int* pair_at, int* side_of,
                                             int (*cam_of)[2]) {
  if (threadIdx.x < n) {
    const long long en = inc[e0 + threadIdx.x];
    const long long pr = en >> 1;
    pair_at[threadIdx.x] = static_cast<int>(pr * NREC);
    side_of[threadIdx.x] = static_cast<int>(en & 1);
    cam_of[threadIdx.x][0] = static_cast<int>(pij[2 * pr]);
    cam_of[threadIdx.x][1] = static_cast<int>(pij[2 * pr + 1]);
  }
}

template <int PD>
__global__ void __launch_bounds__(kAsmThreads)
    assemble_kernel(const float* __restrict__ rec, const long long* __restrict__ pij,
                    const long long* __restrict__ inc_off, const long long* __restrict__ inc,
                    int nb, int pb, float* __restrict__ H, float* __restrict__ g,
                    float* __restrict__ cost) {
  using S = Sizes<PD>;
  constexpr int NP = S::NP;
  __shared__ int pair_at[kAsmThreads];  // a list chunk: each entry's record offset,
  __shared__ int side_of[kAsmThreads];  // its side,
  __shared__ int cam_of[kAsmThreads][2];  // its pair's cameras
  const int a = blockIdx.x;
  const int N = PD * nb;
  // this thread's column of the block row: H's column col < N, or g's entry
  // col - N (then b = nb, a camera no pair has, and c = col - N)
  const int col = blockIdx.y * kAsmThreads + threadIdx.x;
  const int b = col / PD, c = col - b * PD;
  const bool g_col = col >= N && col < N + PD;
  const long long lo = inc_off[a], hi = inc_off[a + 1];
  // the lists are inputs, not `pair_sums`' outputs: the first chunk is read
  // before waiting for that grid (launched as its programmatic dependent)
  load_entries<S::NREC>(inc, pij, lo, static_cast<int>(min(static_cast<long long>(kAsmThreads),
                                                           hi - lo)),
                        pair_at, side_of, cam_of);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float acc[PD];
#pragma unroll
  for (int r = 0; r < PD; ++r) acc[r] = 0.f;
  for (long long e0 = lo; e0 < hi; e0 += kAsmThreads) {
    const int n = static_cast<int>(min(static_cast<long long>(kAsmThreads), hi - e0));
    if (e0 != lo) {
      __syncthreads();  // the previous list chunk is consumed
      load_entries<S::NREC>(inc, pij, e0, n, pair_at, side_of, cam_of);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      if (g_col) {
        acc[0] += rec[pair_at[k] + NP * NP + side_of[k] * PD + c];
        continue;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (cam_of[k][t] == b) {
          const float* blk = rec + pair_at[k] + side_of[k] * PD * NP + t * PD + c;
#pragma unroll
          for (int r = 0; r < PD; ++r) acc[r] += blk[r * NP];
        }
      }
    }
  }
  if (col < N) {
#pragma unroll
    for (int r = 0; r < PD; ++r) H[static_cast<size_t>(a * PD + r) * N + col] = acc[r];
  } else if (g_col) {
    g[a * PD + c] = acc[0];
  }
  if (a == 0 && blockIdx.y == 0 && threadIdx.x < 32) {  // the cost, pairs in order
    float t = 0.f;
    for (int p0 = 0; p0 < pb; p0 += 32) {
      const int p = p0 + threadIdx.x;
      const float v = p < pb ? rec[static_cast<size_t>(p) * S::NREC + S::NREC - 1] : 0.f;
      const int n = min(32, pb - p0);
      for (int k = 0; k < n; ++k) t += __shfl_sync(0xffffffffu, v, k);
    }
    if (threadIdx.x == 0) *cost = t;
  }
}

__global__ void noop_kernel() {}

template <int PD>
int launch(const float* Rb, const float* f, const float* k1, const float* cx, const float* cy,
           const float* u_i, const float* u_j, const float* w, const long long* pij,
           const long long* ext, const long long* inc_off, const long long* inc, int nb, int pb,
           int M, float sigma, int one_direction, float* rec, float* H, float* g, float* cost,
           cudaStream_t s) {
  if (pb > 0) {
    pair_sums_kernel<PD><<<dim3(kCluster, pb), kWarps * 32, 0, s>>>(
        Rb, f, k1, cx, cy, reinterpret_cast<const float2*>(u_i),
        reinterpret_cast<const float2*>(u_j), w, pij, ext, M, sigma, one_direction, rec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the assembly as pair_sums' programmatic dependent (Hopper): its launch and
  // its reads of the lists overlap pair_sums. Without pair_sums ahead of it
  // (pb = 0) it launches plainly, after whatever wrote its inputs.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, (PD * nb + PD + kAsmThreads - 1) / kAsmThreads);
  cfg.blockDim = dim3(kAsmThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pb > 0 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, assemble_kernel<PD>, rec, pij, inc_off, inc,
                                             nb, pb, H, g, cost));
}

}  // namespace

// H (pd nb, pd nb), g (pd nb), cost (1) of one LM linearisation; rec is the
// pairs' scratch, pb x ((2pd)^2 + 2pd + 1) floats. ext (pb), inc_off (nb + 1)
// and inc (2 pb: 2 x pair + side, each camera's pairs ascending) come from
// the phase plan.
extern "C" int apst_ba_system(const float* Rb, const float* f, const float* k1, const float* cx,
                              const float* cy, const float* u_i, const float* u_j,
                              const float* w, const long long* pij, const long long* ext,
                              const long long* inc_off, const long long* inc, int nb, int pb,
                              int M, int pd, float sigma, int one_direction, float* rec, float* H,
                              float* g, float* cost, void* stream) {
  if (nb <= 0 || nb > 65535 || pb < 0 || pb > 65535 || M < 0 || (pd != 4 && pd != 5))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pd == 5)
    return launch<5>(Rb, f, k1, cx, cy, u_i, u_j, w, pij, ext, inc_off, inc, nb, pb, M, sigma,
                     one_direction, rec, H, g, cost, s);
  return launch<4>(Rb, f, k1, cx, cy, u_i, u_j, w, pij, ext, inc_off, inc, nb, pb, M, sigma,
                   one_direction, rec, H, g, cost, s);
}

// An empty kernel: the launch floor that chip_smoke.py times beside the
// linearisation.
extern "C" int apst_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
