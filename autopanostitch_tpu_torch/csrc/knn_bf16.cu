// B1's bf16-operand instances, every width (32 to 256): the tile loop of
// knn_bf16.cuh (TMA copies of targets rounded to bf16 once, in device
// memory, by knn.cu's prologue; a producer warp; one bf16 wgmma a k-step
// with float32 sums; two consumer warpgroups with one accumulator set each,
// taking turns so that one's epilogue runs under the other's products), for
// `compute_dtype="bfloat16"`, where the reference takes its q.t in bf16 with
// float32 accumulation (autopanostitch_tpu/ops/matching.py
// `pairwise_sqdist`), and for every binary width. No refine follows: the
// expansion-form distances from float32 norms are the result, as they are
// the reference's. Their own translation unit, so that their nvcc runs
// beside knn.cu's.

#include "knn_bf16.cuh"

namespace b1 {

// every width
template <int K>
using Bf16All = Bf16Widths<K, 32, 64, 96, 128, 160, 192, 224, 256>;

cudaError_t launch_bf16(int K, int D, const Bf16Pooled& a, cudaStream_t s) {
  switch (K) {
    case 2: return Bf16All<2>::pooled(D, a, s);
    case 4: return Bf16All<4>::pooled(D, a, s);
    case 8: return Bf16All<8>::pooled(D, a, s);
    case 16: return Bf16All<16>::pooled(D, a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(int K, int D, const Bf16Pairs& a, int P, cudaStream_t s) {
  return K == 2 ? Bf16All<2>::pairs(D, a, P, s) : cudaErrorInvalidValue;
}

}  // namespace b1
