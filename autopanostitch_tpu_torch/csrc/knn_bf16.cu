// B1's bf16-operand instances, every width (32 to 256): the same tile loop
// (knn.cuh) with each operand rounded to bf16 once and one bf16 product a
// k-step (wgmma.m64n64k16, float32 sums), for `compute_dtype="bfloat16"`,
// where the reference takes its q.t in bf16 with float32 accumulation
// (autopanostitch_tpu/ops/matching.py `pairwise_sqdist`). No refine
// follows: the expansion-form distances from float32 norms are the result,
// as they are the reference's. Their own translation unit, so that their
// nvcc runs beside knn.cu's.

#include "knn.cuh"

namespace b1 {

cudaError_t launch_bf16(int K, int D, const PooledArgs& a, cudaStream_t s) {
  return launch_pooled<true, 32, 64, 96, 128, 160, 192, 224, 256>(K, D, a, s);
}

cudaError_t launch_bf16(int K, int D, const PairArgs& a, int P, cudaStream_t s) {
  return launch_pairs<true, 32, 64, 96, 128, 160, 192, 224, 256>(K, D, a, P, s);
}

}  // namespace b1
