// B1's 3xTF32 instances for descriptor widths above 128 (160, 192, 224,
// 256): the same tile loop (knn.cuh), with each target tile passing the
// ring in two chunks of columns. Their own translation unit, so that their
// nvcc runs beside knn.cu's.

#include "knn.cuh"

namespace b1 {

cudaError_t launch_wide(int K, int D, const PooledArgs& a, cudaStream_t s) {
  return launch_pooled<160, 192, 224, 256>(K, D, a, s);
}

cudaError_t launch_wide(int K, int D, const PairArgs& a, int P, cudaStream_t s) {
  return launch_pairs<160, 192, 224, 256>(K, D, a, P, s);
}

}  // namespace b1
