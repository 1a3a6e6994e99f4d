// B1's instances for descriptor widths above 128 (160, 192, 224, 256): the
// same tile loop (knn.cuh), with each target tile passing the ring in two
// chunks of columns. Their own translation unit, so that their nvcc runs
// beside knn.cu's.

#include "knn.cuh"

namespace b1 {
namespace {

template <int K, class... Rest>
cudaError_t wide_d(int D, const Rest&... rest) {
  switch (D) {
    case 160: return launch<K, 160>(rest...);
    case 192: return launch<K, 192>(rest...);
    case 224: return launch<K, 224>(rest...);
    case 256: return launch<K, 256>(rest...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_wide(int K, int D, const PooledArgs& a, cudaStream_t s) {
  switch (K) {
    case 1: return wide_d<1>(D, a, s);
    case 2: return wide_d<2>(D, a, s);
    case 3: return wide_d<3>(D, a, s);
    case 4: return wide_d<4>(D, a, s);
    case 5: return wide_d<5>(D, a, s);
    case 6: return wide_d<6>(D, a, s);
    case 7: return wide_d<7>(D, a, s);
    case 8: return wide_d<8>(D, a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_wide(int K, int D, const PairArgs& a, int P, cudaStream_t s) {
  switch (K) {
    case 1: return wide_d<1>(D, a, P, s);
    case 2: return wide_d<2>(D, a, P, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace b1
