// Checks the fused SIFT kernels' division (`div_rn` in csrc/sift_window.cu):
// q = a * y, y = rn(1 / b), then q + (a - q b) y by two FMAs, against the
// IEEE division __fdiv_rn, bit for bit, on random operands in the kernels'
// ranges: b = float32(2 pi), and b in [1, 128) (descriptor cell widths of
// about 4-12 px, the orientation weight's 2 sigma^2 of about 9-65, the
// descriptor Gaussian's d^2 / 2 of 2, 4.5 and 8; d = 1 divides by 0.5, a
// power of two, exactly); |a| in [2^-27, 2^9), both signs. A zero
// quotient may differ in sign only. Needs one CUDA GPU:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o div_rn_probe div_rn_probe.cu
//   ./div_rn_probe
//
// Prints the number of mismatches and exits 1 if any.

#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

__global__ void probe(unsigned long long* bad, float* example, uint32_t seed, int n_divisors) {
  uint32_t s = seed ^ (blockIdx.x * 2654435761u + threadIdx.x * 40503u);
  unsigned long long nbad = 0;
  for (int j = 0; j < n_divisors; ++j) {
    s = s * 1664525u + 1013904223u;
    const float b = j == 0 ? 6.28318530717958647692f
                           : __uint_as_float((s & 0x007fffffu) | ((127u + (s >> 29) % 7u) << 23));
    const float y = __frcp_rn(b);
    for (int i = 0; i < 256; ++i) {
      s = s * 1664525u + 1013904223u;
      const float a = __uint_as_float((s & 0x807fffffu) | ((100u + (s >> 24) % 36u) << 23));
      const float q = __fmul_rn(a, y);
      const float q2 = __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
      const float d = __fdiv_rn(a, b);
      if (__float_as_uint(q2) != __float_as_uint(d) && !(q2 == 0.f && d == 0.f)) {
        ++nbad;
        example[0] = a;
        example[1] = b;
      }
    }
  }
  atomicAdd(bad, nbad);
}

int main() {
  unsigned long long* bad;
  float* example;
  cudaMallocManaged(&bad, sizeof(*bad));
  cudaMallocManaged(&example, 2 * sizeof(float));
  *bad = 0;
  example[0] = example[1] = 0.f;
  const int reps = 20, blocks = 4096, threads = 256, divisors = 64;
  for (int r = 0; r < reps; ++r) probe<<<blocks, threads>>>(bad, example, 12345u + r, divisors);
  const cudaError_t e = cudaDeviceSynchronize();
  const unsigned long long total = 1ull * reps * blocks * threads * divisors * 256;
  printf("div_rn probe: %llu mismatches in %llu divisions (last a=%g b=%g) %s\n", *bad, total,
         example[0], example[1], cudaGetErrorString(e));
  return e != cudaSuccess || *bad != 0;
}
