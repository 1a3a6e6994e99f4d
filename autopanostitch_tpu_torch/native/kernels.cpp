// Native host kernels — the framework's equivalent of the reference's MEX
// layer (`Procedural Program/mex/`):
//  - hamming_2nn: exact 1st/2nd nearest neighbour under Hamming distance
//    over packed bytes, OpenMP-parallel over query rows. Mirrors
//    `nearest2HammingExhaustiveMEX.cpp` / `...OMPMEX.cpp` but uses 64-bit
//    popcount words instead of a 256-entry LUT and row-major layout.
//    (Binary matching on the card runs on kernel B1, csrc/knn.cu; this
//    host kernel serves CPU-only deployments and as a cross-check.)
//  - max_rectangle: largest all-true axis-aligned rectangle in a mask via
//    per-row histogram + monotonic stack. Mirrors `panoramaCropper.m:96-157`.
//
// Built as a plain shared library (no Python headers) and bound via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// A: (na, nbytes) row-major packed descriptors; B: (nb, nbytes).
// Outputs per query row of A: idx (best index in B), d1, d2 (best/second
// Hamming distances).
void hamming_2nn(const uint8_t* A, int64_t na, const uint8_t* B, int64_t nb,
                 int64_t nbytes, int32_t* idx, int32_t* d1, int32_t* d2) {
  const int64_t nwords = nbytes / 8;
  const int64_t rem = nbytes % 8;
#pragma omp parallel for schedule(static)
  for (int64_t q = 0; q < na; ++q) {
    const uint8_t* a = A + q * nbytes;
    int32_t best = INT32_MAX, second = INT32_MAX, best_i = -1;
    for (int64_t t = 0; t < nb; ++t) {
      const uint8_t* b = B + t * nbytes;
      int32_t dist = 0;
      const uint64_t* aw = reinterpret_cast<const uint64_t*>(a);
      const uint64_t* bw = reinterpret_cast<const uint64_t*>(b);
      for (int64_t w = 0; w < nwords; ++w) {
        dist += __builtin_popcountll(aw[w] ^ bw[w]);
      }
      for (int64_t r = nwords * 8; r < nwords * 8 + rem; ++r) {
        dist += __builtin_popcount((unsigned)(a[r] ^ b[r]));
      }
      if (dist < best) {
        second = best;
        best = dist;
        best_i = (int32_t)t;
      } else if (dist < second) {
        second = dist;
      }
    }
    idx[q] = best_i;
    d1[q] = best;
    d2[q] = second;
  }
}

// mask: (h, w) row-major uint8 (0/1). out4 = {r0, r1, c0, c1} of the
// largest all-true rectangle ([r0, r1) x [c0, c1)); all zeros if empty.
void max_rectangle(const uint8_t* mask, int64_t h, int64_t w, int32_t* out4) {
  std::vector<int32_t> heights(w, 0);
  std::vector<int32_t> stack;
  stack.reserve(w + 1);
  int64_t best_area = 0;
  int32_t br0 = 0, br1 = 0, bc0 = 0, bc1 = 0;
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* row = mask + r * w;
    for (int64_t c = 0; c < w; ++c) heights[c] = row[c] ? heights[c] + 1 : 0;
    stack.clear();
    for (int64_t i = 0; i <= w; ++i) {
      int32_t hcur = (i < w) ? heights[i] : 0;
      while (!stack.empty() && heights[stack.back()] >= hcur) {
        int32_t top = stack.back();
        stack.pop_back();
        int64_t left = stack.empty() ? 0 : stack.back() + 1;
        int64_t area = (int64_t)heights[top] * (i - left);
        if (area > best_area) {
          best_area = area;
          br1 = (int32_t)(r + 1);
          br0 = br1 - heights[top];
          bc0 = (int32_t)left;
          bc1 = (int32_t)i;
        }
      }
      stack.push_back((int32_t)i);
    }
  }
  out4[0] = br0;
  out4[1] = br1;
  out4[2] = bc0;
  out4[3] = bc1;
}

}  // extern "C"
