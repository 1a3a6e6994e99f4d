// The rotational render stage's tile sampler.
//
// Replaces what the JAX package computes in `_render_tile_impl`
// (autopanostitch_tpu/models/render.py:292, its `sample_one` and the
// linear / none-* scans): XLA fusions there, no Pallas kernel. The multiband
// pyramid that blends its multiband output is `csrc/render_pyramid.cu`.
//
// `render_sample`: one thread a canvas pixel of a tile. The pixel's world
// ray (five projections), then for each contributor slot c in order: its
// camera (the k1 fixed point of `distort_pixels`, 6 steps, factor clamped at
// 0.25), the sample (nearest; bilinear; Keys a = -0.5 bicubic, 16 clamped
// taps summed row by row; bicubic2x: bilinear taps on the 2x upsampled stack
// at 2u + 0.5, validity in the original bounds), the feather and angle
// weight and the gain. For multiband it writes each slot's colour and
// weight; for linear and none-* it blends the slots in registers and writes
// the uint8 tile and its coverage.
//
// Arithmetic: this file is compiled with -fmad=false, so every product and
// sum rounds as PyTorch's elementwise operators round them; the sampler's
// plain version (`kernels/render.render_sample_plain`) writes its ray and
// rotation products as explicit sums and divides by tensors, and the kernel
// follows its order operation for operation.
//
// What bounds it on an H100: bytes. The sampler reads its taps from the
// image stack (L2-resident neighbourhoods) and writes 16 bytes a slot and
// pixel for multiband (4 a pixel for the others): at the ring's canvas (~70
// tiles of 96 x 384, 6 slots) ~0.25 GB, ~0.08 ms at 3.35 TB/s. Every output
// is written once by one thread in a fixed order: no atomics, so a tile's
// result does not depend on the other tiles of its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;

enum Mode { kCylindrical = 0, kSpherical = 1, kPlanar = 2, kStereographic = 3 };
enum Interp { kNearest = 0, kBilinear = 1, kBicubic = 2, kBicubic2x = 3 };
enum Blend { kMultiband = 0, kLinear = 1, kNoneLast = 2, kNoneFirst = 3, kNoneMaxangle = 4 };

struct SampleArgs {
  const float4* img;  // (N, Hs, Ws, 4): RGB + feather; the 2x stack for bicubic2x
  int n_img, Hs, Ws;
  int H, W;  // the bounds validity is judged in (the original stack's)
  const float* R;  // (N, 3, 3)
  const float* K;  // (N, 3, 3)
  const float* gains;  // (N, 3)
  const float* k1;  // (N,) or null: no distortion model
  const int* sel;  // (T, C)
  const unsigned char* ok;  // (T, C)
  const float* origins;  // (T, 2) [x, y]
  int T, C, th, tw;
  int mode, interp, blend;
  float f_pan, x0, y0;
  float rr[9];  // R_ref, row-major
  float angle_power;
  float* col;  // multiband: (T, C, th, tw, 3)
  float* w;  // multiband: (T, C, th, tw)
  unsigned char* out;  // others: (T, th, tw, 3)
  unsigned char* covered;  // others: (T, th, tw)
};

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// `tensor ** p` as PyTorch evaluates a Python-scalar exponent
__device__ __forceinline__ float pow_scalar(float b, float p) {
  if (p == 1.f) return b;
  if (p == 2.f) return b * b;
  if (p == 3.f) return b * b * b;
  if (p == 0.5f) return sqrtf(b);
  if (p == 0.f) return 1.f;
  return powf(b, p);
}

// clamp(int(f) + i, 0, n - 1) for an integer-valued f of any size
__device__ __forceinline__ int tap_index(float f, int i, int n) {
  const int k = static_cast<int>(fminf(fmaxf(f, -16.f), static_cast<float>(n) + 16.f)) + i;
  return min(max(k, 0), n - 1);
}

__device__ __forceinline__ float4 tap(const SampleArgs& p, int n, float xf, int i, float yf,
                                      int j) {
  const int xi = tap_index(xf, i, p.Ws), yi = tap_index(yf, j, p.Hs);
  return __ldg(&p.img[(static_cast<size_t>(n) * p.Hs + yi) * p.Ws + xi]);
}

__device__ __forceinline__ float4 axpy4(float4 acc, float a, float4 x) {
  return make_float4(acc.x + a * x.x, acc.y + a * x.y, acc.z + a * x.z, acc.w + a * x.w);
}

__device__ __forceinline__ float4 scale4(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

// Keys (a = -0.5), as `ops/sampling._cubic_kernel` writes it
__device__ __forceinline__ float keys(float t) {
  const float at = fabsf(t);
  const float at2 = at * at;
  const float at3 = at2 * at;
  const float w1 = (1.5f * at3 - 2.5f * at2) + 1.f;
  const float w2 = ((-0.5f * at3 - -2.5f * at2) + -4.f * at) - -2.f;
  return at <= 1.f ? w1 : (at < 2.f ? w2 : 0.f);
}

__device__ float4 bilinear(const SampleArgs& p, int n, float x, float y) {
  const float xf = floorf(x), yf = floorf(y);
  const float fx = x - xf, fy = y - yf;
  const float gx = 1.f - fx, gy = 1.f - fy;
  const float4 a = tap(p, n, xf, 0, yf, 0), b = tap(p, n, xf, 1, yf, 0);
  const float4 c = tap(p, n, xf, 0, yf, 1), d = tap(p, n, xf, 1, yf, 1);
  const float4 top = make_float4(a.x * gx + b.x * fx, a.y * gx + b.y * fx, a.z * gx + b.z * fx,
                                 a.w * gx + b.w * fx);
  const float4 bot = make_float4(c.x * gx + d.x * fx, c.y * gx + d.y * fx, c.z * gx + d.z * fx,
                                 c.w * gx + d.w * fx);
  return make_float4(top.x * gy + bot.x * fy, top.y * gy + bot.y * fy, top.z * gy + bot.z * fy,
                     top.w * gy + bot.w * fy);
}

// colour + feather of image n at (x, y), times its validity
__device__ float4 sample(const SampleArgs& p, int n, float x, float y, bool& valid) {
  const float Wm = static_cast<float>(p.W) - 1.f, Hm = static_cast<float>(p.H) - 1.f;
  float4 v;
  if (p.interp == kNearest) {
    valid = x >= -0.5f && x <= static_cast<float>(p.W) - 0.5f && y >= -0.5f &&
            y <= static_cast<float>(p.H) - 0.5f;
    v = tap(p, n, rintf(x), 0, rintf(y), 0);
  } else if (p.interp == kBicubic) {
    valid = x >= 0.f && x <= Wm && y >= 0.f && y <= Hm;
    const float xf = floorf(x), yf = floorf(y);
    const float fx = x - xf, fy = y - yf;
    v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = -1; j < 3; ++j) {
      float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = -1; i < 3; ++i)
        row = axpy4(row, keys(fx - static_cast<float>(i)), tap(p, n, xf, i, yf, j));
      v = axpy4(v, keys(fy - static_cast<float>(j)), row);
    }
  } else if (p.interp == kBicubic2x) {
    valid = x >= 0.f && x <= Wm && y >= 0.f && y <= Hm;
    v = bilinear(p, n, clamp_to(2.f * x + 0.5f, 0.f, 2.f * static_cast<float>(p.W) - 1.f),
                 clamp_to(2.f * y + 0.5f, 0.f, 2.f * static_cast<float>(p.H) - 1.f));
  } else {
    valid = x >= 0.f && x <= Wm && y >= 0.f && y <= Hm;
    v = bilinear(p, n, x, y);
  }
  return scale4(v, valid ? 1.f : 0.f);
}

__device__ __forceinline__ unsigned char to_u8(float v) {
  return static_cast<unsigned char>(clamp_to(v, 0.f, 1.f) * 255.f + 0.5f);
}

__global__ void __launch_bounds__(kThreads) render_sample_kernel(const SampleArgs p) {
  const int P = p.th * p.tw;
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid >= static_cast<long long>(p.T) * P) return;
  const int t = static_cast<int>(gid / P);
  const int pix = static_cast<int>(gid - static_cast<long long>(t) * P);
  const int ty = pix / p.tw, tx = pix - ty * p.tw;
  const float xp = static_cast<float>(tx) + p.origins[2 * t];
  const float yp = static_cast<float>(ty) + p.origins[2 * t + 1];
  const float u = xp / p.f_pan + p.x0, v = yp / p.f_pan + p.y0;
  float q0, q1, q2;  // the ray before normalisation
  if (p.mode == kCylindrical) {
    q0 = sinf(u);
    q1 = v;
    q2 = cosf(u);
  } else if (p.mode == kSpherical) {
    const float cphi = cosf(v);
    q0 = cphi * sinf(u);
    q1 = sinf(v);
    q2 = cphi * cosf(u);
  } else {
    float s0 = u, s1 = v;  // planar: (u, v, 1) in the reference camera's frame
    float s2 = 1.f;
    if (p.mode == kStereographic) {
      const float r2 = u * u + v * v;
      const float den = r2 + 1.f;
      s0 = 2.f * u / den;
      s1 = 2.f * v / den;
      s2 = (1.f - r2) / den;
    }
    const float* r = p.rr;  // R_ref^T s
    if (p.mode == kPlanar) {
      q0 = (s0 * r[0] + s1 * r[3]) + r[6];
      q1 = (s0 * r[1] + s1 * r[4]) + r[7];
      q2 = (s0 * r[2] + s1 * r[5]) + r[8];
    } else {
      q0 = (s0 * r[0] + s1 * r[3]) + s2 * r[6];
      q1 = (s0 * r[1] + s1 * r[4]) + s2 * r[7];
      q2 = (s0 * r[2] + s1 * r[5]) + s2 * r[8];
    }
  }
  const float nrm = clamp_min(sqrtf((q0 * q0 + q1 * q1) + q2 * q2), kEps);
  const float d0 = q0 / nrm, d1 = q1 / nrm, d2 = q2 / nrm;

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, wsum = 0.f, best = 0.f;
  for (int c = 0; c < p.C; ++c) {
    const int n = p.sel[t * p.C + c];
    const float okf = p.ok[t * p.C + c] ? 1.f : 0.f;
    const float* Rn = p.R + 9 * n;
    const float* Kn = p.K + 9 * n;
    const float dx = (d0 * Rn[0] + d1 * Rn[1]) + d2 * Rn[2];
    const float dy = (d0 * Rn[3] + d1 * Rn[4]) + d2 * Rn[5];
    const float dz = (d0 * Rn[6] + d1 * Rn[7]) + d2 * Rn[8];
    const bool front = dz > 1e-6f;
    const float dzs = clamp_min(dz, 1e-6f);
    const float cx = Kn[2], cy = Kn[5];
    float x = Kn[0] * (dx / dzs) + cx;
    float y = Kn[4] * (dy / dzs) + cy;
    if (p.k1 != nullptr) {  // `projections.distort_pixels`
      const float k1 = p.k1[n];
      const float ex = x - cx, ey = y - cy;
      const float rq2 = (ex * ex + ey * ey) / ((cx * cx + cy * cy) + 1e-12f);
      float rp2 = rq2;
      for (int it = 0; it < 6; ++it) {
        const float f = clamp_min(1.f + k1 * rp2, 0.25f);
        rp2 = rq2 / (f * f);
      }
      float fac = clamp_min(1.f + k1 * rp2, 0.25f);
      fac = rq2 > 2.25f ? 1.f : fac;
      x = cx + ex / fac;
      y = cy + ey / fac;
    }
    const float cosang = clamp_min(dz, 0.f);
    bool valid;
    const float4 s = sample(p, n, x, y, valid);
    const float wf = clamp_min(s.w, 0.f);
    const float wa = pow_scalar(front ? cosang : 0.f, p.angle_power);
    const float w =
        (((wa * clamp_min(wf, 1e-4f)) * (valid ? 1.f : 0.f)) * (front ? 1.f : 0.f)) * okf;
    const float* g = p.gains + 3 * n;
    const float c0 = s.x * (g[0] * okf), c1 = s.y * (g[1] * okf), c2 = s.z * (g[2] * okf);
    if (p.blend == kMultiband) {
      const size_t o = (static_cast<size_t>(t) * p.C + c) * P + pix;
      p.col[3 * o] = c0;
      p.col[3 * o + 1] = c1;
      p.col[3 * o + 2] = c2;
      p.w[o] = w;
    } else if (p.blend == kLinear) {
      acc0 = acc0 + c0 * w;
      acc1 = acc1 + c1 * w;
      acc2 = acc2 + c2 * w;
      wsum = wsum + w;
    } else {  // none-last | none-first | none-maxangle (`fuseTile` :863-914)
      const bool is_valid = w > 1e-6f;
      const bool write = p.blend == kNoneFirst   ? is_valid && wsum <= 1e-6f
                         : p.blend == kNoneMaxangle ? is_valid && w > best
                                                    : is_valid;
      if (write) {
        acc0 = c0;
        acc1 = c1;
        acc2 = c2;
        best = w;
      }
      wsum = wsum + w;
    }
  }
  if (p.blend == kMultiband) return;
  if (p.blend == kLinear) {
    const float den = clamp_min(wsum, kEps);
    acc0 = acc0 / den;
    acc1 = acc1 / den;
    acc2 = acc2 / den;
  }
  const bool cov = wsum > 1e-3f;
  const float cf = cov ? 1.f : 0.f;
  const size_t o = static_cast<size_t>(t) * P + pix;
  p.out[3 * o] = to_u8(acc0 * cf);
  p.out[3 * o + 1] = to_u8(acc1 * cf);
  p.out[3 * o + 2] = to_u8(acc2 * cf);
  p.covered[o] = cov ? 1 : 0;
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int apst_render_sample(const float* img, int n_img, int Hs, int Ws, int H, int W,
                                  const float* R, const float* K, const float* gains,
                                  const float* k1, const int* sel, const unsigned char* ok,
                                  const float* origins, int T, int C, int th, int tw, int mode,
                                  int interp, int blend, float f_pan, float x0, float y0,
                                  const float* r_ref, float angle_power, float* col, float* w,
                                  unsigned char* out, unsigned char* covered, void* stream) {
  const long long n = static_cast<long long>(T) * th * tw;
  if (T < 0 || C < 1 || th < 1 || tw < 1 || mode < 0 || mode > 3 || interp < 0 || interp > 3 ||
      blend < 0 || blend > 4 || n_img < 1 || blocks_for(n) > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  SampleArgs p{reinterpret_cast<const float4*>(img), n_img, Hs, Ws, H, W, R, K, gains, k1, sel,
               ok, origins, T, C, th, tw, mode, interp, blend, f_pan, x0, y0, {}, angle_power,
               col, w, out, covered};
  for (int i = 0; i < 9; ++i) p.rr[i] = r_ref[i];
  render_sample_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
