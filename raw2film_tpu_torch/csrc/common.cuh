// Shared device helpers of the port's kernels: reflect-101 borders, the
// exp2/log2 forms of raw2film_tpu/ops/fastmath.py, the display encodes,
// the PCG-3D grain hash and cp.async copies.
//
// Every entry point is a plain C function (loaded with ctypes by
// raw2film_tpu_torch/kernels/build.py) that launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() after its launch.
//
// Built without --use_fast_math: exp2f/log2f are the accurate library forms
// (2 and 1 ulp), each a 15-28 instruction polynomial. The print tail (K3)
// and the development (K14's epilogue, K16) take their exp2/log2 from the
// SFU instead (lg2_sfu, ex2_sfu), as do the grain amplitudes of K2, K7 and
// K8; expe, used by K9's amplitude, stays on the library form.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define R2F_API extern "C" __attribute__((visibility("default")))

namespace r2f {

// float32 roundings of log2(10), log10(2), log2(e), ln(2), as the JAX
// package's fastmath holds them.
constexpr float LOG2_10 = 0x1.a934f0p+1f;
constexpr float LOG10_2 = 0x1.344136p-2f;
constexpr float LOG2_E = 0x1.715476p+0f;
constexpr float LN_2 = 0x1.62e430p-1f;

// Source index of position i on a length-n axis extended by reflect-101;
// pads longer than the axis reflect again (numpy's "reflect").
__device__ __forceinline__ int reflect101(int i, int n) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;  // inside: no modulo
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

// log2 and exp2 on the SFU (lg2/ex2.approx.ftz.f32): one instruction each.
// lg2 has an absolute error of about 2^-22 near 1 and a relative one of
// about 2^-22 elsewhere, ex2 a relative error of about 2^-22; the flush to
// zero of subnormal operands and results moves a value by at most 1e-38.
__device__ __forceinline__ float lg2_sfu(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float expe(float x) { return exp2f(x * LOG2_E); }

// The print tail's forms (K3), on the SFU.
__device__ __forceinline__ float pow10_(float x) { return ex2_sfu(x * LOG2_10); }

// w * log(1 + exp(u / w)) with inv_w = 1 / w precomputed in float32.
__device__ __forceinline__ float softplus(float u, float w, float inv_w) {
  const float t = u * inv_w;
  return w * (fmaxf(t, 0.0f) + LN_2 * lg2_sfu(1.0f + ex2_sfu(-fabsf(t) * LOG2_E)));
}

// The H&D curve's softplus in base 2 (K14's and K16's development): with
// x = log10(v + flare) = log2(v + flare) log10(2) and t = (x - x0) log2(e) / w,
// softplus(x - x0, w) = w ln(2) softplus2(t). The caller folds the
// per-channel factors once, so t is one FMA of log2(v + flare). No operand
// is subnormal (v + flare >= 1e-6, 1 + 2^-|t| in [1, 2]), so the flush to
// zero changes nothing.
__device__ __forceinline__ float softplus2(float t) {
  return fmaxf(t, 0.0f) + lg2_sfu(1.0f + ex2_sfu(-fabsf(t)));
}

// One channel's factors of that development: t = l2 k1 + k0 for l2 =
// log2(v + flare), and the density d_min + g_t softplus2(t_toe) - g_s
// softplus2(t_shoulder), g = gamma w ln(2). Folded from channel c of the
// 19-float develop vector [flare, d_min*3, gamma*3, x_toe*3, x_shoulder*3,
// w_toe*3, w_shoulder*3] (K14's, on the device, per thread; the head of
// K16's host vector, on the host, per launch), in the same float32 steps.
struct Curve2 {
  float k1_t, k0_t, k1_s, k0_s, g_t, g_s;
};
__host__ __device__ __forceinline__ Curve2 fold_curve2(const float* v, int c) {
  const float gam = v[4 + c];
  const float w_t = v[13 + c];
  const float w_s = v[16 + c];
  const float a_t = LOG2_E / w_t;
  const float a_s = LOG2_E / w_s;
  Curve2 k;
  k.k1_t = LOG10_2 * a_t;
  k.k0_t = -v[7 + c] * a_t;
  k.k1_s = LOG10_2 * a_s;
  k.k0_s = -v[10 + c] * a_s;
  k.g_t = gam * w_t * LN_2;
  k.g_s = gam * w_s * LN_2;
  return k;
}

__device__ __forceinline__ float powc(float x, float p) {
  return ex2_sfu(lg2_sfu(fmaxf(x, 1e-30f)) * p);
}

// Display transfer codes; the order of raw2film_tpu_torch/ops/print_encode.py
// GAMMA_CODES.
enum Gamma : int {
  GAMMA_LINEAR = 0,
  GAMMA_SRGB = 1,  // also "Display P3"
  GAMMA_REC709 = 2,
  GAMMA_22 = 3,
  GAMMA_24 = 4,
  GAMMA_LOGC3 = 5,
};

__device__ __forceinline__ float encode(float x, int gamma) {
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  switch (gamma) {
    case GAMMA_SRGB:
      return x <= 0.0031308f ? 12.92f * x
                             : 1.055f * powc(x, 0.41666666f) - 0.055f;
    case GAMMA_REC709:  // breakpoint is strict here, <= for sRGB
      return x < 0.018f ? 4.5f * x : 1.099f * powc(x, 0.45f) - 0.099f;
    case GAMMA_22:
      return powc(x, 0.45454547f);
    case GAMMA_24:
      return powc(x, 0.41666666f);
    case GAMMA_LOGC3: {
      const float c_log10_2 = 0.24719f * LOG10_2;
      return x > 0.010591f ? c_log10_2 * lg2_sfu(5.555556f * x + 0.052272f) + 0.385537f
                           : 5.367655f * x + 0.092809f;
    }
    default:
      return x;
  }
}

// PCG-3D (Jarzynski & Olano) in native uint32 arithmetic, wrapping mod 2^32:
// raw2film_tpu/ops/pallas_grain.py::_pcg3d.
__device__ __forceinline__ uint32_t lcg(uint32_t v) { return v * 1664525u + 1013904223u; }

// PCG-3D's two words from its three coordinates' LCG steps X, Y, Z and the
// product yz = Y * Z, which a run along a row computes once.
__device__ __forceinline__ void pcg3d_row(uint32_t X, uint32_t Y, uint32_t Z, uint32_t yz,
                                          uint32_t& a, uint32_t& b) {
  uint32_t v0 = X + yz;
  uint32_t v1 = Y + Z * v0;
  uint32_t v2 = Z + v0 * v1;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v2 ^= v2 >> 16;
  a = v0 + v1 * v2;
  b = v1 + v2 * a;  // the third word is unused by the grain normals
}

__device__ __forceinline__ void pcg3d(uint32_t x, uint32_t y, uint32_t z,
                                      uint32_t& a, uint32_t& b) {
  const uint32_t Y = lcg(y), Z = lcg(z);
  pcg3d_row(lcg(x), Y, Z, Y * Z, a, b);
}

// Channel salt of the hash's z coordinate: ch * 0x9E3779B9 + seed.
__device__ __forceinline__ uint32_t grain_z(int ch, uint32_t seed) {
  return static_cast<uint32_t>(ch) * 0x9E3779B9u + seed;
}

// S - 32, S = popc(a) + popc(b) in 0..64, exactly and without a quarter-rate
// I2F: 2^23 + S as a float holds S in its low mantissa bits, and
// (2^23 + S) - (2^23 + 32) is exact.
__device__ __forceinline__ float grain_centred(uint32_t a, uint32_t b) {
  return __int_as_float(0x4B000000 | (__popc(a) + __popc(b))) - 8388640.0f;
}

// Binomial(64, 1/2) normal from the two hash words: (S - 32) / 4.
__device__ __forceinline__ float grain_normal(uint32_t a, uint32_t b) {
  return grain_centred(a, b) * 0.25f;
}

// One float from device to shared memory without a register on the way;
// complete with cp.async.wait_all (or commit and wait_group).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// 16 bytes (both addresses 16-byte aligned), through L2 only.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Close the thread's group of cp.async copies issued since the last one.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of the thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace r2f
