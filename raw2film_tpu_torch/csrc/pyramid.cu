// K10, K12 and K13: the pyramid resamples of the halation glow.
//
// K10 box_downsample replaces raw2film_tpu/ops/pallas_pyramid.py::
// box_downsample_pallas: (C, H, W) -> (C, H/f, W/f) block mean for any
// integer f, the remainder cropped. Each output sums its f x f block down
// each column first, then the column sums left to right (the order of
// Dh @ x @ Dw with 0/1 bands), then multiplies by float32(1 / f^2), as the
// TPU path does after its kernel.
//
// K12 upsample_rows replaces pallas_pyramid.py::bilinear_upsample_rows_pallas:
// the x f half-pixel lerp of the row axis only, edge clamp at both ends,
// cropped to oh rows; columns untouched. Output row o = q f + m reads input
// rows q + b_m and q + b_m + 1 (each clamped to [0, h - 1]) with weights
// 1 - frac_m and frac_m, where rel = (m + 0.5) / f - 0.5, b_m = floor(rel)
// and frac_m = rel - b_m are taken in double precision and rounded to
// float32, as the host builds the TPU kernel's lerp matrix (the phase
// table below). Where the clamp folds both taps onto one row, the first
// weight is their float32 sum and the second 0, as in the lerp matrix. For
// f = 4 the weights are exact: 0.125, 0.375, 0.625, 0.875.
//
// K13 upsample replaces pallas_pyramid.py::bilinear_upsample_pallas: the
// 2-D x f half-pixel lerp with edge clamp, cropped to (oh, ow), for any
// integer f up to UP_MAX_F. The TPU runs it as Uh @ window @ Uw with lerp
// band matrices per chunk; here each output lerps the rows first, then the
// two row results along the columns (the order of Uh @ win @ Uw), with the
// K12 weights on both axes. Where the clamp folds both taps onto one
// sample, the first weight is their float32 sum and the second 0, as in
// the lerp matrix.
//
// Bound on the H100: device memory, all three. At 45 MP K10 reads 540 MB and
// writes 34 MB; K12 reads 34 MB (each input row serves 2f output rows, from
// L2) and writes 135 MB. K13 reads 1/f^2 of what it writes (from L2) and
// writes 540 MB at 45 MP: its stores are the bound.
//
// K10's design: where f is 4 (the render) or 8 (the /8 level), W % 4 == 0
// and the input is 16-byte aligned, the input is read in 16-byte read-only
// loads (__ldg). A thread makes BOX_RUN = 2 outputs from f/4 such loads
// per input row each, so at f = 4 eight 16-byte loads are in flight per
// thread. The lanes of a warp take consecutive 16-byte slots of each input
// row, so every warp load is 512 contiguous bytes (the one-thread-per-
// output kernel's loads use 128 of the 512 bytes each warp instruction
// spans). The streaming, non-allocating loads (__ldcs, ld.global.nc.L1::
// no_allocate) measured 2-3 % slower than __ldg on the H100, a 256-byte L2
// prefetch 20 % slower, and 1-4 outputs a thread or other block shapes
// within 2 % (scripts/k10_variants.py). The sums keep the scalar kernel's
// order (each column top to bottom, the columns left to right, then x
// float32(1/f^2)). The one-thread-per-output kernel serves every other
// shape (the resize's other integer shrinks among them); the wrapper picks
// by shape and alignment.
//
// K12's design, the row half of K13's: the phase table comes by value, so
// no output divides (one thread per output paid an integer division and
// modulo by f and a float64 division and floor for its phase). A thread
// owns UP_RUN = 4 consecutive columns and walks ROWS_RPT = 4 consecutive
// output rows, stepping the phase by increments; it loads its two input
// rows only where the row pair changes and keeps the shared row where the
// pair slides by one (at f = 4, 3 loads for 4 output rows away from the
// edges). Where w % 4 == 0 and both buffers are 16-byte aligned
// (ops/pyramid.py::rows_vec_path), the rows come as 16-byte __ldg loads and
// each output run goes out as one 16-byte store; else 4 scalar ones. Each
// output is fma(w1, b, w0 a), rounded as the lerp matrix's product
// accumulates its row (row r0 first, the zeros exact), so that a compiler's
// choice of which product to fuse cannot move it by an ulp. On the
// H100, runs of 4 rows measured 4 % faster than runs of 8 and 14 % faster
// than runs of 16, and streaming stores (__stcs) tied with plain ones
// (scripts/k1_k12_variants.py).
//
// K13's design: the f phase weights and offsets come by value in the launch
// (Phases, built once per f on the host in float64 and rounded to float32,
// as ops/pyramid.py::lerp_taps builds them), so no output divides in double
// precision. A thread owns UP_RUN = 4 consecutive output columns and works
// out their column taps once; it then walks UP_RPT consecutive rows (a
// warp's threads share their rows, so the row taps are a broadcast),
// stepping the row phase by increments instead of a division, and reloads
// its 16 input values only where the row pair changes (once per f/2 rows
// at f >= 2 away from the edges). Each run of 4 goes out as one 16-byte
// streaming store (__stcs: the output is ten times the L2), or as 4 scalar
// ones where ow % 4 != 0. The reads, 1/f^2 of the writes, are served by L1
// and L2. So each output costs about 3 FMAs and a quarter of a store.
#include "common.cuh"

namespace r2f {

constexpr int UP_MAX_F = 64;
constexpr int UP_RUN = 4;     // output columns per thread
constexpr int UP_BX = 32;     // blockDim.x: a warp's threads share their rows
constexpr int UP_BY = 8;      // blockDim.y
constexpr int UP_RPT = 8;     // K13's consecutive output rows per thread
constexpr int ROWS_RPT = 4;   // K12's consecutive output rows per thread
constexpr int BOX_RUN = 2;    // K10's 16-byte path: consecutive outputs per thread

// The x f lerp's phases: output o = q f + m reads input q + base[m] with
// weight w0[m] and q + base[m] + 1 with w1[m] (before the edge clamp).
struct Phases {
  int f;
  int base[UP_MAX_F];
  float w0[UP_MAX_F];
  float w1[UP_MAX_F];
};
static_assert(sizeof(Phases) == 4 + 12 * UP_MAX_F, "Phases: the layout ops/pyramid.py packs");

}  // namespace r2f

namespace {

using r2f::BOX_RUN;
using r2f::Phases;
using r2f::UP_BX;
using r2f::UP_BY;
using r2f::UP_MAX_F;
using r2f::UP_RPT;
using r2f::UP_RUN;
using r2f::ROWS_RPT;


__global__ void box_downsample_kernel(const float* __restrict__ img,
                                      float* __restrict__ out, int H, int W,
                                      int h2, int w2, int f, float inv) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= w2 || y >= h2) return;
  const float* src = img + static_cast<size_t>(c) * H * W +
                     static_cast<size_t>(y) * f * W + static_cast<size_t>(x) * f;
  float total = 0.0f;
  for (int j = 0; j < f; ++j) {
    float col = src[j];
    for (int i = 1; i < f; ++i) col += src[static_cast<size_t>(i) * W + j];
    total = j == 0 ? col : total + col;
  }
  out[(static_cast<size_t>(c) * h2 + y) * w2 + x] = total * inv;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// K10's 16-byte path at f = 4 G (G = 1: the render, G = 2: the /8 level).
// A warp (one output row, blockDim.x = 32) makes 32 * BOX_RUN consecutive
// outputs and reads each input row of them as one run of 16-byte slots,
// lane l taking slots l + 32 k: every warp load is 512 contiguous bytes.
// Slot s holds columns 4 (s % G) .. + 3 of output s / G; at G = 2 lane 2m
// adds lane 2m + 1's four column sums after its own.
template <int G>
__global__ void __launch_bounds__(256)
    box_downsample_slots_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
                                int W, int h2, int w2, float inv) {
  constexpr int F = 4 * G;
  constexpr int KS = BOX_RUN * G;  // slots per lane and input row
  const int lane = threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (y >= h2) return;  // the whole warp: it is one output row
  const int xb = blockIdx.x * (32 * BOX_RUN);
  const float* src = img + static_cast<size_t>(c) * H * W + static_cast<size_t>(y) * F * W +
                     static_cast<size_t>(xb) * F;
  float4 col[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int s = lane + 32 * k;
    col[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (xb + s / G < w2) {
      const float* p = src + 4 * s;
      col[k] = __ldg(reinterpret_cast<const float4*>(p));
#pragma unroll
      for (int i = 1; i < F; ++i)
        add4(col[k], __ldg(reinterpret_cast<const float4*>(p + static_cast<size_t>(i) * W)));
    }
  }
  float* dst = out + (static_cast<size_t>(c) * h2 + y) * w2 + xb;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int s = lane + 32 * k;
    float total = col[k].x;
    total += col[k].y;
    total += col[k].z;
    total += col[k].w;
#pragma unroll
    for (int g = 1; g < G; ++g) {
      const float a = __shfl_down_sync(0xffffffffu, col[k].x, g);
      const float b = __shfl_down_sync(0xffffffffu, col[k].y, g);
      const float d = __shfl_down_sync(0xffffffffu, col[k].z, g);
      const float e = __shfl_down_sync(0xffffffffu, col[k].w, g);
      total += a;
      total += b;
      total += d;
      total += e;
    }
    if (s % G == 0 && xb + s / G < w2) dst[s / G] = total * inv;
  }
}

// UP_RUN consecutive values of a row: one 16-byte load (VEC), or the first
// n of them one by one, the rest 0.
template <bool VEC>
__device__ __forceinline__ void load_run(const float* p, int n, float* v) {
  if (VEC) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < UP_RUN; ++k) v[k] = k < n ? __ldg(p + k) : 0.0f;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(UP_BX * UP_BY)
    upsample_rows_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w,
                         int oh, const __grid_constant__ Phases p) {
  const int x0 = static_cast<int>(blockIdx.x * UP_BX + threadIdx.x) * UP_RUN;
  const int y0 = static_cast<int>(blockIdx.y * UP_BY + threadIdx.y) * ROWS_RPT;
  if (x0 >= w || y0 >= oh) return;
  const int c = blockIdx.z;
  const int n = min(UP_RUN, w - x0);
  const float* src = img + static_cast<size_t>(c) * h * w + x0;
  float* dst = out + static_cast<size_t>(c) * oh * w + x0;
  const int y_end = min(oh, y0 + ROWS_RPT);
  int q = y0 / p.f;
  int m = y0 - q * p.f;
  int pr0 = -1, pr1 = -1;
  float a[UP_RUN], b[UP_RUN];  // input rows r0 and r1
  for (int y = y0; y < y_end; ++y) {
    const int base = q + p.base[m];
    const int r0 = min(max(base, 0), h - 1);
    const int r1 = min(max(base + 1, 0), h - 1);
    float w0 = p.w0[m];
    float w1 = p.w1[m];
    if (r0 == r1) {
      w0 = w0 + w1;
      w1 = 0.0f;
    }
    if (r0 != pr0 || r1 != pr1) {
      if (r0 == pr1) {
#pragma unroll
        for (int k = 0; k < UP_RUN; ++k) a[k] = b[k];
      } else {
        load_run<VEC>(src + static_cast<size_t>(r0) * w, n, a);
      }
      load_run<VEC>(src + static_cast<size_t>(r1) * w, n, b);
      pr0 = r0;
      pr1 = r1;
    }
    float v[UP_RUN];
#pragma unroll
    for (int k = 0; k < UP_RUN; ++k) v[k] = __fmaf_rn(w1, b[k], __fmul_rn(w0, a[k]));
    float* o = dst + static_cast<size_t>(y) * w;
    if (VEC) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < UP_RUN; ++k)
        if (k < n) o[k] = v[k];
    }
    if (++m == p.f) {
      m = 0;
      ++q;
    }
  }
}

// Taps of output o on a length-n input axis, clamped and folded.
__device__ __forceinline__ void phase_taps(const Phases& p, int o, int n, int& i0, int& i1,
                                           float& w0, float& w1) {
  const int q = o / p.f;
  const int m = o - q * p.f;
  const int b = q + p.base[m];
  i0 = min(max(b, 0), n - 1);
  i1 = min(max(b + 1, 0), n - 1);
  w0 = p.w0[m];
  w1 = p.w1[m];
  if (i0 == i1) {
    w0 = w0 + w1;
    w1 = 0.0f;
  }
}

__global__ void __launch_bounds__(UP_BX * UP_BY)
    upsample_kernel(const float* __restrict__ img, float* __restrict__ out, int h, int w,
                    int oh, int ow, const __grid_constant__ Phases p) {
  const int x0 = static_cast<int>(blockIdx.x * UP_BX + threadIdx.x) * UP_RUN;
  const int y0 = static_cast<int>(blockIdx.y * UP_BY + threadIdx.y) * UP_RPT;
  if (x0 >= ow || y0 >= oh) return;
  const int c = blockIdx.z;
  int c0[UP_RUN], c1[UP_RUN];
  float wc0[UP_RUN], wc1[UP_RUN];
#pragma unroll
  for (int k = 0; k < UP_RUN; ++k)
    phase_taps(p, min(x0 + k, ow - 1), w, c0[k], c1[k], wc0[k], wc1[k]);
  const float* src = img + static_cast<size_t>(c) * h * w;
  float* dst = out + static_cast<size_t>(c) * oh * ow + x0;
  const bool vec = (ow & 3) == 0;
  const int y_end = min(oh, y0 + UP_RPT);
  int q = y0 / p.f;
  int m = y0 - q * p.f;
  int pr0 = -1, pr1 = -1;
  float a0[UP_RUN], a1[UP_RUN], b0[UP_RUN], b1[UP_RUN];  // rows r0, r1 at columns c0, c1
  for (int y = y0; y < y_end; ++y) {
    const int b = q + p.base[m];
    const int r0 = min(max(b, 0), h - 1);
    const int r1 = min(max(b + 1, 0), h - 1);
    float wr0 = p.w0[m];
    float wr1 = p.w1[m];
    if (r0 == r1) {
      wr0 = wr0 + wr1;
      wr1 = 0.0f;
    }
    if (r0 != pr0 || r1 != pr1) {
      const float* ra = src + static_cast<size_t>(r0) * w;
      const float* rb = src + static_cast<size_t>(r1) * w;
#pragma unroll
      for (int k = 0; k < UP_RUN; ++k) {
        a0[k] = ra[c0[k]];
        a1[k] = ra[c1[k]];
        b0[k] = rb[c0[k]];
        b1[k] = rb[c1[k]];
      }
      pr0 = r0;
      pr1 = r1;
    }
    float v[UP_RUN];
#pragma unroll
    for (int k = 0; k < UP_RUN; ++k) {
      const float t0 = wr0 * a0[k] + wr1 * b0[k];
      const float t1 = wr0 * a1[k] + wr1 * b1[k];
      v[k] = wc0[k] * t0 + wc1[k] * t1;
    }
    float* o = dst + static_cast<size_t>(y) * ow;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int k = 0; k < UP_RUN; ++k)
        if (x0 + k < ow) __stcs(o + k, v[k]);
    }
    if (++m == p.f) {
      m = 0;
      ++q;
    }
  }
}

}  // namespace

// img: (C, h, w) float32; out: (C, oh, ow) float32, oh <= h f, ow <= w f,
// allocated whole (16-byte aligned rows when ow % 4 == 0); phases: the
// host-built table for f.
R2F_API int r2f_upsample(const float* img, float* out, int C, int h, int w, int oh, int ow,
                         const Phases* phases, void* stream) {
  const int f = phases->f;
  if (f < 1 || f > UP_MAX_F || oh < 1 || ow < 1 || oh > h * f || ow > w * f ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(UP_BX, UP_BY);
  const dim3 grid((ow + UP_BX * UP_RUN - 1) / (UP_BX * UP_RUN),
                  (oh + UP_BY * UP_RPT - 1) / (UP_BY * UP_RPT), C);
  upsample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(img, out, h, w, oh, ow,
                                                                         *phases);
  return static_cast<int>(cudaGetLastError());
}

// img: (C, H, W) float32; out: (C, H/f, W/f) float32; inv = float32(1/f^2).
// vec: the 16-byte path, which takes f = 4 or 8, W % 4 == 0 and a 16-byte
// aligned img; 0: one thread per output, any shape.
R2F_API int r2f_box_downsample(const float* img, float* out, int C, int H, int W,
                               int f, float inv, int vec, void* stream) {
  if (f < 1 || (vec && ((f != 4 && f != 8) || W % 4 != 0 ||
                        (reinterpret_cast<uintptr_t>(img) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int h2 = H / f;
  const int w2 = W / f;
  const dim3 block(32, 8);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const dim3 grid((w2 + 32 * BOX_RUN - 1) / (32 * BOX_RUN), (h2 + 7) / 8, C);
    if (f == 4)
      box_downsample_slots_kernel<1><<<grid, block, 0, s>>>(img, out, H, W, h2, w2, inv);
    else
      box_downsample_slots_kernel<2><<<grid, block, 0, s>>>(img, out, H, W, h2, w2, inv);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((w2 + 31) / 32, (h2 + 7) / 8, C);
  box_downsample_kernel<<<grid, block, 0, s>>>(img, out, H, W, h2, w2, f, inv);
  return static_cast<int>(cudaGetLastError());
}

// img: (C, h, w) float32; out: (C, oh, w) float32, oh <= h f; phases: the
// host-built table for f. vec: the 16-byte path, which takes w % 4 == 0 and
// a 16-byte aligned img and out; 0: scalar loads and stores, any shape.
R2F_API int r2f_upsample_rows(const float* img, float* out, int C, int h, int w, int oh,
                              const Phases* phases, int vec, void* stream) {
  const int f = phases->f;
  if (f < 1 || f > UP_MAX_F || oh < 1 || w < 1 || oh > h * f ||
      (vec && (w % 4 != 0 || (reinterpret_cast<uintptr_t>(img) & 15) != 0 ||
               (reinterpret_cast<uintptr_t>(out) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(UP_BX, UP_BY);
  const dim3 grid((w + UP_BX * UP_RUN - 1) / (UP_BX * UP_RUN),
                  (oh + UP_BY * ROWS_RPT - 1) / (UP_BY * ROWS_RPT), C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    upsample_rows_kernel<true><<<grid, block, 0, s>>>(img, out, h, w, oh, *phases);
  else
    upsample_rows_kernel<false><<<grid, block, 0, s>>>(img, out, h, w, oh, *phases);
  return static_cast<int>(cudaGetLastError());
}
