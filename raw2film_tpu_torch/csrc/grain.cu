// K7, K8 and K9: the film-grain field alone, and film grain applied to a
// density image without the MTF.
//
// K7 grain_field replaces raw2film_tpu/ops/pallas_grain.py::grain_field_pallas
// (the correlated unit-variance field, C = 3 channels, or one for
// black-and-white grain, which the caller broadcasts):
//
//   out[c] = field_c,  z = c * 0x9E3779B9 + seed
//
// The TPU kernel's row0_offset on x is always 0 and is not carried over; the
// row offset rides on y, as in every other grain form.
//
// K8 grain_apply replaces raw2film_tpu/ops/pallas_grain.py::grain_apply_pallas
// (colour grain, one field per channel):
//
//   out[c] = max(d[c] + rms_eff * shape(d[c]) * field_c, 0),  z = c * 0x9E3779B9 + seed
//
// K9 grain_apply_bw replaces pallas_grain.py::grain_apply_bw_pallas (grain 1:
// one field shared by the three channels, the channel-mean amplitude):
//
//   g = rms_eff * (1/3) * (shape(d0) + shape(d1) + shape(d2)) * field,  z = seed
//   out[c] = max(d[c] + g, 0)
//
// field and shape are those of K2's grain epilogue (grain.cuh). The TPU pads
// H with edge rows to its tile; the hash depends only on position, so the
// padding changes nothing and these kernels serve every shape without it.
//
// Bound on the H100 (K7): device memory, 4 bytes written per output against
// about (1 + (n - 1) / 32) (1 + (n - 1) / 64) hashes and 2 n FMAs.
// Bound on the H100 (K8, K9): the hash and the correlation arithmetic, not
// device memory. Per output the block computes about (1 + (n - 1) / 32)
// (1 + (n - 1) / 64) hashes and 2 n FMAs of correlation (n = 3 taps at
// 45 MP) against 8 bytes of device traffic (K9: 24 bytes per pixel for
// three channels and one field).
//
// Design: one block per (channel, 32-row x 64-column tile) (K9: per tile, the
// three channels together): the noise window and its column pass in shared
// memory (grain.cuh), then 8 outputs per thread from the row pass.
#include "grain.cuh"

namespace {

constexpr int TW = 64;
constexpr int TY = 4;
constexpr int RPT = 8;
constexpr int TH = TY * RPT;
constexpr int NT = TW * TY;

__host__ __device__ __forceinline__ int smem_floats(int ntaps) {
  return r2f::grain::win_h(TH, ntaps) * r2f::grain::win_w(TW, ntaps) +
         TH * r2f::grain::win_w(TW, ntaps);
}

__global__ void __launch_bounds__(NT)
    grain_field_kernel(float* __restrict__ out, int H, int W, r2f::grain::Args g) {
  extern __shared__ float smem[];
  float* win = smem;
  float* tmp = smem + r2f::grain::win_h(TH, g.ntaps) * r2f::grain::win_w(TW, g.ntaps);
  const int c = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  r2f::grain::column_field(win, tmp, x0, y0, TH, TW, r2f::grain_z(c, g.seed), g, tid, NT);
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = threadIdx.y + TY * k;
    const int y = y0 + row;
    if (y >= H) break;
    out[c * plane + static_cast<size_t>(y) * W + x] =
        r2f::grain::row_field(tmp, row, threadIdx.x, TW, g);
  }
}

__global__ void __launch_bounds__(NT)
    grain_apply_kernel(const float* __restrict__ d, float* __restrict__ out, int H,
                       int W, const float* __restrict__ prm, r2f::grain::Args g) {
  extern __shared__ float smem[];
  float* win = smem;
  float* tmp = smem + r2f::grain::win_h(TH, g.ntaps) * r2f::grain::win_w(TW, g.ntaps);
  const int c = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  r2f::grain::column_field(win, tmp, x0, y0, TH, TW, r2f::grain_z(c, g.seed), g, tid, NT);
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const r2f::grain::Amp p = r2f::grain::load_amp(prm);
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = threadIdx.y + TY * k;
    const int y = y0 + row;
    if (y >= H) break;
    const size_t o = c * plane + static_cast<size_t>(y) * W + x;
    const float v = d[o];
    const float field = r2f::grain::row_field(tmp, row, threadIdx.x, TW, g);
    out[o] = fmaxf(v + p.rms_eff * r2f::grain::shape(v, p) * field, 0.0f);
  }
}

__global__ void __launch_bounds__(NT)
    grain_apply_bw_kernel(const float* __restrict__ d, float* __restrict__ out, int H,
                          int W, const float* __restrict__ prm, r2f::grain::Args g) {
  extern __shared__ float smem[];
  float* win = smem;
  float* tmp = smem + r2f::grain::win_h(TH, g.ntaps) * r2f::grain::win_w(TW, g.ntaps);
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  r2f::grain::column_field(win, tmp, x0, y0, TH, TW, r2f::grain_z(0, g.seed), g, tid, NT);
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const r2f::grain::Amp p = r2f::grain::load_amp(prm);
  const float third = 1.0f / 3.0f;
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = threadIdx.y + TY * k;
    const int y = y0 + row;
    if (y >= H) break;
    const size_t o = static_cast<size_t>(y) * W + x;
    const float d0 = d[o], d1 = d[plane + o], d2 = d[2 * plane + o];
    const float field = r2f::grain::row_field(tmp, row, threadIdx.x, TW, g);
    const float amp = p.rms_eff * third *
                      (r2f::grain::shape(d0, p) + r2f::grain::shape(d1, p) +
                       r2f::grain::shape(d2, p));
    const float gv = amp * field;
    out[o] = fmaxf(d0 + gv, 0.0f);
    out[plane + o] = fmaxf(d1 + gv, 0.0f);
    out[2 * plane + o] = fmaxf(d2 + gv, 0.0f);
  }
}

}  // namespace

// d, out: (C, H, W) float32 (bw: C = 3). prm: 6 device floats [rms_eff,
// floor, peak_half, inv_width, lo, inv_rng]; taps: n host floats (n <= 31).
R2F_API int r2f_grain_apply(const float* d, float* out, int C, int H, int W, int bw,
                            unsigned int seed, unsigned int row_off, const float* prm,
                            const float* taps, int n, void* stream) {
  r2f::grain::Args g{};
  const int e = r2f::grain::make_args(g, seed, row_off, taps, n);
  if (e != 0) return e;
  if (bw && C != 3) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(n));
  const dim3 block(TW, TY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, bw ? 1 : C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bw) {
    grain_apply_bw_kernel<<<grid, block, smem, s>>>(d, out, H, W, prm, g);
  } else {
    grain_apply_kernel<<<grid, block, smem, s>>>(d, out, H, W, prm, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: (C, H, W) float32, channel c salted with c * 0x9E3779B9 (C = 1 for
// black-and-white grain); taps: n host floats (n <= 31).
R2F_API int r2f_grain_field(float* out, int C, int H, int W, unsigned int seed,
                            unsigned int row_off, const float* taps, int n, void* stream) {
  r2f::grain::Args g{};
  const int e = r2f::grain::make_args(g, seed, row_off, taps, n);
  if (e != 0) return e;
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(n));
  const dim3 block(TW, TY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  grain_field_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(out, H, W, g);
  return static_cast<int>(cudaGetLastError());
}
