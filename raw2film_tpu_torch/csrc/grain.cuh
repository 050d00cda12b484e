// The film-grain device code shared by K2's epilogue (sep_rank_grain.cu) and
// the grain field and applies K7, K8 and K9 (grain.cu):
//
//   field(y, x) = sum_qx t[qx] sum_qy t[qy] n(y + qy, x + qx)
//   n = (popc(a) + popc(b) - 32) / 4, (a, b) = PCG-3D(x, y + row_off, z)
//   shape(d) = floor + (1 - floor) exp(-0.5 ((t - peak_half - 1/4) inv_width)^2),
//   t = (d - lo) inv_rng
//
// The window of output (y, x) starts at (y, x): it is not centred, as in
// raw2film_tpu/ops/pallas_grain.py::grain_field_block. A tile regenerates
// its own halo from the hash, so no block reads a neighbour's data.
#pragma once

#include "common.cuh"

namespace r2f {
namespace grain {

constexpr int MAX_TAPS = 31;

// Passed by value to the kernels: the seed pair and the correlation taps.
struct Args {
  uint32_t seed;
  uint32_t row_off;
  int ntaps;
  float taps[MAX_TAPS];
};

// The six amplitude floats [rms_eff, floor, peak_half, inv_width, lo,
// inv_rng], read once from device memory.
struct Amp {
  float rms_eff, floor_, peak_half, inv_width, lo, inv_rng;
};

__device__ __forceinline__ Amp load_amp(const float* __restrict__ prm) {
  return Amp{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]};
}

// The density-dependent shape of the amplitude (without rms_eff).
__device__ __forceinline__ float shape(float d, const Amp& p) {
  const float t = (d - p.lo) * p.inv_rng;
  const float e = (t - p.peak_half - 0.25f) * p.inv_width;
  return p.floor_ + (1.0f - p.floor_) * expe(-0.5f * (e * e));
}

// shape() with its exponential on the SFU (K2's epilogue): a relative error
// of about 2^-22 in a factor of the grain amplitude, which moves the output
// by about rms_eff |field| 2.4e-7.
__device__ __forceinline__ float shape_sfu(float d, const Amp& p) {
  const float t = (d - p.lo) * p.inv_rng;
  const float e = (t - p.peak_half - 0.25f) * p.inv_width;
  return p.floor_ + (1.0f - p.floor_) * ex2_sfu(-0.5f * LOG2_E * (e * e));
}

// Width and height of the noise window of a th x tw tile.
__host__ __device__ __forceinline__ int win_w(int tw, int ntaps) { return tw + ntaps - 1; }
__host__ __device__ __forceinline__ int win_h(int th, int ntaps) { return th + ntaps - 1; }

// Fill the gh x gw window at (x0, y0), salt z, with its noise, element
// (ly, lx) at win[ly * sy + lx * sx] (row-major: sy = gw, sx = 1;
// transposed: sy = 1, sx >= gh): warps on rows, lanes on columns, so no
// index is divided. tid / nthreads: this thread's rank in the block and the
// block size, a multiple of 32.
__device__ __forceinline__ void noise_window(float* win, int gh, int gw, int x0, int y0,
                                             uint32_t z, uint32_t row_off, int tid, int nthreads,
                                             int sy, int sx) {
  for (int ly = tid >> 5; ly < gh; ly += nthreads >> 5) {
    const uint32_t y = static_cast<uint32_t>(y0 + ly) + row_off;
    for (int lx = tid & 31; lx < gw; lx += 32) {
      uint32_t a, b;
      pcg3d(static_cast<uint32_t>(x0 + lx), y, z, a, b);
      win[ly * sy + lx * sx] = grain_normal(a, b);
    }
  }
}

// Fill win (win_h x win_w) with the noise of the tile at (x0, y0), salt z,
// then run the column pass into tmp (th x win_w). tid / nthreads: this
// thread's rank in the block and the block size. Ends with __syncthreads().
__device__ __forceinline__ void column_field(float* win, float* tmp, int x0, int y0,
                                             int th, int tw, uint32_t z, const Args& g,
                                             int tid, int nthreads) {
  const int nt = g.ntaps;
  const int gw = win_w(tw, nt);
  const int gh = win_h(th, nt);
  noise_window(win, gh, gw, x0, y0, z, g.row_off, tid, nthreads, gw, 1);
  __syncthreads();
  for (int i = tid; i < th * gw; i += nthreads) {
    const float* col = win + i;
    float s = g.taps[0] * col[0];
    for (int q = 1; q < nt; ++q) s += g.taps[q] * col[q * gw];
    tmp[i] = s;
  }
  __syncthreads();
}

// The row pass for output (row, col) of the tile, from column_field's tmp.
__device__ __forceinline__ float row_field(const float* tmp, int row, int col, int tw,
                                           const Args& g) {
  const int gw = win_w(tw, g.ntaps);
  const float* r = tmp + row * gw + col;
  float field = g.taps[0] * r[0];
  for (int q = 1; q < g.ntaps; ++q) field += g.taps[q] * r[q];
  return field;
}

// Copy n host taps into Args; returns cudaErrorInvalidValue as int when n is
// out of range.
__host__ inline int make_args(Args& g, unsigned int seed, unsigned int row_off,
                              const float* taps, int n) {
  if (n < 1 || n > MAX_TAPS) return static_cast<int>(cudaErrorInvalidValue);
  g.seed = seed;
  g.row_off = row_off;
  g.ntaps = n;
  for (int i = 0; i < n; ++i) g.taps[i] = taps[i];
  return 0;
}

}  // namespace grain
}  // namespace r2f
