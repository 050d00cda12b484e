// The rank stage shared by K2 (sep_rank_grain.cu) and K14 (halation.cu):
// one block per (channel, TH x TW tile) sums separable rank-1 convolutions
// with reflect-101 borders,
//
//   acc = sum_r colconv(u[r]) o rowconv(v[r]) (plane)   over the tile,
//
// and hands the sum to its kernel's epilogue in registers.
//
// The block stages the reflect-101 window (tile + kernel halo) in shared
// memory once; per rank it runs the column pass into a shared buffer, then
// the row pass, and accumulates the ranks in registers (RPT outputs per
// thread: rows threadIdx.y + TY * k of column threadIdx.x). Taps come from
// a small device buffer, so any tap length and rank count serve without a
// rebuild. The window's centre, win[(rv + ty) * EW + rw + tx], is the input
// pixel of output (ty, tx) and stays readable after the rank sum.
#pragma once

#include "common.cuh"

namespace r2f {
namespace sep {

constexpr int TW = 64;   // tile width  (blockDim.x)
constexpr int TY = 4;    // blockDim.y
constexpr int RPT = 8;   // rows per thread
constexpr int TH = TY * RPT;
constexpr int NT = TW * TY;

// Window width and height of a tile for KV column and KH row taps.
__host__ __device__ __forceinline__ int win_w(int KH) { return TW + 2 * (KH / 2); }
__host__ __device__ __forceinline__ int win_h(int KV) { return TH + 2 * (KV / 2); }

// Copy n taps to shared memory and stage the reflect-101 window of the tile
// at (y0, x0) of one H x W plane. Ends with __syncthreads().
__device__ __forceinline__ void stage(const float* __restrict__ src, int H, int W,
                                      int y0, int x0, int KV, int KH,
                                      const float* __restrict__ taps, int n,
                                      float* tap, float* win) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int rv = KV / 2;
  const int rw = KH / 2;
  const int EW = win_w(KH);
  const int WH = win_h(KV);
  for (int i = tid; i < n; i += NT) tap[i] = taps[i];
  for (int i = tid; i < WH * EW; i += NT) {
    const int wy = i / EW;
    const int wx = i % EW;
    const int gy = reflect101(y0 + wy - rv, H);
    const int gx = reflect101(x0 + wx - rw, W);
    win[i] = src[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();
}

// acc[k] = sum over ranks 0..nr-1 of the tile's output (threadIdx.y + TY*k,
// threadIdx.x). tap holds per rank KV column taps then KH row taps; tmp is
// TH * win_w(KH) floats. Ends with __syncthreads() after the last rank.
__device__ __forceinline__ void rank_sum(const float* tap, const float* win,
                                         float* tmp, int nr, int KV, int KH,
                                         float (&acc)[RPT]) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int EW = win_w(KH);
  const int tk = KV + KH;
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k] = 0.0f;
  for (int r = 0; r < nr; ++r) {
    const float* u = tap + r * tk;
    const float* v = u + KV;
    for (int i = tid; i < TH * EW; i += NT) {
      const int ty = i / EW;
      const int tx = i % EW;
      const float* col = win + ty * EW + tx;
      float s = u[0] * col[0];
      for (int q = 1; q < KV; ++q) s += u[q] * col[q * EW];
      tmp[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const float* row = tmp + (threadIdx.y + TY * k) * EW + threadIdx.x;
      float s = v[0] * row[0];
      for (int q = 1; q < KH; ++q) s += v[q] * row[q];
      acc[k] += s;
    }
    __syncthreads();
  }
}

// Opt the kernel in to more than 48 KB of dynamic shared memory when it
// needs it; returns a cudaError_t as int.
template <typename Kernel>
__host__ int smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace sep
}  // namespace r2f
