// K2's rank stage (sep_rank_grain.cu, also K4's): one block per (channel,
// TH x TW tile) sums separable rank-1 convolutions
// with reflect-101 borders,
//
//   acc = sum_r colconv(u[r]) o rowconv(v[r]) (plane)   over the tile,
//
// and hands the sum to its kernel's epilogue in registers.
//
// The block stages the reflect-101 window (tile + kernel halo) in shared
// memory once; per rank it runs the column pass into a shared buffer, then
// the row pass, and accumulates the ranks in registers (RPT outputs per
// thread: rows threadIdx.y + TY * k of column threadIdx.x). Any tap length
// and rank count serve without a rebuild. The taps are read through a
// pointer, and at every step all threads of the block read the same tap,
// so the read is a broadcast wherever the taps live: the kernel's
// parameter bank (a Ranks struct passed by value) or, for a stack above
// its capacity, a cached device buffer. The window's centre, win[(rv + ty)
// * EW + rw + tx], is the input pixel of output (ty, tx) and stays readable
// after the rank sum. K14 (halation.cu) has a rank stage of its own and
// takes WindowWalk and smem_opt_in from here.
#pragma once

#include "common.cuh"

namespace r2f {
namespace sep {

constexpr int TW = 64;   // tile width  (blockDim.x)
constexpr int TY = 4;    // blockDim.y
constexpr int RPT = 8;   // rows per thread
constexpr int TH = TY * RPT;
constexpr int NT = TW * TY;

// K2's launch, passed by value as a __grid_constant__ kernel parameter: the
// (C, H, W) image shape and the rank stack, taps (Cb, R, KV + KH), column
// taps then row taps per rank, Cb = C (per_channel) or 1 (shared);
// nrank[cb] ranks run per channel (a per-channel stack's trailing all-zero
// ranks are skipped). The host packs it once per stack and shape, so a
// launch passes one pointer for all of it. MAX_TAPS covers
// every stack the port sends at the Processor's 400 px/mm cap: the largest
// is the per-channel MTF there, 3 x 4 ranks x (41 + 41) = 984 floats, then
// the SVD halation tier (7-8 ranks x 41 taps, at most 656), the /4 small
// blur (3 ragged ranks padded to 73 taps, 438) and the 45 MP MTF (552).
// The struct (8236 bytes) is above the classic 4 KB parameter limit, so K2
// relies on the 32,764 bytes that CUDA 12.1 and later allow on Volta and
// newer. A larger stack goes through a cached device buffer
// (ops/sep_rank.py) with the same layout. A launch's cost grows with its
// parameter bytes (on the H100: 4.6 us of host time with 44 bytes, 10.7
// with this struct; scripts/k4_wrapper_cost.py), so a stack of at most
// SMALL_TAPS floats (every K4 stack of the preview: the MTF at 15 px/mm,
// 36 floats; the burn Gaussian, 26; the glow's dense tier, 20) launches
// with a copy cut to that size.
constexpr int MAX_C = 4;
constexpr int MAX_TAPS = 2048;
constexpr int SMALL_TAPS = 64;
template <int CAP>
struct RanksOf {
  int C, H, W;
  int nrank[MAX_C];
  int per_channel;
  int R, KV, KH;
  float taps[CAP];
};
using Ranks = RanksOf<MAX_TAPS>;
static_assert(sizeof(Ranks) == 44 + 4 * MAX_TAPS, "Ranks: the layout ops/sep_rank.py packs");

// Window width and height of a tile for KV column and KH row taps.
__host__ __device__ __forceinline__ int win_w(int KH) { return TW + 2 * (KH / 2); }
__host__ __device__ __forceinline__ int win_h(int KV) { return TH + 2 * (KV / 2); }

// Row and column (y, x) of flat index i = y * ew + x as i advances by nt,
// kept by increments: a runtime division per element costs more than the
// arithmetic of a 3-tap rank.
struct WindowWalk {
  int y, x, dy, dx, ew;
  __device__ __forceinline__ WindowWalk(int i, int nt, int ew_)
      : y(i / ew_), x(i % ew_), dy(nt / ew_), dx(nt % ew_), ew(ew_) {}
  __device__ __forceinline__ void next() {
    y += dy;
    x += dx;
    if (x >= ew) {
      x -= ew;
      ++y;
    }
  }
};

// Stage the reflect-101 window of the tile at (y0, x0) of one H x W plane.
// Ends with __syncthreads().
__device__ __forceinline__ void stage_window(const float* __restrict__ src, int H, int W,
                                             int y0, int x0, int KV, int KH, float* win) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int rv = KV / 2;
  const int rw = KH / 2;
  const int EW = win_w(KH);
  const int WH = win_h(KV);
  WindowWalk walk(tid, NT, EW);
  for (int i = tid; i < WH * EW; i += NT, walk.next()) {
    const int gy = reflect101(y0 + walk.y - rv, H);
    const int gx = reflect101(x0 + walk.x - rw, W);
    win[i] = src[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();
}

// acc[k] = sum over ranks 0..nr-1 of the tile's output (threadIdx.y + TY*k,
// threadIdx.x). tap holds per rank KV column taps then KH row taps (shared,
// global or parameter memory); tmp is TH * win_w(KH) floats of shared
// memory. Ends with __syncthreads() after the last rank.
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
    WindowWalk walk(tid, NT, EW);
    for (int i = tid; i < TH * EW; i += NT, walk.next()) {
      const float* col = win + walk.y * EW + walk.x;
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
