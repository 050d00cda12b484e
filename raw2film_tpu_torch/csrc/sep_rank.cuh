// K2's rank stage (sep_rank_grain.cu, also K4's): one block per (channel,
// TH x TW tile) sums separable rank-1 convolutions with reflect-101
// borders,
//
//   acc = sum_r colconv(u[r]) o rowconv(v[r]) (plane)   over the tile,
//
// and hands the sum to its kernel's epilogue in registers.
//
// Register runs, as in K14 (halation.cu): the block stages the reflect-101
// window once, transposed (column-major, odd stride, so both its staging
// and the column pass are conflict-free); per rank the column pass gives
// each thread NC consecutive rows of one window column (consecutive
// addresses, compile-time offsets) and writes a transposed buffer, then the
// row pass gives each thread NR consecutive columns of one row (the lanes
// of a warp on the tile's 32 rows, so the transposed reads are
// conflict-free), summing the ranks straight into its NR accumulators.
//
// Runtime tap lengths in compile-time chunks: every rank's taps run in
// chunks of CK. The host (ops/sep_rank.py::pack) zero-pads each rank about
// its centre to a multiple of CK (the +0 terms are exact) and gives it its
// own chunk counts and window offsets from its true length, so a stack of
// ragged ranks runs each at its own length. A run's window values slide
// through a register ring from chunk to chunk (Run), so a chunk loads its
// CK new values for NC x CK FMAs, each value feeding up to NC FMAs; within
// a chunk the taps and the ring are indexed at compile time. A first
// version reloaded all NC + CK - 1 values every chunk, each behind an
// address computation: 2.77 ms for the 45 MP MTF + grain against 2.49 with
// the ring and the transposed window (scripts/port_times.py, NVIDIA H100
// 80GB HBM3 at 700 W). The taps are read at a uniform offset from
// the kernel's parameter bank (a Ranks struct passed by value) or, for a
// stack above its capacity, from a cached device buffer. K14 has a rank
// stage of its own (one kernel per tap length) and takes WindowWalk and
// smem_opt_in from here.
#pragma once

#include "common.cuh"

namespace r2f {
namespace sep {

constexpr int TW = 128;     // tile width
constexpr int TH = 32;      // tile height: a warp's lanes in the row pass
constexpr int NT = 256;     // threads per block
constexpr int NC = 16;      // column pass: consecutive rows per thread
constexpr int NR = 16;      // row pass: consecutive columns per thread
constexpr int TS = TH + 4;  // stride of the transposed column-pass buffer
constexpr int BS = TH + 1;  // stride of the sums' buffer of the epilogue
constexpr int CK = 8;       // taps per chunk
static_assert(NT / 32 * NR == TW && TH == 32 && TH % NC == 0 && NC % 4 == 0,
              "tile and thread layout");
static_assert(TW * BS <= TW * TS, "the sums' buffer fits the column-pass buffer");

// K2's launch, passed by value as a __grid_constant__ kernel parameter: the
// (C, H, W) image shape and the rank stack, packed once per stack and shape
// by ops/sep_rank.py::pack, so a launch passes one pointer for all of it.
// Rank r of channel cb has nv column chunks starting at window row ov and
// nh row chunks starting at window column oh (relative to the tile's
// output (0, 0)); its taps are nv * CK column taps then nh * CK row taps,
// the ranks one after another, `stride` floats per channel (Cb = C when
// per_channel, else 1). The window reaches `top` rows above the tile and
// `left` columns left of it, EH x EW in all. nrank[cb] ranks run per
// channel (a per-channel stack's trailing all-zero ranks are skipped).
// MAX_TAPS covers every stack the port sends at the Processor's 400 px/mm
// cap: the largest is the per-channel MTF there, 3 x 4 ranks x (48 + 48)
// padded taps = 1152 floats, then the SVD halation tier (8 ranks x 96, 768)
// and the /4 small blur (3 ragged ranks of at most 80 + 80, 480). The
// struct (8504 bytes) is above the classic 4 KB parameter limit, so K2
// relies on the 32,764 bytes that CUDA 12.1 and later allow on Volta and
// newer. A larger stack goes through a cached device buffer with the same
// layout. A launch's cost grows with its parameter bytes (on the H100: 4.6
// us of host time with 44 bytes, 10.7 with 8236; scripts/k4_wrapper_cost.py),
// so a stack of at most SMALL_TAPS floats (every K4 stack of the preview:
// the MTF at 15 px/mm, 96 padded floats; the burn Gaussian, 32; the glow's
// dense tier, 32) launches with a copy cut to that size.
constexpr int MAX_C = 4;
constexpr int MAX_R = 16;
constexpr int MAX_TAPS = 2048;
constexpr int SMALL_TAPS = 128;
struct Rank {
  int nv, ov, nh, oh;
};
template <int CAP>
struct RanksOf {
  int C, H, W;
  int per_channel, R, stride;
  int top, left, EH, EW;
  int nrank[MAX_C];
  Rank rank[MAX_R];
  float taps[CAP];
};
using Ranks = RanksOf<MAX_TAPS>;
static_assert(sizeof(Ranks) == 312 + 4 * MAX_TAPS, "Ranks: the layout ops/sep_rank.py packs");

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

// Odd stride of a transposed window of n rows (conflict-free when the
// lanes of a warp read or write consecutive columns).
__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

// Stage the eh x ew reflect-101 window whose (0, 0) is plane position
// (y0 - top, x0 - left), transposed: win[x * odd(eh) + y]. Warps on rows,
// lanes on columns, with cp.async. Ends with __syncthreads().
__device__ __forceinline__ void stage(const float* __restrict__ src, int H, int W, int y0, int x0,
                                      int top, int left, int eh, int ew, float* win) {
  const int es = odd(eh);
  for (int lx = threadIdx.x & 31; lx < ew; lx += 32) {
    const float* col = src + reflect101(x0 + lx - left, W);
    float* dst = win + lx * es;
    for (int ly = threadIdx.x >> 5; ly < eh; ly += NT / 32)
      cp_async4(dst + ly, col + static_cast<size_t>(reflect101(y0 + ly - top, H)) * W);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// A run of NO outputs o[j] += sum_{q < n K} t[q] src[(j + q) LD] in n
// chunks of K taps. The sources slide through a register ring of RING
// slots (source row r in slot r % RING), so each chunk loads only its K new
// rows; the chunk loop is unrolled by the ring's U chunks to keep every
// slot a compile-time index.
template <int K, int NO>
struct Run {
  static constexpr int U = (NO + 2 * K - 2) / K;  // chunks per turn of the ring
  static constexpr int RING = U * K;             // >= NO + K - 1 slots
};

// Chunk M (mod U) of a run, src and t at the chunk's first source row and
// tap: its K new rows (NO - 1 .. NO + K - 2 from there) into the ring, then
// its NO x K FMAs.
template <int K, int NO, int LD, int M>
__device__ __forceinline__ void run_chunk(const float* __restrict__ src, const float* t,
                                          float (&ring)[Run<K, NO>::RING], float (&o)[NO]) {
  constexpr int R = Run<K, NO>::RING;
#pragma unroll
  for (int i = 0; i < K; ++i) ring[(M * K + NO - 1 + i) % R] = src[(NO - 1 + i) * LD];
  float tq[K];
#pragma unroll
  for (int q = 0; q < K; ++q) tq[q] = t[q];
#pragma unroll
  for (int k = 0; k < NO + K - 1; ++k) {
    const float val = ring[(M * K + k) % R];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int q = k - j;
      if (q >= 0 && q < K) o[j] = fmaf(tq[q], val, o[j]);
    }
  }
}

// Chunks M .. U - 1 of one turn of the ring; true when the run is done.
template <int K, int NO, int LD, int M>
__device__ __forceinline__ bool run_turn(const float*& src, const float*& t, int& c, int n,
                                         float (&ring)[Run<K, NO>::RING], float (&o)[NO]) {
  run_chunk<K, NO, LD, M>(src, t, ring, o);
  src += K * LD;
  t += K;
  if (++c == n) return true;
  if constexpr (M + 1 < Run<K, NO>::U) {
    return run_turn<K, NO, LD, M + 1>(src, t, c, n, ring, o);
  } else {
    return false;
  }
}

// o[j] += sum_{q < n K} t[q] src[(j + q) LD] for j < NO, n >= 1.
template <int K, int NO, int LD>
__device__ __forceinline__ void run(const float* src, const float* t, int n, float (&o)[NO]) {
  float ring[Run<K, NO>::RING];
#pragma unroll
  for (int i = 0; i < NO - 1; ++i) ring[i] = src[i * LD];
  int c = 0;
  while (!run_turn<K, NO, LD, 0>(src, t, c, n, ring, o)) {
  }
}

// tmp[x * TS + y] = sum_{q < n K} t[q] src[x * es + y + q] for the tile's
// TH rows y and the columns x < ncol of src, a transposed window of column
// stride es: item (run, x) is rows run * NC .. run * NC + NC - 1.
template <int K>
__device__ __forceinline__ void column_pass(const float* __restrict__ src, int es, int ncol,
                                            const float* t, int n, float* __restrict__ tmp) {
  WindowWalk walk(threadIdx.x, NT, ncol);  // walk.y: the run, walk.x: the column
  for (int i = threadIdx.x; i < (TH / NC) * ncol; i += NT, walk.next()) {
    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.0f;
    run<K, NC, 1>(src + walk.x * es + walk.y * NC, t, n, s);
    float4* dst = reinterpret_cast<float4*>(tmp + walk.x * TS + walk.y * NC);
#pragma unroll
    for (int j = 0; j < NC / 4; ++j)
      dst[j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  }
}

// acc[j] += sum_{q < n K} t[q] tmp[(c0 + j + q) * TS + y]: row y = lane,
// columns c0 = warp * NR onwards.
template <int K>
__device__ __forceinline__ void row_pass(const float* __restrict__ tmp, const float* t, int n,
                                         float (&acc)[NR]) {
  run<K, NR, TS>(tmp + (threadIdx.x >> 5) * NR * TS + (threadIdx.x & 31), t, n, acc);
}

// acc[j] = the rank sum of the tile's output (lane, warp * NR + j) of the
// window staged in win; tap: this channel's taps; tmp: the column-pass
// buffer. FIX: 0, or the chunk count of every rank's column and row taps
// known at compile time (the chunk loops then unroll completely). Ends
// with __syncthreads() after the last rank.
template <int FIX, int CAP>
__device__ __forceinline__ void rank_sum(const RanksOf<CAP>& rk, int nr, const float* tap,
                                         const float* win, float* tmp, float (&acc)[NR]) {
#pragma unroll
  for (int j = 0; j < NR; ++j) acc[j] = 0.0f;
  const int es = odd(rk.EH);
  for (int r = 0; r < nr; ++r) {
    const Rank g = rk.rank[r];
    const int nv = FIX ? FIX : g.nv;
    const int nh = FIX ? FIX : g.nh;
    column_pass<CK>(win + g.oh * es + g.ov, es, TW + nh * CK - 1, tap, nv, tmp);
    __syncthreads();
    row_pass<CK>(tmp, tap + nv * CK, nh, acc);
    __syncthreads();
    tap += (nv + nh) * CK;
  }
}

// Whether every rank of rk runs n column chunks and n row chunks.
template <int CAP>
__host__ bool all_chunks(const RanksOf<CAP>& rk, int n) {
  for (int r = 0; r < rk.R; ++r)
    if (rk.rank[r].nv != n || rk.rank[r].nh != n) return false;
  return true;
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
