// K14: the halation stage in one pass: full-res glow ranks, the x4 column
// lerp of the pyramid glow, the combine and, optionally, the development.
//
// Replaces raw2film_tpu/ops/pallas_halation.py::halation_mega. Per output
// pixel (y, x) of channel c:
//
//   ranks = sum_r colconv(u[r]) o rowconv(v[r]) (img[c])   reflect-101
//   up    = (1 - a) rows_up[c, y, j0] + a rows_up[c, y, j1]
//           x4 half-pixel lerp along W: x = 4k + m reads j0 = k + b_m and
//           j1 = j0 + 1, (b_m, a) = (-1, 0.625) (-1, 0.875) (0, 0.125)
//           (0, 0.375) for m = 0..3, both clamped to [0, W4 - 1]; where they
//           clamp onto one column its weight is the exact sum 1.0
//   out   = (img + f_c (ranks + up)) * inv_c,   inv_c = 1 / (1 + f_c)
//   with develop (identity masking): x = log10(max(out + flare, 1e-6)),
//   out = dmin_c + gamma_c (softplus(x - x_toe_c, w_toe_c)
//                           - softplus(x - x_sh_c, w_sh_c))
//
// develop is the f32[19] vector [flare, dmin*3, gamma*3, x_toe*3,
// x_shoulder*3, w_toe*3, w_shoulder*3]; it and the factors f32[3] are read
// from device memory, so slider values never rebuild anything. rows_up is
// the /4 pyramid blur already upsampled along H (K12), W4 = ceil(W / 4)
// wide, so a tile needs no neighbour rows of it.
//
// Bound on the H100: fp32 FMAs. At 45 MP (4 shared ranks x 27 taps) each
// output takes 4 x (27 + 27) = 216 FMAs of ranks against about 9 bytes of
// device traffic (img, out, a quarter of rows_up), and about 60 FLOPs of
// lerp, combine and development: 0.99 ms at 67 TFLOP/s.
//
// The design it replaces ran K2's rank stage (sep_rank.cuh::rank_sum): one
// output per FMA step, the window value and the tap both read from shared
// memory, two shared loads per FMA; it sat on the shared-load ceiling (9.9
// ms at 45 MP). This one keeps every shared-memory value in a register for
// many FMAs:
// - The stack comes by value (Stack, __grid_constant__), packed once per
//   stack and shape by ops/halation.py, so a launch copies nothing to the
//   device. The FMAs read their taps from the parameter bank (uniform
//   registers, one ULDC.64 per two taps).
// - The tap length K is a template argument: one kernel for each odd K from
//   K_MIN to K_MAX, every length that _full_res_ranks gives at the sizes
//   where K14 runs (25-49 taps, 40 < size <= 163); a shorter stack is
//   zero-padded on the host to K_MIN (exact +0 terms, never on the render).
//   The tap loops unroll completely, so the window slides through
//   registers indexed at compile time and each tap costs exactly one FMA
//   per output: no padding FMAs at any length the render uses.
// - One block per (channel, 32 x 128 tile), 256 threads. The reflect-101
//   window (32 + K - 1) x (128 + K - 1) is staged once with cp.async.
// - Column pass, per rank: a thread takes NC = 16 consecutive rows of one
//   window column (lanes on consecutive columns); each window value it
//   loads feeds up to 16 FMAs, one per output. The results go to a
//   transposed buffer (column-major, stride TS = 36: four 16-byte stores
//   per thread, conflict-free).
// - Row pass, per rank: a thread takes NR = 16 consecutive columns of one
//   row (a warp's lanes on the tile's 32 rows, so the transposed reads are
//   conflict-free); each loaded value feeds up to 16 FMAs, straight into
//   the thread's 16 accumulators.
// - So a shared load serves up to 16 FMAs in both passes, not half of one.
//   The column pass computes the 128 + K - 1 window columns (1.2x the
//   outputs at 27 taps; 1.41x with the old 64-wide tile).
// - Epilogue: the sums go through shared memory (stride 33) to a layout
//   with lanes on consecutive columns, so the rows_up reads and the output
//   stores are coalesced; the exposure is the window's centre, so the image
//   is read from device memory once.
// What bounds it now: instruction issue, not shared-memory loads. The FMAs
// of the ranks are about half of the instructions; the halo columns of the
// column pass, the shared loads, the epilogue and the staging are the
// rest. The 27-tap kernel uses 64 registers and no spills (`nvcc -Xptxas
// -v`; chip_smoke.py prints every K's), 3 blocks of 58 KB per SM. On an
// NVIDIA H100 80GB HBM3 at 700 W: 1.82 ms at 45 MP (profiler), against 9.6
// before; NC = 8 measured the same at 27 taps and 4 % slower at 43, and
// the development in base 2 took 11 % off.
// Unlike the TPU kernel, no tile size has to divide H or W: every shape is
// served, the window reflects at the borders and the stores are masked.
#include "sep_rank.cuh"

namespace r2f {
namespace hal {

constexpr int TW = 128;     // tile width
constexpr int TH = 32;      // tile height: a warp's lanes in the row pass
constexpr int NT = 256;     // threads per block
constexpr int NC = 16;      // column pass: consecutive rows per thread
constexpr int NR = 16;      // row pass: consecutive columns per thread
constexpr int TS = TH + 4;  // stride of the transposed column-pass buffer
constexpr int BS = TH + 1;  // stride of the sums' buffer for the epilogue
constexpr int K_MIN = 25;
constexpr int K_MAX = 49;
constexpr int MAX_TAPS = 512;  // 5 ranks x (49 + 49) = 490 at the most
static_assert(NT / 32 * NR == TW && TH == 32 && TH % NC == 0, "tile and thread layout");

// K14's launch, passed by value: the (C, H, W) image shape, W4 = ceil(W/4),
// and R shared ranks of K column taps then K row taps each.
struct Stack {
  int C, H, W, W4;
  int R, K;
  float taps[MAX_TAPS];
};
static_assert(sizeof(Stack) == 24 + 4 * MAX_TAPS, "Stack: the layout ops/halation.py packs");

__host__ __device__ constexpr int win_w(int K) { return TW + K - 1; }
__host__ __device__ constexpr int win_h(int K) { return TH + K - 1; }
// The window's floats, rounded up so the buffer after it is 16-byte aligned.
__host__ __device__ constexpr int win_floats(int K) { return (win_h(K) * win_w(K) + 3) & ~3; }
__host__ __device__ constexpr size_t smem_bytes(int K) {
  return sizeof(float) * (static_cast<size_t>(win_floats(K)) + static_cast<size_t>(win_w(K)) * TS);
}
static_assert(TW * BS <= TW * TS, "the sums' buffer reuses the column-pass buffer");

}  // namespace hal
}  // namespace r2f

namespace {

using r2f::hal::BS;
using r2f::hal::NC;
using r2f::hal::NR;
using r2f::hal::NT;
using r2f::hal::Stack;
using r2f::hal::TH;
using r2f::hal::TS;
using r2f::hal::TW;

// The development in base 2 on the SFU (common.cuh's lg2_sfu and
// softplus2, absolute error about 2^-22) instead of the 1-ulp library
// log2f: that one is a 28-instruction polynomial, and three per output were
// a third of the kernel's instructions. The per-channel factors are folded
// once per thread (fold_curve2). It moves the density by about 1e-7, far
// inside the plain version's tolerance (chip_smoke.py's
// TOL["halation_density"]).
using r2f::cp_async4;
using r2f::lg2_sfu;
using r2f::softplus2;

// Stage the reflect-101 window of the tile at (y0, x0): warps on rows,
// lanes on columns. Ends with __syncthreads().
template <int K>
__device__ __forceinline__ void stage(const float* __restrict__ src, int H, int W, int y0, int x0,
                                      float* win) {
  constexpr int EW = r2f::hal::win_w(K);
  constexpr int WH = r2f::hal::win_h(K);
  constexpr int XI = (EW + 31) / 32;
  constexpr int RAD = K / 2;
  const int lane = threadIdx.x & 31;
  int gx[XI];
#pragma unroll
  for (int k = 0; k < XI; ++k) gx[k] = r2f::reflect101(x0 + lane + 32 * k - RAD, W);
  for (int ly = threadIdx.x >> 5; ly < WH; ly += NT / 32) {
    const float* row = src + static_cast<size_t>(r2f::reflect101(y0 + ly - RAD, H)) * W;
    float* dst = win + ly * EW;
#pragma unroll
    for (int k = 0; k < XI; ++k) {
      const int lx = lane + 32 * k;
      if (lx < EW) cp_async4(dst + lx, row + gx[k]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// tmp[x * TS + y] = sum_q u[q] win[y + q][x] for the tile's TH rows and
// every window column x: item (run, x) is rows run*NC .. run*NC + NC - 1.
template <int K>
__device__ __forceinline__ void column_pass(const float* __restrict__ win, float* __restrict__ tmp,
                                            const float* u) {
  constexpr int EW = r2f::hal::win_w(K);
  float t[K];
#pragma unroll
  for (int q = 0; q < K; ++q) t[q] = u[q];
  r2f::sep::WindowWalk walk(threadIdx.x, NT, EW);  // walk.y: the run, walk.x: the column
  for (int i = threadIdx.x; i < (TH / NC) * EW; i += NT, walk.next()) {
    const float* col = win + walk.y * NC * EW + walk.x;
    float s[NC];
#pragma unroll
    for (int k = 0; k < NC + K - 1; ++k) {
      const float val = col[k * EW];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int q = k - j;
        if (q == 0) s[j] = t[0] * val;
        else if (q > 0 && q < K) s[j] += t[q] * val;
      }
    }
    float4* dst = reinterpret_cast<float4*>(tmp + walk.x * TS + walk.y * NC);
#pragma unroll
    for (int j = 0; j < NC / 4; ++j)
      dst[j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  }
}

// acc[j] += sum_q v[q] tmp[(c0 + j + q) * TS + y]: row y = lane, columns
// c0 = warp * NR onwards.
template <int K>
__device__ __forceinline__ void row_pass(const float* __restrict__ tmp, const float* v,
                                         float (&acc)[NR]) {
  float t[K];
#pragma unroll
  for (int q = 0; q < K; ++q) t[q] = v[q];
  const float* row = tmp + (threadIdx.x >> 5) * NR * TS + (threadIdx.x & 31);
#pragma unroll
  for (int k = 0; k < NR + K - 1; ++k) {
    const float val = row[k * TS];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int q = k - j;
      if (q >= 0 && q < K) acc[j] += t[q] * val;
    }
  }
}

template <int K, int MIN_BLOCKS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    halation_kernel(const float* __restrict__ img, const float* __restrict__ rows_up,
                    float* __restrict__ out, const float* __restrict__ fac,
                    const float* __restrict__ dev, const __grid_constant__ Stack st) {
  extern __shared__ float4 smem4[];
  constexpr int EW = r2f::hal::win_w(K);
  constexpr int RAD = K / 2;
  float* win = reinterpret_cast<float*>(smem4);
  float* tmp = win + r2f::hal::win_floats(K);
  const int c = blockIdx.z;
  const int H = st.H;
  const int W = st.W;
  const int W4 = st.W4;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;

  stage<K>(img + c * plane, H, W, y0, x0, win);
  float acc[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) acc[j] = 0.0f;
  for (int r = 0; r < st.R; ++r) {
    const float* u = st.taps + r * 2 * K;
    column_pass<K>(win, tmp, u);
    __syncthreads();
    row_pass<K>(tmp, u + K, acc);
    __syncthreads();
  }
  {
    float* sums = tmp + (threadIdx.x >> 5) * NR * BS + (threadIdx.x & 31);
#pragma unroll
    for (int j = 0; j < NR; ++j) sums[j * BS] = acc[j];
  }
  __syncthreads();

  const int lx = threadIdx.x & (TW - 1);
  const int x = x0 + lx;
  if (x >= W) return;
  const int m = x & 3;
  const int j = (x >> 2) - (m < 2 ? 1 : 0);
  const float a = m == 0 ? 0.625f : m == 1 ? 0.875f : m == 2 ? 0.125f : 0.375f;
  const int j0 = min(max(j, 0), W4 - 1);
  const int j1 = min(max(j + 1, 0), W4 - 1);
  float w0 = 1.0f - a;
  float w1 = a;
  if (j0 == j1) {
    w0 = w0 + w1;
    w1 = 0.0f;
  }

  const float f = fac[c];
  const float inv = 1.0f / (1.0f + f);
  // the development's per-channel factors (common.cuh's fold_curve2)
  float flare = 0.0f, dmin = 0.0f;
  r2f::Curve2 k{};
  if (dev != nullptr) {
    flare = dev[0];
    dmin = dev[1 + c];
    k = r2f::fold_curve2(dev, c);
  }

  // rows ly0, ly0 + STEP, ... of column lx, by pointer increments
  constexpr int STEP = NT / TW;
  const int ly0 = threadIdx.x / TW;
  const int ly_end = min(TH, H - y0);
  const float* ur = rows_up + (static_cast<size_t>(c) * H + y0 + ly0) * W4;
  float* o = out + c * plane + static_cast<size_t>(y0 + ly0) * W + x;
  const float* sums = tmp + lx * BS;
  const float* ex = win + RAD * EW + RAD + lx;
  for (int ly = ly0; ly < ly_end; ly += STEP, ur += STEP * W4, o += STEP * W) {
    const float up = ur[j0] * w0 + ur[j1] * w1;
    const float blur = sums[ly] + up;
    const float e = ex[ly * EW];
    float v = (e + f * blur) * inv;
    if (dev != nullptr) {
      const float l2 = lg2_sfu(fmaxf(v + flare, 1e-6f));
      v = dmin + k.g_t * softplus2(fmaf(l2, k.k1_t, k.k0_t)) - k.g_s * softplus2(fmaf(l2, k.k1_s, k.k0_s));
    }
    *o = v;
  }
}

template <int K>
int launch(const float* img, const float* rows_up, float* out, const Stack& st, const float* fac,
           const float* dev, cudaStream_t stream) {
  // three blocks per SM up to 33 taps (at most 80 registers a thread), two
  // above (the longer taps and the larger window)
  constexpr int MIN_BLOCKS = K <= 33 ? 3 : 2;
  const size_t smem = r2f::hal::smem_bytes(K);
  const int e = r2f::sep::smem_opt_in(halation_kernel<K, MIN_BLOCKS>, smem);
  if (e != 0) return e;
  const dim3 grid((st.W + TW - 1) / TW, (st.H + TH - 1) / TH, st.C);
  halation_kernel<K, MIN_BLOCKS><<<grid, NT, smem, stream>>>(img, rows_up, out, fac, dev, st);
  return static_cast<int>(cudaGetLastError());
}

// The kernel for tap length k, one of the odd lengths K_MIN..K_MAX.
template <int K>
int dispatch(int k, const float* img, const float* rows_up, float* out, const Stack& st,
             const float* fac, const float* dev, cudaStream_t stream) {
  if (k == K) return launch<K>(img, rows_up, out, st, fac, dev, stream);
  if constexpr (K + 2 <= r2f::hal::K_MAX) {
    return dispatch<K + 2>(k, img, rows_up, out, st, fac, dev, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// img, out: (C, H, W) float32; rows_up: (C, H, W4) float32, W4 = ceil(W/4);
// stack: the host-packed shape and shared ranks (ops/halation.py::pack),
// K odd in [K_MIN, K_MAX]. factors: C device floats; develop: 19 device
// floats, or null for the combined exposure.
R2F_API int r2f_halation(const float* img, const float* rows_up, float* out, const Stack* stack,
                         const float* factors, const float* develop, void* stream) {
  const Stack& st = *stack;
  if (st.C < 1 || st.H < 1 || st.W < 1 || st.W4 != (st.W + 3) / 4 || st.R < 1 ||
      st.K % 2 == 0 || st.K < r2f::hal::K_MIN || st.K > r2f::hal::K_MAX ||
      st.R * 2 * st.K > r2f::hal::MAX_TAPS || factors == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<r2f::hal::K_MIN>(st.K, img, rows_up, out, st, factors, develop,
                                   static_cast<cudaStream_t>(stream));
}
