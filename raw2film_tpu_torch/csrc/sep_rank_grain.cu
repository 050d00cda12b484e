// K2: sum of separable rank-1 convolutions, with an optional film-grain
// epilogue; on the shapes the TPU's K2 declines it also stands for K4.
//
// Replaces raw2film_tpu/ops/pallas_conv2.py::fused_sep_rank_mxu (the TPU
// kernel _fused_rank_mxu_kernel) and its grain epilogue,
// raw2film_tpu/ops/pallas_grain.py::grain_field_block and
// grain_amplitude_block, and pallas_conv2.py::fused_sep_rank (K4). On the
// main path it is the per-channel MTF (3 channels x 4 ranks x 23 taps at
// 45 MP) followed by grain, the halation's /4 small blur (two shared ranks
// of 15 and 27 taps on 3 x 1368 x 2052), and the burn's small-map blur
// (1 x 49 x 74).
//
//   out[c] = sum_r colconv(u[c,r]) o rowconv(v[c,r]) (img[c]),  reflect-101
//   grain:   out = max(out + amp(out) * field, 0)
//   field(y, x) = sum_qx t[qx] sum_qy t[qy] n(y + qy, x + qx)
//   n = (popc(a) + popc(b) - 32) / 4, (a, b) = PCG-3D(x, y + row_off,
//                                                      c * 0x9E3779B9 + seed)
//
// Bound on the H100: fp32 FMAs at 45 MP, not device memory: each output
// takes 4 x (23 + 23) = 184 FMAs of ranks and about 30 FLOPs of grain
// against 8 bytes of device traffic (0.788 ms at 67 TFLOP/s). On small
// frames (K4: 3 x 540 x 360, 2 ranks x 3 taps) the device work is a few
// microseconds and the launch path is what costs.
//
// Design: one block per (channel, 32 x 128 tile), 256 threads, the rank
// stage of sep_rank.cuh: the reflect-101 window staged once, transposed,
// with cp.async; per rank a column pass (runs of 16 rows of one window
// column per thread) into a transposed buffer and a row pass (runs of 16
// columns of one row) into 16 accumulators per thread, every rank in
// chunks of 8 taps at its own padded length (23 taps run 24; the small
// blur's ranks 16 and 32), a chunk loading its 8 new window values for 128
// FMAs. The design it replaces computed one output per FMA step with its
// window value and its tap both read from shared memory, two loads per FMA:
// 7.39 ms device at 45 MP against 2.02 now (NVIDIA H100 80GB HBM3, 700 W;
// scripts/port_times.py), bound by instruction issue (the rank loop is 82 %
// FFMA, scripts/sass_mix.py). Ranks that are all zero (the padding of a
// per-channel stack) are skipped. The taps travel by value in the launch's
// parameters (r2f::sep::Ranks, __grid_constant__), so a launch copies
// nothing to the device: the wrapper packs the struct once per distinct
// stack and caches it, and a small stack launches with a struct cut to
// SMALL_TAPS (launch cost grows with parameter bytes). A stack above
// Ranks' capacity is read from a device buffer the wrapper uploads once per
// stack. The grain epilogue regenerates its noise window from the hash
// (grain.cuh, shared with K7-K9), so no block reads a neighbour's data, and
// runs its two correlation passes through the same register runs in chunks
// of 4 taps; its amplitude's exponential is on the SFU. The sums leave
// through shared memory so the stores are coalesced. Taps stay float32:
// the TPU's bf16 "dc" tap rescale is an artifact of its matrix unit and is
// not carried over.
#include <cstddef>
#include <cstring>

#include "grain.cuh"
#include "sep_rank.cuh"

namespace {

using r2f::sep::BS;
using r2f::sep::CK;
using r2f::sep::NR;
using r2f::sep::NT;
using r2f::sep::TH;
using r2f::sep::TS;
using r2f::sep::TW;

constexpr int CKG = 4;          // grain correlation taps per chunk
// Stacks above SMALL_TAPS whose every rank runs this many chunks (true
// lengths 17-23: the MTF at 45 MP) take a kernel with the count compiled
// in, the chunk loops unrolled: 2.02 ms on the 45 MP MTF + grain against
// 2.39 on the runtime loop (scripts/k2_variants.py, NVIDIA H100 80GB HBM3,
// 700 W).
constexpr int FIXED_CHUNKS = 3;
constexpr int GRAIN_TAPS = 32;  // r2f::grain::MAX_TAPS rounded up to CKG
static_assert(GRAIN_TAPS % CKG == 0 && GRAIN_TAPS >= r2f::grain::MAX_TAPS, "grain taps");

// The grain epilogue's launch, by value: the seed pair and n chunks of CKG
// correlation taps, zero-padded.
struct GrainTaps {
  uint32_t seed, row_off;
  int n;
  float taps[GRAIN_TAPS];
};

// Floats of the window region (the staged window, later the grain's noise
// window, both transposed; a multiple of 4 so the buffer after it is
// 16-byte aligned) and of the column-pass buffer, for grain chunks gn (0:
// no grain).
__host__ __device__ __forceinline__ int region_floats(int eh, int ew, int gn) {
  const int w = ew * r2f::sep::odd(eh);
  const int g = gn ? (TW + gn * CKG - 1) * r2f::sep::odd(TH + gn * CKG - 1) : 0;
  return ((w > g ? w : g) + 3) & ~3;
}
__host__ __device__ __forceinline__ int tmp_floats(int ew, int gn) {
  const int gw = gn ? TW + gn * CKG - 1 : 0;
  return (ew > gw ? ew : gw) * TS;
}

// kByValue: the taps are rk.taps; otherwise dtaps, in the same layout.
// FIX: 0, or every rank's chunk count (sep_rank.cuh::rank_sum). With FIX,
// four blocks per SM (at most 64 registers a thread; 55 KB of shared memory
// each for the 45 MP MTF): 5 % faster than three on the MTF + grain
// (scripts/k2_variants.py). The runtime-chunk kernels keep three: at 64
// registers they spill.
template <int CAP, bool kByValue, bool kGrain, int FIX>
__global__ void __launch_bounds__(NT, FIX ? 4 : 3)
    sep_rank_kernel(const float* __restrict__ img, float* __restrict__ out,
                    const float* __restrict__ dtaps, const float* __restrict__ prm,
                    const __grid_constant__ r2f::sep::RanksOf<CAP> rk,
                    const __grid_constant__ GrainTaps g) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  float* tmp = win + region_floats(rk.EH, rk.EW, kGrain ? g.n : 0);
  const int H = rk.H;
  const int W = rk.W;
  const int c = blockIdx.z;
  const int cb = rk.per_channel ? c : 0;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;

  r2f::sep::stage(img + c * plane, H, W, y0, x0, rk.top, rk.left, rk.EH, rk.EW, win);
  float acc[NR];
  r2f::sep::rank_sum<FIX>(rk, rk.nrank[cb], (kByValue ? rk.taps : dtaps) + cb * rk.stride, win,
                          tmp, acc);

  if constexpr (kGrain) {
    const int gh = TH + g.n * CKG - 1;
    const int gw = TW + g.n * CKG - 1;
    const int ges = r2f::sep::odd(gh);
    r2f::grain::noise_window(win, gh, gw, x0, y0, r2f::grain_z(c, g.seed), g.row_off,
                             threadIdx.x, NT, 1, ges);
    __syncthreads();
    r2f::sep::column_pass<CKG>(win, ges, gw, g.taps, g.n, tmp);
    __syncthreads();
    float field[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) field[j] = 0.0f;
    r2f::sep::row_pass<CKG>(tmp, g.taps, g.n, field);
    const r2f::grain::Amp p = r2f::grain::load_amp(prm);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const float d = acc[j];
      acc[j] = fmaxf(d + p.rms_eff * r2f::grain::shape_sfu(d, p) * field[j], 0.0f);
    }
    __syncthreads();
  }

  // the sums to a layout with lanes on consecutive columns, for coalesced
  // stores
  {
    float* sums = tmp + (threadIdx.x >> 5) * NR * BS + (threadIdx.x & 31);
#pragma unroll
    for (int j = 0; j < NR; ++j) sums[j * BS] = acc[j];
  }
  __syncthreads();
  const int nx = min(TW, W - x0);
  const int n = min(TH, H - y0) * TW;
  float* o = out + c * plane + static_cast<size_t>(y0) * W + x0;
  r2f::sep::WindowWalk walk(threadIdx.x, NT, TW);  // walk.y: the row, walk.x: the column
  for (int i = threadIdx.x; i < n; i += NT, walk.next())
    if (walk.x < nx) o[static_cast<size_t>(walk.y) * W + walk.x] = tmp[walk.x * BS + walk.y];
}

template <int CAP, bool kByValue, bool kGrain, int FIX>
int launch(const float* img, float* out, const r2f::sep::RanksOf<CAP>& rk, const float* dtaps,
           const float* prm, const GrainTaps& g, cudaStream_t stream) {
  const int gn = kGrain ? g.n : 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(region_floats(rk.EH, rk.EW, gn)) +
                                       tmp_floats(rk.EW, gn));
  const auto kernel = sep_rank_kernel<CAP, kByValue, kGrain, FIX>;
  const int e = r2f::sep::smem_opt_in(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((rk.W + TW - 1) / TW, (rk.H + TH - 1) / TH, rk.C);
  kernel<<<grid, NT, smem, stream>>>(img, out, dtaps, prm, rk, g);
  return static_cast<int>(cudaGetLastError());
}

// The runtime-chunk kernel, or with FIX the one whose every rank runs FIX
// chunks when the stack's do.
template <int CAP, bool kByValue, int FIX = 0>
int dispatch(const float* img, float* out, const r2f::sep::RanksOf<CAP>& rk, const float* dtaps,
             const float* prm, const GrainTaps* g, cudaStream_t stream) {
  if (FIX != 0 && !r2f::sep::all_chunks(rk, FIX))
    return dispatch<CAP, kByValue, 0>(img, out, rk, dtaps, prm, g, stream);
  if (g != nullptr) return launch<CAP, kByValue, true, FIX>(img, out, rk, dtaps, prm, *g, stream);
  return launch<CAP, kByValue, false, FIX>(img, out, rk, dtaps, prm, GrainTaps{}, stream);
}

// rk with its taps cut to SMALL_TAPS floats (all of them when by_value).
r2f::sep::RanksOf<r2f::sep::SMALL_TAPS> small_copy(const r2f::sep::Ranks& rk, bool by_value) {
  r2f::sep::RanksOf<r2f::sep::SMALL_TAPS> small{};
  static_assert(offsetof(r2f::sep::RanksOf<r2f::sep::SMALL_TAPS>, taps) ==
                    offsetof(r2f::sep::Ranks, taps),
                "one header");
  std::memcpy(&small, &rk, offsetof(r2f::sep::Ranks, taps));
  if (by_value)
    std::memcpy(small.taps, rk.taps, sizeof(float) * (rk.per_channel ? rk.C : 1) * rk.stride);
  return small;
}

// Whether the packed launch is one the kernel can run: every rank's chunks
// inside the window, the taps' layout as long as its ranks.
bool valid(const r2f::sep::Ranks& rk, bool by_value) {
  const int cb = rk.per_channel ? rk.C : 1;
  if (rk.C < 1 || rk.H < 1 || rk.W < 1 || rk.R < 1 || rk.R > r2f::sep::MAX_R ||
      (rk.per_channel != 0 && rk.per_channel != 1) || cb > r2f::sep::MAX_C || rk.stride < 1 ||
      (by_value && cb * rk.stride > r2f::sep::MAX_TAPS))
    return false;
  int n = 0;
  for (int r = 0; r < rk.R; ++r) {
    const r2f::sep::Rank& g = rk.rank[r];
    if (g.nv < 1 || g.nh < 1 || g.ov < 0 || g.oh < 0 || g.ov + TH + g.nv * CK - 1 > rk.EH ||
        g.oh + TW + g.nh * CK - 1 > rk.EW)
      return false;
    n += (g.nv + g.nh) * CK;
  }
  for (int i = 0; i < cb; ++i)
    if (rk.nrank[i] < 0 || rk.nrank[i] > rk.R) return false;
  return n == rk.stride;
}

}  // namespace

// img, out: (C, H, W) float32, the shape in ranks: the host-packed launch
// (sep_rank.cuh). dtaps: null to read its taps, or a device copy of the
// same (Cb, stride) float32 layout for a stack above MAX_TAPS. grain:
// null, or the host-built seed pair and correlation taps (ntaps <= 31) with
// prm, 6 device floats [rms_eff, floor, peak_half, inv_width, lo,
// inv_rng].
R2F_API int r2f_sep_rank(const float* img, float* out, const r2f::sep::Ranks* ranks,
                         const float* dtaps, const r2f::grain::Args* grain, const float* prm,
                         void* stream) {
  const r2f::sep::Ranks& rk = *ranks;
  if (!valid(rk, dtaps == nullptr) ||
      (grain != nullptr && (grain->ntaps < 1 || grain->ntaps > r2f::grain::MAX_TAPS ||
                            prm == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  GrainTaps gt{};
  if (grain != nullptr) {
    gt.seed = grain->seed;
    gt.row_off = grain->row_off;
    gt.n = (grain->ntaps + CKG - 1) / CKG;
    for (int i = 0; i < grain->ntaps; ++i) gt.taps[i] = grain->taps[i];
  }
  const GrainTaps* g = grain != nullptr ? &gt : nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtaps != nullptr)
    return dispatch<r2f::sep::SMALL_TAPS, false>(img, out, small_copy(rk, false), dtaps, prm, g, s);
  if ((rk.per_channel ? rk.C : 1) * rk.stride > r2f::sep::SMALL_TAPS)
    return dispatch<r2f::sep::MAX_TAPS, true, FIXED_CHUNKS>(img, out, rk, dtaps, prm, g, s);
  return dispatch<r2f::sep::SMALL_TAPS, true>(img, out, small_copy(rk, true), dtaps, prm, g, s);
}

// Test hook for the grain hash: the two PCG-3D words of every position of an
// (h, w) grid at origin (x0, y0), channel salt ch, as the K2 epilogue
// computes them. a, b: (h, w) uint32 (stored as int32).
namespace {
__global__ void hash_words_kernel(uint32_t* a, uint32_t* b, int h, int w,
                                  int x0, int y0, int ch, uint32_t seed,
                                  uint32_t row_off) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  uint32_t wa, wb;
  r2f::pcg3d(static_cast<uint32_t>(x0 + x), static_cast<uint32_t>(y0 + y) + row_off,
             r2f::grain_z(ch, seed), wa, wb);
  a[static_cast<size_t>(y) * w + x] = wa;
  b[static_cast<size_t>(y) * w + x] = wb;
}
}  // namespace

R2F_API int r2f_hash_words(void* a, void* b, int h, int w, int x0, int y0,
                           int ch, unsigned int seed, unsigned int row_off,
                           void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  hash_words_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(a), static_cast<uint32_t*>(b), h, w, x0, y0, ch,
      seed, row_off);
  return static_cast<int>(cudaGetLastError());
}
