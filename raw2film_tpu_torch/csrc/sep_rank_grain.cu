// K2: sum of separable rank-1 convolutions, with an optional film-grain
// epilogue; on the shapes the TPU's K2 declines it also stands for K4.
//
// Replaces raw2film_tpu/ops/pallas_conv2.py::fused_sep_rank_mxu (the TPU
// kernel _fused_rank_mxu_kernel) and its grain epilogue,
// raw2film_tpu/ops/pallas_grain.py::grain_field_block and
// grain_amplitude_block, and pallas_conv2.py::fused_sep_rank (K4). On the
// main path it is the per-channel MTF (3 channels x 4 ranks x 23 taps at
// 45 MP) followed by grain, and the burn's small-map blur (1 x 49 x 74).
//
//   out[c] = sum_r colconv(u[c,r]) o rowconv(v[c,r]) (img[c]),  reflect-101
//   grain:   out = max(out + amp(out) * field, 0)
//   field(y, x) = sum_qx t[qx] sum_qy t[qy] n(y + qy, x + qx)
//   n = (popc(a) + popc(b) - 32) / 4, (a, b) = PCG-3D(x, y + row_off,
//                                                      c * 0x9E3779B9 + seed)
//
// Bound on the H100: arithmetic and shared-memory traffic at 45 MP, not
// device memory: each output takes about 4 x (23 + 23) = 184 FMAs (plus
// the halo columns of the column pass) against 8 bytes of device traffic.
// On small frames (K4: 3 x 540 x 360, 2 ranks x 3 taps) the device work is
// a few microseconds and the launch path is what costs.
//
// Design: one block per (channel, 32-row x 64-column tile) runs the rank
// stage of sep_rank.cuh (shared with K14): the reflect-101 window staged in
// shared memory once, per rank a column pass then a row pass, the ranks
// summed in registers (8 outputs per thread). Ranks that are all zero (the
// padding of a per-channel stack) are skipped. The taps travel by value in
// the launch's parameters (r2f::sep::Ranks, __grid_constant__), so a launch
// copies nothing to the device: the wrapper packs the struct once per
// distinct stack and caches it, and a small stack launches with a struct
// cut to SMALL_TAPS (launch cost grows with parameter bytes). A stack above
// Ranks' capacity is read from a device buffer the wrapper uploads once
// per stack. The grain epilogue (grain.cuh, shared with K8 and K9)
// regenerates its noise window from the hash, so no block reads a
// neighbour's data. Taps stay float32: the TPU's bf16 "dc" tap rescale is
// an artifact of its matrix unit and is not carried over.
#include "grain.cuh"
#include "sep_rank.cuh"

namespace {

using r2f::sep::NT;
using r2f::sep::RPT;
using r2f::sep::TH;
using r2f::sep::TW;
using r2f::sep::TY;

// kByValue: the taps are rk.taps; otherwise dtaps, in the same layout.
template <int CAP, bool kByValue>
__global__ void __launch_bounds__(NT)
    sep_rank_kernel(const float* __restrict__ img, float* __restrict__ out,
                    const float* __restrict__ dtaps, int has_grain,
                    const float* __restrict__ prm,
                    const __grid_constant__ r2f::sep::RanksOf<CAP> rk,
                    const __grid_constant__ r2f::grain::Args g) {
  extern __shared__ float smem[];
  const int H = rk.H;
  const int W = rk.W;
  const int c = blockIdx.z;
  const int cb = rk.per_channel ? c : 0;
  const int KV = rk.KV;
  const int KH = rk.KH;
  const int EW = r2f::sep::win_w(KH);
  const int WH = r2f::sep::win_h(KV);
  float* win = smem;  // WH * EW, later the grain noise window
  float* tmp = win + (has_grain ? max(WH * EW, r2f::grain::win_h(TH, g.ntaps) *
                                                    r2f::grain::win_w(TW, g.ntaps))
                                : WH * EW);  // TH * EW column-pass rows

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;

  r2f::sep::stage_window(img + c * plane, H, W, y0, x0, KV, KH, win);
  const float* tap = (kByValue ? rk.taps : dtaps) + cb * rk.R * (KV + KH);
  float acc[RPT];
  r2f::sep::rank_sum(tap, win, tmp, rk.nrank[cb], KV, KH, acc);

  const int x = x0 + threadIdx.x;
  if (has_grain) {
    r2f::grain::column_field(win, tmp, x0, y0, TH, TW, r2f::grain_z(c, g.seed), g, tid, NT);
    const r2f::grain::Amp p = r2f::grain::load_amp(prm);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const float field = r2f::grain::row_field(tmp, threadIdx.y + TY * k, threadIdx.x, TW, g);
      const float d = acc[k];
      acc[k] = fmaxf(d + p.rms_eff * r2f::grain::shape(d, p) * field, 0.0f);
    }
  }

  if (x >= W) return;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int y = y0 + threadIdx.y + TY * k;
    if (y < H) out[c * plane + static_cast<size_t>(y) * W + x] = acc[k];
  }
}

template <int CAP, bool kByValue>
int launch(const float* img, float* out, const r2f::sep::RanksOf<CAP>& rk, const float* dtaps,
           int has_grain, const float* prm, const r2f::grain::Args& g, cudaStream_t stream) {
  const int EW = r2f::sep::win_w(rk.KH);
  const int WH = r2f::sep::win_h(rk.KV);
  int region = WH * EW;
  if (has_grain) {
    const int gwin = r2f::grain::win_h(TH, g.ntaps) * r2f::grain::win_w(TW, g.ntaps);
    region = region > gwin ? region : gwin;
  }
  const int gw = r2f::grain::win_w(TW, g.ntaps);
  const int tmp_w = has_grain && gw > EW ? gw : EW;
  const size_t smem = sizeof(float) * (static_cast<size_t>(region) + TH * tmp_w);
  const int e = r2f::sep::smem_opt_in(sep_rank_kernel<CAP, kByValue>, smem);
  if (e != 0) return e;
  const dim3 block(TW, TY);
  const dim3 grid((rk.W + TW - 1) / TW, (rk.H + TH - 1) / TH, rk.C);
  sep_rank_kernel<CAP, kByValue><<<grid, block, smem, stream>>>(img, out, dtaps, has_grain, prm,
                                                                rk, g);
  return static_cast<int>(cudaGetLastError());
}

// The header of rk in the small struct (its taps left for the caller).
r2f::sep::RanksOf<r2f::sep::SMALL_TAPS> small_header(const r2f::sep::Ranks& rk) {
  r2f::sep::RanksOf<r2f::sep::SMALL_TAPS> small{};
  small.C = rk.C;
  small.H = rk.H;
  small.W = rk.W;
  for (int i = 0; i < r2f::sep::MAX_C; ++i) small.nrank[i] = rk.nrank[i];
  small.per_channel = rk.per_channel;
  small.R = rk.R;
  small.KV = rk.KV;
  small.KH = rk.KH;
  return small;
}

}  // namespace

// img, out: (C, H, W) float32, the shape in ranks: the host-packed launch
// (sep_rank.cuh). dtaps: null to read its taps, or a device copy of the
// same (Cb, R, KV + KH) float32 layout for a stack above MAX_TAPS. grain:
// null, or the host-built seed pair and correlation taps (ntaps <= 31) with
// prm, 6 device floats [rms_eff, floor, peak_half, inv_width, lo,
// inv_rng].
R2F_API int r2f_sep_rank(const float* img, float* out, const r2f::sep::Ranks* ranks,
                         const float* dtaps, const r2f::grain::Args* grain, const float* prm,
                         void* stream) {
  const r2f::sep::Ranks& rk = *ranks;
  const int cb = rk.per_channel ? rk.C : 1;
  if (rk.C < 1 || rk.H < 1 || rk.W < 1 || rk.R < 1 || rk.KV < 1 || rk.KH < 1 ||
      rk.KV % 2 == 0 || rk.KH % 2 == 0 || cb > r2f::sep::MAX_C ||
      (dtaps == nullptr && cb * rk.R * (rk.KV + rk.KH) > r2f::sep::MAX_TAPS) ||
      (grain != nullptr && (grain->ntaps < 1 || grain->ntaps > r2f::grain::MAX_TAPS ||
                            prm == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < cb; ++i)
    if (rk.nrank[i] < 0 || rk.nrank[i] > rk.R) return static_cast<int>(cudaErrorInvalidValue);
  r2f::grain::Args g{};
  if (grain != nullptr) {
    g = *grain;
  } else {
    g.ntaps = 1;
    g.taps[0] = 1.0f;
  }
  const int has_grain = grain != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtaps != nullptr)
    return launch<r2f::sep::SMALL_TAPS, false>(img, out, small_header(rk), dtaps, has_grain, prm,
                                                 g, s);
  const int n = cb * rk.R * (rk.KV + rk.KH);
  if (n > r2f::sep::SMALL_TAPS)
    return launch<r2f::sep::MAX_TAPS, true>(img, out, rk, dtaps, has_grain, prm, g, s);
  r2f::sep::RanksOf<r2f::sep::SMALL_TAPS> small = small_header(rk);
  for (int i = 0; i < n; ++i) small.taps[i] = rk.taps[i];
  return launch<r2f::sep::SMALL_TAPS, true>(img, out, small, dtaps, has_grain, prm, g, s);
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
