// K2: sum of separable rank-1 convolutions, with an optional film-grain
// epilogue.
//
// Replaces raw2film_tpu/ops/pallas_conv2.py::fused_sep_rank_mxu (the TPU
// kernel _fused_rank_mxu_kernel) and its grain epilogue,
// raw2film_tpu/ops/pallas_grain.py::grain_field_block and
// grain_amplitude_block. On the main path it is the per-channel MTF
// (3 channels x 4 ranks x 23 taps at 45 MP) followed by grain.
//
//   out[c] = sum_r colconv(u[c,r]) o rowconv(v[c,r]) (img[c]),  reflect-101
//   grain:   out = max(out + amp(out) * field, 0)
//   field(y, x) = sum_qx t[qx] sum_qy t[qy] n(y + qy, x + qx)
//   n = (popc(a) + popc(b) - 32) / 4, (a, b) = PCG-3D(x, y + row_off,
//                                                      c * 0x9E3779B9 + seed)
//
// Bound on the H100: arithmetic and shared-memory traffic, not device
// memory. At 45 MP each output takes about 4 x (23 + 23) = 184 FMAs (plus
// the halo columns of the column pass) against 8 bytes of device traffic.
//
// Design: one block per (channel, 32-row x 64-column tile) runs the rank
// stage of sep_rank.cuh (shared with K14): the reflect-101 window staged in
// shared memory once, per rank a column pass then a row pass, the ranks
// summed in registers (8 outputs per thread). Ranks that are all zero (the
// padding of a per-channel stack) are skipped. The grain epilogue
// (grain.cuh, shared with K8 and K9) regenerates its noise window from the
// hash, so no block reads a neighbour's data. Taps stay float32: the TPU's
// bf16 "dc" tap rescale is an artifact of its matrix unit and is not
// carried over.
#include "grain.cuh"
#include "sep_rank.cuh"

namespace {

using r2f::sep::NT;
using r2f::sep::RPT;
using r2f::sep::TH;
using r2f::sep::TW;
using r2f::sep::TY;

__global__ void __launch_bounds__(NT)
    sep_rank_kernel(const float* __restrict__ img, float* __restrict__ out,
                    int H, int W, const float* __restrict__ taps,
                    const int* __restrict__ nrank, int per_channel, int R,
                    int KV, int KH, int has_grain,
                    const float* __restrict__ prm, r2f::grain::Args g) {
  extern __shared__ float smem[];
  const int c = blockIdx.z;
  const int cb = per_channel ? c : 0;
  const int EW = r2f::sep::win_w(KH);
  const int WH = r2f::sep::win_h(KV);
  const int tk = KV + KH;
  float* tap = smem;               // R * (KV + KH)
  float* win = smem + R * tk;      // WH * EW, later the grain noise window
  float* tmp = win + (has_grain ? max(WH * EW, r2f::grain::win_h(TH, g.ntaps) *
                                                    r2f::grain::win_w(TW, g.ntaps))
                                : WH * EW);  // TH * EW column-pass rows

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;

  r2f::sep::stage(img + c * plane, H, W, y0, x0, KV, KH, taps + cb * R * tk, R * tk,
                  tap, win);
  float acc[RPT];
  r2f::sep::rank_sum(tap, win, tmp, nrank[cb], KV, KH, acc);

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

}  // namespace

// img, out: (C, H, W) float32. taps: (Cb, R, KV + KH) float32 on the device,
// column taps then row taps per rank; nrank: (Cb,) int32, the ranks to run
// per channel; Cb is C (per_channel=1) or 1. prm: 6 device floats
// [rms_eff, floor, peak_half, inv_width, lo, inv_rng] and grain_taps
// (host, n_grain_taps <= 31) when has_grain.
R2F_API int r2f_sep_rank(const float* img, float* out, int C, int H, int W,
                         const float* taps, const int* nrank, int per_channel,
                         int R, int KV, int KH, int has_grain,
                         unsigned int seed, unsigned int row_off,
                         const float* prm, const float* grain_taps,
                         int n_grain_taps, void* stream) {
  r2f::grain::Args g{};
  const float one = 1.0f;
  const int e_args = has_grain ? r2f::grain::make_args(g, seed, row_off, grain_taps, n_grain_taps)
                               : r2f::grain::make_args(g, 0u, 0u, &one, 1);
  if (e_args != 0) return e_args;

  const int EW = r2f::sep::win_w(KH);
  const int WH = r2f::sep::win_h(KV);
  int region = WH * EW;
  if (has_grain) {
    const int gwin = r2f::grain::win_h(TH, g.ntaps) * r2f::grain::win_w(TW, g.ntaps);
    region = region > gwin ? region : gwin;
  }
  const int gw = r2f::grain::win_w(TW, g.ntaps);
  const int tmp_w = has_grain && gw > EW ? gw : EW;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(R) * (KV + KH) + region + TH * tmp_w);
  const int e = r2f::sep::smem_opt_in(sep_rank_kernel, smem);
  if (e != 0) return e;
  const dim3 block(TW, TY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  sep_rank_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, taps, nrank, per_channel, R, KV, KH, has_grain, prm, g);
  return static_cast<int>(cudaGetLastError());
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
