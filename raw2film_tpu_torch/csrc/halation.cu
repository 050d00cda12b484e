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
// Bound on the H100: arithmetic and shared-memory traffic, as K2. At 45 MP
// each output takes 4 x (27 + 27) = 216 FMAs of ranks (plus the halo
// columns of the column pass) against 12 bytes of device traffic (img,
// out, a quarter of rows_up per lerp tap).
//
// Design: the rank stage is K2's (sep_rank.cuh): one block per (channel,
// 32 x 64 tile), the reflect-101 window in shared memory, the rank sum in
// registers. The epilogue reads the input pixel from the window's centre,
// so the exposure image is read from device memory once and the glow never
// reaches it. Unlike the TPU kernel, no tile size has to divide H or W:
// every shape is served.
#include "sep_rank.cuh"

namespace {

using r2f::sep::NT;
using r2f::sep::RPT;
using r2f::sep::TH;
using r2f::sep::TW;
using r2f::sep::TY;

__global__ void __launch_bounds__(NT)
    halation_kernel(const float* __restrict__ img, const float* __restrict__ rows_up,
                    float* __restrict__ out, int H, int W, int W4,
                    const float* __restrict__ taps, int R, int KV, int KH,
                    const float* __restrict__ fac, const float* __restrict__ dev) {
  extern __shared__ float smem[];
  const int c = blockIdx.z;
  const int EW = r2f::sep::win_w(KH);
  const int WH = r2f::sep::win_h(KV);
  const int tk = KV + KH;
  float* tap = smem;           // R * (KV + KH)
  float* win = tap + R * tk;   // WH * EW
  float* tmp = win + WH * EW;  // TH * EW column-pass rows

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;

  r2f::sep::stage(img + c * plane, H, W, y0, x0, KV, KH, taps, R * tk, tap, win);
  float acc[RPT];
  r2f::sep::rank_sum(tap, win, tmp, R, KV, KH, acc);

  const int x = x0 + threadIdx.x;
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
  float flare = 0.0f, dmin = 0.0f, gam = 0.0f, x_t = 0.0f, x_s = 0.0f;
  float w_t = 1.0f, w_s = 1.0f;
  if (dev != nullptr) {
    flare = dev[0];
    dmin = dev[1 + c];
    gam = dev[4 + c];
    x_t = dev[7 + c];
    x_s = dev[10 + c];
    w_t = dev[13 + c];
    w_s = dev[16 + c];
  }
  const float inv_wt = 1.0f / w_t;
  const float inv_ws = 1.0f / w_s;

  const int rv = KV / 2;
  const int rw = KH / 2;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int ly = threadIdx.y + TY * k;
    const int y = y0 + ly;
    if (y >= H) break;
    const float* ur = rows_up + (static_cast<size_t>(c) * H + y) * W4;
    const float up = ur[j0] * w0 + ur[j1] * w1;
    const float blur = acc[k] + up;
    const float e = win[(rv + ly) * EW + rw + threadIdx.x];
    float v = (e + f * blur) * inv;
    if (dev != nullptr) {
      const float lx = r2f::log10_(fmaxf(v + flare, 1e-6f));
      v = dmin + gam * (r2f::softplus(lx - x_t, w_t, inv_wt) -
                        r2f::softplus(lx - x_s, w_s, inv_ws));
    }
    out[c * plane + static_cast<size_t>(y) * W + x] = v;
  }
}

}  // namespace

// img, out: (C, H, W) float32; rows_up: (C, H, W4) float32, W4 = ceil(W/4).
// taps: (R, KV + KH) float32 on the device, column taps then row taps per
// rank (shared by the channels). factors: C device floats; develop: 19
// device floats, or null for the combined exposure.
R2F_API int r2f_halation(const float* img, const float* rows_up, float* out,
                         int C, int H, int W, int W4, const float* taps, int R,
                         int KV, int KH, const float* factors,
                         const float* develop, void* stream) {
  if (R < 1 || KV < 1 || KH < 1 || KV % 2 == 0 || KH % 2 == 0 || W4 != (W + 3) / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int EW = r2f::sep::win_w(KH);
  const int WH = r2f::sep::win_h(KV);
  const size_t smem = sizeof(float) * (static_cast<size_t>(R) * (KV + KH) +
                                       static_cast<size_t>(WH) * EW +
                                       static_cast<size_t>(TH) * EW);
  const int e = r2f::sep::smem_opt_in(halation_kernel, smem);
  if (e != 0) return e;
  const dim3 block(TW, TY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  halation_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      img, rows_up, out, H, W, W4, taps, R, KV, KH, factors, develop);
  return static_cast<int>(cudaGetLastError());
}
