// K10, K12 and K13: the pyramid resamples of the halation glow.
//
// K10 box_downsample replaces raw2film_tpu/ops/pallas_pyramid.py::
// box_downsample_pallas: (C, H, W) -> (C, H/f, W/f) block mean for any
// integer f, the remainder cropped. Each output sums its f x f block down
// each column first, then the column sums left to right (the order of
// Dh @ x @ Dw with 0/1 bands), then multiplies by float32(1 / f^2), as the
// TPU path does after its kernel.
//
// K12 upsample_rows replaces pallas_pyramid.py::bilinear_upsample_rows_pallas:
// the x f half-pixel lerp of the row axis only, edge clamp at both ends,
// cropped to oh rows; columns untouched. Output row o = q f + m reads input
// rows q + b_m and q + b_m + 1 (each clamped to [0, h - 1]) with weights
// 1 - frac_m and frac_m, where rel = (m + 0.5) / f - 0.5, b_m = floor(rel)
// and frac_m = rel - b_m are taken in double precision and rounded to
// float32, as the host builds the TPU kernel's lerp matrix. For f = 4 the
// weights are exact: 0.125, 0.375, 0.625, 0.875.
//
// K13 upsample replaces pallas_pyramid.py::bilinear_upsample_pallas: the
// 2-D x f half-pixel lerp with edge clamp, cropped to (oh, ow), for any
// integer f. The TPU runs it as Uh @ window @ Uw with lerp band matrices per
// chunk; here each output lerps the rows first, then the two row results
// along the columns (the order of Uh @ win @ Uw), with the K12 weights on
// both axes.
//
// Bound on the H100: device memory, all three. At 45 MP K10 reads 540 MB and
// writes 34 MB; K12 reads 34 MB (each input row serves 2f output rows, from
// L2) and writes 135 MB. One thread per output, consecutive threads on
// consecutive output columns, so every warp's loads are one contiguous run
// of each input row. K13 reads 1/f^2 of what it writes (from L2) and writes
// 540 MB at 45 MP.
#include "common.cuh"

namespace {

__global__ void box_downsample_kernel(const float* __restrict__ img,
                                      float* __restrict__ out, int H, int W,
                                      int h2, int w2, int f, float inv) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= w2 || y >= h2) return;
  const float* src = img + static_cast<size_t>(c) * H * W +
                     static_cast<size_t>(y) * f * W + static_cast<size_t>(x) * f;
  float total = 0.0f;
  for (int j = 0; j < f; ++j) {
    float col = src[j];
    for (int i = 1; i < f; ++i) col += src[static_cast<size_t>(i) * W + j];
    total = j == 0 ? col : total + col;
  }
  out[(static_cast<size_t>(c) * h2 + y) * w2 + x] = total * inv;
}

__global__ void upsample_rows_kernel(const float* __restrict__ img,
                                     float* __restrict__ out, int h, int w,
                                     int f, int oh) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int o = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= w || o >= oh) return;
  const int m = o % f;
  const double rel = (m + 0.5) / f - 0.5;
  const double base = floor(rel);
  const double frac = rel - base;
  const int i0 = o / f + static_cast<int>(base);
  const int r0 = min(max(i0, 0), h - 1);
  const int r1 = min(max(i0 + 1, 0), h - 1);
  const float* src = img + static_cast<size_t>(c) * h * w + x;
  const float w0 = static_cast<float>(1.0 - frac);
  const float w1 = static_cast<float>(frac);
  out[(static_cast<size_t>(c) * oh + o) * w + x] =
      w0 * src[static_cast<size_t>(r0) * w] + w1 * src[static_cast<size_t>(r1) * w];
}

// Half-pixel x f lerp taps of output o on a length-n input axis, clamped.
__device__ __forceinline__ void lerp_tap(int o, int f, int n, int& i0, int& i1, float& w0,
                                         float& w1) {
  const int m = o % f;
  const double rel = (m + 0.5) / f - 0.5;
  const double base = floor(rel);
  const double frac = rel - base;
  const int b = o / f + static_cast<int>(base);
  i0 = min(max(b, 0), n - 1);
  i1 = min(max(b + 1, 0), n - 1);
  w0 = static_cast<float>(1.0 - frac);
  w1 = static_cast<float>(frac);
}

__global__ void upsample_kernel(const float* __restrict__ img, float* __restrict__ out,
                                int h, int w, int f, int oh, int ow) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= ow || y >= oh) return;
  int r0, r1, c0, c1;
  float wr0, wr1, wc0, wc1;
  lerp_tap(y, f, h, r0, r1, wr0, wr1);
  lerp_tap(x, f, w, c0, c1, wc0, wc1);
  const float* src = img + static_cast<size_t>(c) * h * w;
  const float* a = src + static_cast<size_t>(r0) * w;
  const float* b = src + static_cast<size_t>(r1) * w;
  const float t0 = wr0 * a[c0] + wr1 * b[c0];
  const float t1 = wr0 * a[c1] + wr1 * b[c1];
  out[(static_cast<size_t>(c) * oh + y) * ow + x] = wc0 * t0 + wc1 * t1;
}

}  // namespace

// img: (C, h, w) float32; out: (C, oh, ow) float32, oh <= h f, ow <= w f.
R2F_API int r2f_upsample(const float* img, float* out, int C, int h, int w, int f,
                         int oh, int ow, void* stream) {
  if (f < 1 || oh > h * f || ow > w * f) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(64, 4);
  const dim3 grid((ow + 63) / 64, (oh + 3) / 4, C);
  upsample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, f, oh, ow);
  return static_cast<int>(cudaGetLastError());
}

// img: (C, H, W) float32; out: (C, H/f, W/f) float32; inv = float32(1/f^2).
R2F_API int r2f_box_downsample(const float* img, float* out, int C, int H, int W,
                               int f, float inv, void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int h2 = H / f;
  const int w2 = W / f;
  const dim3 block(32, 8);
  const dim3 grid((w2 + 31) / 32, (h2 + 7) / 8, C);
  box_downsample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, h2, w2, f, inv);
  return static_cast<int>(cudaGetLastError());
}

// img: (C, h, w) float32; out: (C, oh, w) float32, oh <= h * f.
R2F_API int r2f_upsample_rows(const float* img, float* out, int C, int h, int w,
                              int f, int oh, void* stream) {
  if (f < 1 || oh > h * f) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(64, 4);
  const dim3 grid((w + 63) / 64, (oh + 3) / 4, C);
  upsample_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, f, oh);
  return static_cast<int>(cudaGetLastError());
}
