// K1: Malvar-He-Cutler demosaic with the input-transform epilogue, and
// K11: the half-size decode.
//
// Replaces raw2film_tpu/ops/pallas_demosaic.py::demosaic_mhc_pallas (the
// TPU kernel _demosaic_kernel), with the u16 normalize of
// raw2film_tpu/pipeline/render.py:540-548 as its prologue.
//
// Bound on the H100: device memory. Per pixel it reads 2 bytes (u16) or 4
// (f32) and writes 12 (three float32 planes); the arithmetic is ~40 flops.
//
// Design: one output pixel per thread. A block stages its tile plus the
// 2-pixel halo in shared memory with coalesced row loads, so each mosaic
// value is read from device memory about once. Reflect-101 at the frame
// edges is index arithmetic (no padded copy). The normalize
// clip01((x - black) * inv_range) is applied while staging. The four
// interpolants use the grouped pair sums of the TPU kernel, so float32
// rounding tracks the reference. With a matrix, the epilogue writes
// max(M . clip01(rgb), 0) and the RGB image never reaches memory.
//
// K11 half_size replaces raw2film_tpu/ops/pallas_pyramid.py::
// half_size_decode_pallas: each 2x2 Bayer cell gives one RGB pixel,
//   r = x[2i + ry][2j + rx], b = x[2i + 1 - ry][2j + 1 - rx],
//   g = 0.5 (x[2i + ry][2j + 1 - rx] + x[2i + 1 - ry][2j + rx]),
// with an odd last row or column dropped. The TPU kernel selects the phases
// with 0/1 matmuls (the image split into exact bf16 halves) and declines
// small frames; here each thread reads its cell by index and every shape is
// served. The same u16 normalize prologue as K1. Bound: device memory, 2
// bytes read (u16) and 3 bytes written per mosaic pixel.
#include "common.cuh"

namespace {

constexpr int R = 2;    // 5x5 stencil radius
constexpr int TW = 32;  // tile width  (blockDim.x)
constexpr int TH = 8;   // tile height (blockDim.y)

struct Mat9 {
  float m[9];
};

template <typename T>
__device__ __forceinline__ float load_px(const T* src, size_t idx, int norm,
                                         float black, float inv_range) {
  float v = static_cast<float>(src[idx]);
  if (norm) v = fminf(fmaxf((v - black) * inv_range, 0.0f), 1.0f);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(TW* TH)
    demosaic_kernel(const T* __restrict__ mosaic, float* __restrict__ out,
                    int H, int W, int ry, int rx, int norm, float black,
                    float inv_range, int has_mat, Mat9 mat) {
  __shared__ float win[TH + 2 * R][TW + 2 * R];
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int i = tid; i < (TH + 2 * R) * (TW + 2 * R); i += TW * TH) {
    const int wy = i / (TW + 2 * R);
    const int wx = i % (TW + 2 * R);
    const int gy = r2f::reflect101(y0 + wy - R, H);
    const int gx = r2f::reflect101(x0 + wx - R, W);
    win[wy][wx] = load_px(mosaic, static_cast<size_t>(gy) * W + gx, norm,
                          black, inv_range);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + R;
  const int cx = threadIdx.x + R;
#define SH(dy, dx) win[cy + (dy)-R][cx + (dx)-R]
  const float m = SH(2, 2);
  const float h1 = SH(2, 1) + SH(2, 3);
  const float v1 = SH(1, 2) + SH(3, 2);
  const float h2 = SH(2, 0) + SH(2, 4);
  const float v2 = SH(0, 2) + SH(4, 2);
  const float dg = (SH(1, 1) + SH(1, 3)) + (SH(3, 1) + SH(3, 3));
#undef SH
  const float e = 0.125f;
  const float hv2 = h2 + v2;
  const float t_g = e * (4.0f * m + 2.0f * (h1 + v1) - hv2);
  const float t_row = e * (5.0f * m + 4.0f * h1 - dg - h2 + 0.5f * v2);
  const float t_col = e * (5.0f * m + 4.0f * v1 - dg - v2 + 0.5f * h2);
  const float t_opp = e * (6.0f * m + 2.0f * dg - 1.5f * hv2);

  // Bayer phase from the global row/column parity.
  const int yy = y & 1;
  const int xx = x & 1;
  const bool is_r = yy == ry && xx == rx;
  const bool is_b = yy == 1 - ry && xx == 1 - rx;
  const bool g_r_row = yy == ry && xx == 1 - rx;
  const bool g_b_row = yy == 1 - ry && xx == rx;
  float r = is_r ? m : (g_r_row ? t_row : (g_b_row ? t_col : t_opp));
  float g = (is_r || is_b) ? t_g : m;
  float b = is_b ? m : (g_b_row ? t_row : (g_r_row ? t_col : t_opp));

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t o = static_cast<size_t>(y) * W + x;
  if (has_mat) {
    r = fminf(fmaxf(r, 0.0f), 1.0f);
    g = fminf(fmaxf(g, 0.0f), 1.0f);
    b = fminf(fmaxf(b, 0.0f), 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c * plane + o] = fmaxf(
          mat.m[3 * c] * r + mat.m[3 * c + 1] * g + mat.m[3 * c + 2] * b, 0.0f);
    }
  } else {
    out[o] = r;
    out[plane + o] = g;
    out[2 * plane + o] = b;
  }
}

template <typename T>
__global__ void half_size_kernel(const T* __restrict__ mosaic, float* __restrict__ out,
                                 int W, int h2, int w2, int ry, int rx, int norm,
                                 float black, float inv_range) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= w2 || i >= h2) return;
  const size_t row_r = static_cast<size_t>(2 * i + ry) * W;
  const size_t row_b = static_cast<size_t>(2 * i + 1 - ry) * W;
  const float r = load_px(mosaic, row_r + 2 * j + rx, norm, black, inv_range);
  const float ga = load_px(mosaic, row_r + 2 * j + 1 - rx, norm, black, inv_range);
  const float gb = load_px(mosaic, row_b + 2 * j + rx, norm, black, inv_range);
  const float b = load_px(mosaic, row_b + 2 * j + 1 - rx, norm, black, inv_range);
  const size_t plane = static_cast<size_t>(h2) * w2;
  const size_t o = static_cast<size_t>(i) * w2 + j;
  out[o] = r;
  out[plane + o] = 0.5f * (ga + gb);
  out[2 * plane + o] = b;
}

}  // namespace

// mosaic: (H, W) uint16 (is_u16=1) or float32; out: (3, H/2, W/2) float32.
R2F_API int r2f_half_size(const void* mosaic, int is_u16, float* out, int H, int W,
                          int ry, int rx, int norm, float black, float inv_range,
                          void* stream) {
  const int h2 = H / 2;
  const int w2 = W / 2;
  const dim3 block(32, 8);
  const dim3 grid((w2 + 31) / 32, (h2 + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u16) {
    half_size_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(mosaic), out, W, h2, w2, ry, rx, norm, black, inv_range);
  } else {
    half_size_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(mosaic), out, W, h2, w2, ry, rx, norm, black, inv_range);
  }
  return static_cast<int>(cudaGetLastError());
}

// mosaic: (H, W) uint16 (is_u16=1) or float32; out: (3, H, W) float32.
// mat: 9 host floats, row-major, or null for the plain RGB output.
R2F_API int r2f_demosaic(const void* mosaic, int is_u16, float* out, int H,
                         int W, int ry, int rx, int norm, float black,
                         float inv_range, const float* mat, void* stream) {
  Mat9 m{};
  const int has_mat = mat != nullptr;
  if (has_mat)
    for (int i = 0; i < 9; ++i) m.m[i] = mat[i];
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u16) {
    demosaic_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(mosaic), out, H, W, ry, rx, norm, black,
        inv_range, has_mat, m);
  } else {
    demosaic_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(mosaic), out, H, W, ry, rx, norm, black,
        inv_range, has_mat, m);
  }
  return static_cast<int>(cudaGetLastError());
}

R2F_API const char* r2f_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
