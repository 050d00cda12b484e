// K5 and K6: a 1-D correlation along one axis of a (C, H, W) float32 image.
//
// K5 conv_w replaces raw2film_tpu/ops/pallas_conv2.py::conv_w (along W) and
// K6 conv_h replaces pallas_conv2.py::conv_h (along H):
//
//   conv_w: out[c, y, x] = sum_q t[q] img[c, y, refl(x + q - r, W)]
//   conv_h: out[c, y, x] = sum_q t[q] img[c, refl(y + q - r, H), x]
//
// with r = n / 2 for n taps (odd) and refl the reflect-101 border; a single
// tap reads no neighbour (the TPU's "edge" pad of width 0). Taps equal to 0
// are skipped, and the terms are summed in tap order with separate float32
// multiplies and adds (__fmul_rn, __fadd_rn: no FMA contraction), as the
// TPU kernels and the plain version (ops/conv.py::conv1d_axis) sum them, so
// the result is bit-equal to the plain version's.
//
// Bound on the H100: device memory, 8 bytes per output (one read, one write)
// against 2 n FLOPs. Design, simple first: one output per thread, a block of
// 256 threads along the row, the taps read from device memory (one broadcast
// load per tap for the whole warp), the n neighbours of each output from L1.
// The reflect-101 index (an integer modulo) is computed only for outputs
// whose taps reach a border.
// The TPU pads H to its tile and drops to XLA on small images; this kernel
// serves every shape.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// sum_q t[q] src[idx(lo + q) * stride] in tap order, zero taps skipped; the
// reflect-101 index only where the window reaches a border.
__device__ __forceinline__ float correlate(const float* __restrict__ src, size_t stride, int lo,
                                           int len, const float* __restrict__ taps, int n) {
  float s = 0.0f;
  bool first = true;
  if (lo >= 0 && lo + n <= len) {
    for (int q = 0; q < n; ++q) {
      const float t = taps[q];
      if (t == 0.0f) continue;
      const float term = __fmul_rn(t, src[(lo + q) * stride]);
      s = first ? term : __fadd_rn(s, term);
      first = false;
    }
    return s;
  }
  for (int q = 0; q < n; ++q) {
    const float t = taps[q];
    if (t == 0.0f) continue;
    const float term = __fmul_rn(t, src[r2f::reflect101(lo + q, len) * stride]);
    s = first ? term : __fadd_rn(s, term);
    first = false;
  }
  return s;
}

__global__ void __launch_bounds__(NT)
    conv_w_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                  const float* __restrict__ taps, int n) {
  const int x = blockIdx.x * NT + threadIdx.x;
  if (x >= W) return;
  const size_t row = (static_cast<size_t>(blockIdx.z) * H + blockIdx.y) * W;
  out[row + x] = correlate(img + row, 1, x - n / 2, W, taps, n);
}

__global__ void __launch_bounds__(NT)
    conv_h_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                  const float* __restrict__ taps, int n) {
  const int x = blockIdx.x * NT + threadIdx.x;
  if (x >= W) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  const int y = blockIdx.y;
  out[plane + static_cast<size_t>(y) * W + x] =
      correlate(img + plane + x, static_cast<size_t>(W), y - n / 2, H, taps, n);
}

}  // namespace

// img, out: (C, H, W) float32; taps: n device floats, n odd. axis 0: along W
// (K5), 1: along H (K6).
R2F_API int r2f_conv1d(const float* img, float* out, int C, int H, int W,
                       const float* taps, int n, int axis, void* stream) {
  if (n < 1 || n % 2 == 0 || C < 1 || H < 1 || W < 1 || H > 65535 || C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + NT - 1) / NT, H, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    conv_w_kernel<<<grid, NT, 0, s>>>(img, out, H, W, taps, n);
  } else {
    conv_h_kernel<<<grid, NT, 0, s>>>(img, out, H, W, taps, n);
  }
  return static_cast<int>(cudaGetLastError());
}
