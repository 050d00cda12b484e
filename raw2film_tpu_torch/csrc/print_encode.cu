// K3: the chain's tail in one pass: [highlight burn] -> print H&D (or the
// inversion/direct offset) -> view matrix -> [shadow comp] -> 10^-d ->
// display matrix and white gain -> [saturation] -> transfer encode ->
// [round to uint8].
//
// Replaces raw2film_tpu/ops/pallas_print.py::print_encode_pallas (the TPU
// kernel _kernel), including its burn prologue fed by
// raw2film_tpu/ops/burn.py::burn_smallmap.
//
// Bound on the H100: device memory. Per pixel it reads 12 bytes (three
// float32 densities) and writes 3 (uint8) or 12 (float32); the tail itself
// is ~40 flops and 8 exp2/log2 per channel.
//
// Design: each thread owns one column and RB consecutive rows of a band, so
// the three channels of a pixel are in registers and the 3x3 mixes are
// register mul-adds. The 61 film parameters travel by value in the kernel's
// parameter space (uniform reads, served by the constant cache). The branch
// structure (mode, shadow, saturation, gamma, quantize, burn) is uniform
// ints. The burn glow up = rowmat @ small @
// colmat is never summed per pixel over the whole small map: the block
// first forms T = rowmat[band] @ small (RB x ws) in shared memory, then each
// pixel takes ws MACs against colmat, all in float32.
#include "common.cuh"

namespace {

constexpr int BW = 128;  // columns per block (blockDim.x)
constexpr int RB = 8;    // rows per block, all handled by each thread
constexpr int PVEC_LEN = 61;

enum Mode : int { MODE_PRINT = 0, MODE_OFFSET = 1 };

struct PVec {
  float p[PVEC_LEN];
};

__global__ void __launch_bounds__(BW)
    print_encode_kernel(const float* __restrict__ d, const PVec pv,
                        const float* __restrict__ small,
                        const float* __restrict__ rowmat,
                        const float* __restrict__ colmat, int hs, int ws,
                        void* __restrict__ out, int H, int W, int mode,
                        int shadow, int sat_neutral, int gamma, int quantize,
                        int burn) {
  extern __shared__ float T[];  // RB x ws burn band
  const float(&P)[PVEC_LEN] = pv.p;
  const int x = blockIdx.x * BW + threadIdx.x;
  const int y0 = blockIdx.y * RB;
  if (burn) {
    for (int i = threadIdx.x; i < RB * ws; i += BW) {
      const int r = i / ws;
      const int k = i % ws;
      const int y = min(y0 + r, H - 1);
      const float* rm = rowmat + static_cast<size_t>(y) * hs;
      float s = 0.0f;
      for (int j = 0; j < hs; ++j) s += rm[j] * small[j * ws + k];
      T[i] = s;
    }
  }
  __syncthreads();
  if (x >= W) return;

  const float inv_w_toe[3] = {1.0f / P[24], 1.0f / P[25], 1.0f / P[26]};
  const float inv_w_sh[3] = {1.0f / P[27], 1.0f / P[28], 1.0f / P[29]};
  const size_t plane = static_cast<size_t>(H) * W;
  const float hb = P[60];

#pragma unroll 1
  for (int r = 0; r < RB; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    const size_t o = static_cast<size_t>(y) * W + x;
    float dp[3] = {d[o], d[plane + o], d[2 * plane + o]};
    if (burn) {
      float up = 0.0f;
      for (int k = 0; k < ws; ++k) up += T[r * ws + k] * colmat[static_cast<size_t>(k) * W + x];
#pragma unroll
      for (int c = 0; c < 3; ++c) dp[c] = fmaxf(dp[c] - hb * up, 0.0f);
    }
    float dpp[3];
    if (mode == MODE_PRINT) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float log_e =
            P[9 + c] - (P[3 * c] * dp[0] + P[3 * c + 1] * dp[1] + P[3 * c + 2] * dp[2]);
        dpp[c] = P[12 + c] +
                 P[15 + c] * (r2f::softplus(log_e - P[18 + c], P[24 + c], inv_w_toe[c]) -
                              r2f::softplus(log_e - P[21 + c], P[27 + c], inv_w_sh[c]));
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) dpp[c] = dp[c] - P[30 + c];
    }
    float lin[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float vd = P[33 + 3 * c] * dpp[0] + P[34 + 3 * c] * dpp[1] + P[35 + 3 * c] * dpp[2];
      if (shadow) vd = vd - P[42] * r2f::softplus(vd - P[43], 0.35f, 1.0f / 0.35f);
      lin[c] = r2f::pow10_(-(vd + P[44 + c]));
    }
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rgb[c] = (P[47 + 3 * c] * lin[0] + P[48 + 3 * c] * lin[1] + P[49 + 3 * c] * lin[2]) *
               P[56 + c];
    }
    if (!sat_neutral) {
      const float luma = 0.2126f * rgb[0] + 0.7152f * rgb[1] + 0.0722f * rgb[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = luma + P[59] * (rgb[c] - luma);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float q = r2f::encode(rgb[c], gamma);
      if (quantize) {
        // rintf rounds half to even, as jnp.round does.
        static_cast<uint8_t*>(out)[c * plane + o] =
            static_cast<uint8_t>(static_cast<int>(rintf(q * 255.0f)));
      } else {
        static_cast<float*>(out)[c * plane + o] = q;
      }
    }
  }
}

}  // namespace

// d: (3, H, W) float32; pvec: 61 host floats (ops/print_encode.py layout);
// out: (3, H, W) uint8 (quantize=1) or float32. With burn: small (hs, ws),
// rowmat (H, hs), colmat (ws, W), all float32 on the device.
R2F_API int r2f_print_encode(const float* d, const float* pvec, const float* small,
                             const float* rowmat, const float* colmat, int hs,
                             int ws, void* out, int H, int W, int mode, int shadow,
                             int sat_neutral, int gamma, int quantize, int burn,
                             void* stream) {
  PVec pv;
  for (int i = 0; i < PVEC_LEN; ++i) pv.p[i] = pvec[i];
  const size_t smem = burn ? sizeof(float) * RB * ws : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(print_encode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + BW - 1) / BW, (H + RB - 1) / RB);
  print_encode_kernel<<<grid, BW, smem, static_cast<cudaStream_t>(stream)>>>(
      d, pv, small, rowmat, colmat, hs, ws, out, H, W, mode, shadow, sat_neutral,
      gamma, quantize, burn);
  return static_cast<int>(cudaGetLastError());
}
