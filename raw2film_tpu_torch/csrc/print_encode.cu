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
// float32 densities) and writes 3 (uint8) or 12 (float32): 0.201 ms at 45
// MP. The burn glow up = rowmat @ small @ colmat is about 81 MACs per pixel
// (49 x 74 small map) and the tail about 100 instructions, up to 8 of them
// exp2/log2 per channel. What bounds it in practice is the SFU, which runs
// those (21 a pixel in print mode with sRGB), and the burn's FMAs: 0.63 ms
// device at 45 MP with the burn (2.02 before this design), 0.335 without
// (NVIDIA H100 80GB HBM3, 700 W; scripts/port_times.py).
//
// Design: a block covers RB = 16 rows of BW = 512 columns, each thread 4
// consecutive columns of all 16 rows, so densities load as 16-byte vectors
// and codes store 4 bytes at a time, and the three channels of a pixel are
// in registers for the 3x3 mixes. The 61 film parameters travel by value
// in the kernel's parameter space (uniform reads). The branch structure
// (mode, shadow, saturation, gamma) is uniform ints; the burn and the
// quantize are template arguments.
// The burn keeps the TPU kernel's two dense products, all in float32:
// - the block first forms its band T = rowmat[band] @ small (RB x ws) in
//   shared memory, hs * ws / 512 MACs per pixel (7 at 45 MP; 28 with the
//   old 128-column blocks), from small and the band's rowmat rows staged in
//   shared memory.
// - then the colmat product, register-tiled: per k a thread loads colmat's
//   4 values of its columns once (16 bytes, two rows ahead of its FMAs) and
//   T's 16 values of its band (broadcast float4 reads, T stored k-major)
//   and does 64 FMAs into its 16 x 4 sums. colmat is read from L2 once per
//   16 rows, not per row.
// The sums go through shared memory (aliasing T) so the tail runs one row
// at a time without a register array indexed at run time.
// The tail's exp2/log2 run on the SFU (common.cuh: softplus, pow10_, powc,
// the LogC3 log): the old library forms were about 21 polynomials per
// pixel, 15-28 instructions each.
#include "common.cuh"

namespace {

constexpr int NTH = 128;      // threads per block
constexpr int VX = 4;         // consecutive columns per thread
constexpr int BW = NTH * VX;  // columns per block
constexpr int RB = 16;        // rows per block, all handled by each thread
constexpr int PVEC_LEN = 61;

enum Mode : int { MODE_PRINT = 0, MODE_OFFSET = 1 };

struct PVec {
  float p[PVEC_LEN];
};

// Shared-memory floats of a block: the band's rowmat rows, T and small,
// later the 16 x 4 burn sums of every thread.
__host__ __device__ __forceinline__ int rm_floats(int hs) { return (hs * RB + 3) & ~3; }
__host__ __device__ __forceinline__ size_t smem_floats(int hs, int ws) {
  const size_t band = static_cast<size_t>(rm_floats(hs)) + static_cast<size_t>(ws) * RB +
                      static_cast<size_t>(hs) * ws;
  const size_t sums = static_cast<size_t>(RB) * NTH * VX;
  return band > sums ? band : sums;
}

// The 4 floats at p, columns x0 .. x0 + 3 of a row: one 16-byte load when
// vec, else the nx < 4 that lie inside the row (0 past it).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool vec, int nx) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), nx > 1 ? __ldg(p + 1) : 0.0f, nx > 2 ? __ldg(p + 2) : 0.0f,
                     nx > 3 ? __ldg(p + 3) : 0.0f);
}

// The tail of one pixel: densities dp (after the burn) -> encoded value of
// each channel in q.
__device__ __forceinline__ void tail(const float (&P)[PVEC_LEN], const float (&inv_w_toe)[3],
                                     const float (&inv_w_sh)[3], float (&dp)[3], int mode,
                                     int shadow, int sat_neutral, int gamma, float (&q)[3]) {
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
  for (int c = 0; c < 3; ++c) q[c] = r2f::encode(rgb[c], gamma);
}

// rintf rounds half to even, as jnp.round does.
__device__ __forceinline__ uint32_t code(float q) {
  return static_cast<uint32_t>(static_cast<int>(rintf(q * 255.0f))) & 0xFFu;
}

// vec: W % 4 == 0 and d, out and colmat 16-byte aligned, so every thread's
// 4 columns are one aligned vector (or lie past W).
template <bool kBurn, bool kQuant>
__global__ void __launch_bounds__(NTH)
    print_encode_kernel(const float* __restrict__ d, const PVec pv,
                        const float* __restrict__ small, const float* __restrict__ rowmat,
                        const float* __restrict__ colmat, int hs, int ws,
                        void* __restrict__ out, int H, int W, int mode, int shadow,
                        int sat_neutral, int gamma, int vec) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const float(&P)[PVEC_LEN] = pv.p;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * BW + tid * VX;
  const int y0 = blockIdx.y * RB;
  const int nx = min(VX, W - x0);

  if constexpr (kBurn) {
    float* rm = sm;                  // rm[j * RB + r] = rowmat[y0 + r, j]
    float* T = sm + rm_floats(hs);   // T[k * RB + r] = (rowmat @ small)[y0 + r, k]
    float* sm_small = T + ws * RB;   // small, row-major
    for (int i = tid; i < RB * hs; i += NTH) {
      const int r = i / hs;
      const int j = i - r * hs;
      rm[j * RB + r] = rowmat[static_cast<size_t>(min(y0 + r, H - 1)) * hs + j];
    }
    for (int i = tid; i < hs * ws; i += NTH) sm_small[i] = small[i];
    __syncthreads();
    for (int k = tid; k < ws; k += NTH) {
      float t[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) t[r] = 0.0f;
      for (int j = 0; j < hs; ++j) {
        const float s = sm_small[j * ws + k];
        const float4* m = reinterpret_cast<const float4*>(rm + j * RB);
#pragma unroll
        for (int r4 = 0; r4 < RB / 4; ++r4) {
          const float4 w = m[r4];
          t[4 * r4] = fmaf(w.x, s, t[4 * r4]);
          t[4 * r4 + 1] = fmaf(w.y, s, t[4 * r4 + 1]);
          t[4 * r4 + 2] = fmaf(w.z, s, t[4 * r4 + 2]);
          t[4 * r4 + 3] = fmaf(w.w, s, t[4 * r4 + 3]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(T + k * RB);
#pragma unroll
      for (int r4 = 0; r4 < RB / 4; ++r4)
        dst[r4] = make_float4(t[4 * r4], t[4 * r4 + 1], t[4 * r4 + 2], t[4 * r4 + 3]);
    }
    __syncthreads();
    float up[RB][VX];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int i = 0; i < VX; ++i) up[r][i] = 0.0f;
    if (x0 < W) {
      // colmat's rows k + 1 and k + 2 are in flight while row k's FMAs run
      const float* cm = colmat + x0;
      float4 next[2];
      next[0] = load4(cm, vec, nx);
      next[1] = ws > 1 ? load4(cm + W, vec, nx) : next[0];
      for (int k = 0; k < ws; ++k) {
        const float4 v = next[0];
        next[0] = next[1];
        if (k + 2 < ws) next[1] = load4(cm + static_cast<size_t>(k + 2) * W, vec, nx);
        const float m[VX] = {v.x, v.y, v.z, v.w};
        const float4* tk = reinterpret_cast<const float4*>(T + k * RB);
#pragma unroll
        for (int r4 = 0; r4 < RB / 4; ++r4) {
          const float4 t = tk[r4];
#pragma unroll
          for (int i = 0; i < VX; ++i) {
            up[4 * r4][i] = fmaf(t.x, m[i], up[4 * r4][i]);
            up[4 * r4 + 1][i] = fmaf(t.y, m[i], up[4 * r4 + 1][i]);
            up[4 * r4 + 2][i] = fmaf(t.z, m[i], up[4 * r4 + 2][i]);
            up[4 * r4 + 3][i] = fmaf(t.w, m[i], up[4 * r4 + 3][i]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with T: its space takes the sums
#pragma unroll
    for (int r = 0; r < RB; ++r)
      smem4[r * NTH + tid] = make_float4(up[r][0], up[r][1], up[r][2], up[r][3]);
    // each thread reads back only its own sums: no barrier
  }
  if (x0 >= W) return;

  const float inv_w_toe[3] = {1.0f / P[24], 1.0f / P[25], 1.0f / P[26]};
  const float inv_w_sh[3] = {1.0f / P[27], 1.0f / P[28], 1.0f / P[29]};
  const size_t plane = static_cast<size_t>(H) * W;
  const float hb = P[60];
  const int rows = min(RB, H - y0);

  // the next row's densities load while this row's tail runs
  float4 nd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    nd[c] = load4(d + c * plane + static_cast<size_t>(y0) * W + x0, vec, nx);
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const size_t o = static_cast<size_t>(y0 + r) * W + x0;
    float dp[3][VX];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dp[c][0] = nd[c].x;
      dp[c][1] = nd[c].y;
      dp[c][2] = nd[c].z;
      dp[c][3] = nd[c].w;
      if (r + 1 < rows) nd[c] = load4(d + c * plane + o + W, vec, nx);
    }
    if constexpr (kBurn) {
      const float4 u = smem4[r * NTH + tid];
      const float up[VX] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < VX; ++i) dp[c][i] = fmaxf(dp[c][i] - hb * up[i], 0.0f);
    }
    float q[3][VX];
#pragma unroll
    for (int i = 0; i < VX; ++i) {
      float px[3] = {dp[0][i], dp[1][i], dp[2][i]};
      float qi[3];
      tail(P, inv_w_toe, inv_w_sh, px, mode, shadow, sat_neutral, gamma, qi);
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c][i] = qi[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if constexpr (kQuant) {
        uint8_t* dst = static_cast<uint8_t*>(out) + c * plane + o;
        if (vec) {
          *reinterpret_cast<uint32_t*>(dst) =
              code(q[c][0]) | code(q[c][1]) << 8 | code(q[c][2]) << 16 | code(q[c][3]) << 24;
        } else {
#pragma unroll
          for (int i = 0; i < VX; ++i)
            if (i < nx) dst[i] = static_cast<uint8_t>(code(q[c][i]));
        }
      } else {
        float* dst = static_cast<float*>(out) + c * plane + o;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(q[c][0], q[c][1], q[c][2], q[c][3]);
        } else {
#pragma unroll
          for (int i = 0; i < VX; ++i)
            if (i < nx) dst[i] = q[c][i];
        }
      }
    }
  }
}

template <bool kBurn, bool kQuant>
int launch(const float* d, const PVec& pv, const float* small, const float* rowmat,
           const float* colmat, int hs, int ws, void* out, int H, int W, int mode, int shadow,
           int sat_neutral, int gamma, int vec, cudaStream_t stream) {
  const size_t smem = kBurn ? sizeof(float) * smem_floats(hs, ws) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(print_encode_kernel<kBurn, kQuant>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + BW - 1) / BW, (H + RB - 1) / RB);
  print_encode_kernel<kBurn, kQuant><<<grid, NTH, smem, stream>>>(
      d, pv, small, rowmat, colmat, hs, ws, out, H, W, mode, shadow, sat_neutral, gamma, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d: (3, H, W) float32; pvec: 61 host floats (ops/print_encode.py layout);
// out: (3, H, W) uint8 (quantize=1) or float32. With burn: small (hs, ws),
// rowmat (H, hs), colmat (ws, W), all float32 on the device. vec: 1 when W
// % 4 == 0 and d, out and colmat are 16-byte aligned (the caller checks).
R2F_API int r2f_print_encode(const float* d, const float* pvec, const float* small,
                             const float* rowmat, const float* colmat, int hs,
                             int ws, void* out, int H, int W, int mode, int shadow,
                             int sat_neutral, int gamma, int quantize, int burn, int vec,
                             void* stream) {
  if (H < 1 || W < 1 || (burn && (hs < 1 || ws < 1)) || (vec && W % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  PVec pv;
  for (int i = 0; i < PVEC_LEN; ++i) pv.p[i] = pvec[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (burn) {
    return quantize ? launch<true, true>(d, pv, small, rowmat, colmat, hs, ws, out, H, W, mode,
                                         shadow, sat_neutral, gamma, vec, s)
                    : launch<true, false>(d, pv, small, rowmat, colmat, hs, ws, out, H, W, mode,
                                          shadow, sat_neutral, gamma, vec, s);
  }
  return quantize ? launch<false, true>(d, pv, small, rowmat, colmat, hs, ws, out, H, W, mode,
                                        shadow, sat_neutral, gamma, vec, s)
                  : launch<false, false>(d, pv, small, rowmat, colmat, hs, ws, out, H, W, mode,
                                         shadow, sat_neutral, gamma, vec, s);
}
