// K1: Malvar-He-Cutler demosaic with the input-transform epilogue,
// K11: the half-size decode, and K15: the fused path's exposure sample.
//
// Replaces raw2film_tpu/ops/pallas_demosaic.py::demosaic_mhc_pallas (the
// TPU kernel _demosaic_kernel), with the u16 normalize of
// raw2film_tpu/pipeline/render.py:540-548 as its prologue.
//
// Bound on the H100: device memory. Per pixel it reads 2 bytes (u16) or 4
// (f32) and writes 12 (three float32 planes); the arithmetic is ~40 flops.
// One output per thread held it to half that bound: ~110 instructions a
// pixel (the staging's division, two reflects and a 2-byte load per value,
// 13 shared loads, all four interpolants, a runtime select and three
// 4-byte stores) made it issue-bound.
//
// Design: a block of BX x BY threads stages a TH x TW tile plus the 2-pixel
// halo in shared memory, normalizing as it stages
// (clip01((x - black) * inv_range)); each thread then makes a run of 2 rows
// x DX columns that starts on an even row and column, so the Bayer site of
// every output is known at compile time (one instance per phase (ry, rx)).
// For each of its rows it reads the 5 x (DX + 4) window (two 16-byte
// shared loads a row) and computes for each output only the two
// interpolants its site needs, with the grouped pair sums and the
// expressions of the TPU kernel, so float32 rounding tracks the reference:
//   R site: G = t_g, B = t_opp;  B site: G = t_g, R = t_opp;
//   G on an R row: R = t_row, B = t_col;  G on a B row: R = t_col, B = t_row.
// With a matrix, the epilogue writes max(M . clip01(rgb), 0) and the RGB
// image never reaches memory.
//
// Two paths (the wrapper picks: ops/demosaic.py::vec_path). The 16-byte
// path takes W a multiple of the values in 16 bytes (8 u16, 4 f32) and a
// 16-byte aligned mosaic and output: interior tiles stage with 16-byte
// loads and no reflect, and each plane's run goes out in 16-byte stores.
// The general path serves every other shape: staging value by value with
// reflect-101 (numpy's repeated reflect on frames of 2-5 pixels a side),
// 4-byte stores. Edge tiles of the 16-byte path stage the same way. On the
// H100, streaming stores (__stcs) tied with plain ones, runs of 2 x 8
// (256-column tiles) measured 28 % slower and 32-row tiles 5 % slower
// (scripts/k1_k12_variants.py).
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
//
// K15 exposure_sample replaces no TPU kernel: the JAX package, and the port
// until it, estimated the fused path's exposure on the host
// (pipeline/processor.py::_half_size_xyz and io/raw.py::calc_exposure: a
// half-size XYZ decode of the whole frame, of which the power mean reads the
// Y plane 2x subsampled). It computes the same sum from the mosaic already
// on the device. Sample (i, j), i < ceil((H/2)/2), j < ceil((W/2)/2), is
// the 2x2 cell at row 4i, column 4j, each site clip01((p - black) *
// inv_range); R and B at their phase, G the mean of the two greens of an
// RGGB or BGGR cell and the (1, 1) site of a GRBG or GBRG one (the host
// decode's rule, not K11's); Y = c . (R, G, B) without FMA contraction, and
// the term max(Y, 1e-9) ** e (e = 1 / factor, float32). Terms sum in
// float64: per thread, a warp shuffle, a block sum into one partial per
// block, then one warp adds the partials in a fixed order, so the sum is
// the same on every run. Bound: device memory. Sampled rows 4i and 4i + 1
// are read whole (half the mosaic: ~45 MB of the 45 MP u16 frame, ~13 us at
// 3.35 TB/s), 16 bytes a thread along the row where the wrapper's vec_path
// allows (two samples per u16 chunk, one per f32 chunk), else 4 scalar
// loads a sample; 4 blocks of 256 threads an SM stride over the samples.
#include "common.cuh"

namespace {

constexpr int R = 2;            // 5x5 stencil radius
constexpr int DX = 4;           // output columns per thread (2 rows each)
constexpr int BX = 32;          // threads across a tile: one warp
constexpr int BY = 8;           // warps down a tile
constexpr int TW = BX * DX;     // tile width, 128
constexpr int TH = 2 * BY;      // tile height, 16
constexpr int SW = TW + 2 * R;  // staged window: columns x0 - 2 .. x0 + TW + 1
constexpr int SH = TH + 2 * R;  // rows y0 - 2 .. y0 + TH + 1
static_assert(DX % 4 == 0 && SW % 4 == 0, "runs and window rows must stay 16-byte aligned");

struct Mat9 {
  float m[9];
};

__device__ __forceinline__ float normalize(float v, int norm, float black, float inv_range) {
  return norm ? fminf(fmaxf((v - black) * inv_range, 0.0f), 1.0f) : v;
}

template <typename T>
__device__ __forceinline__ float load_px(const T* src, size_t idx, int norm,
                                         float black, float inv_range) {
  return normalize(static_cast<float>(src[idx]), norm, black, inv_range);
}

// One 16-byte chunk of the mosaic as floats: 8 u16 or 4 f32.
__device__ __forceinline__ void load16(const uint16_t* p, float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = static_cast<float>(w[i] & 0xFFFFu);
    v[2 * i + 1] = static_cast<float>(w[i] >> 16);
  }
}
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// One 16-byte store of the output.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Stage window rows y0 - 2 .. y0 + TH + 1, columns x0 - 2 .. x0 + TW + 1.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(float (*win)[SW], const T* __restrict__ mosaic, int H, int W,
                                      int x0, int y0, int norm, float black, float inv_range) {
  constexpr int CW = 16 / sizeof(T);  // values per 16-byte chunk
  if (VEC && y0 >= R && y0 + TH + R <= H && x0 >= CW && x0 + TW + CW <= W) {
    // Chunk k of a row holds columns x0 - CW + k CW ..: window column
    // k CW - CW + R onwards. The first and last chunks carry the halo and
    // store only its 2 columns; every store is 8- or 16-byte aligned.
    constexpr int NCH = TW / CW + 2;
    for (int i = threadIdx.y * BX + threadIdx.x; i < SH * NCH; i += BX * BY) {
      const int r = i / NCH;
      const int k = i - r * NCH;
      float v[CW];
      load16(mosaic + static_cast<size_t>(y0 - R + r) * W + (x0 - CW + k * CW), v);
#pragma unroll
      for (int j = 0; j < CW; ++j) v[j] = normalize(v[j], norm, black, inv_range);
      float* row = win[r] + (k * CW - CW + R);
      if (k > 0) *reinterpret_cast<float2*>(row) = make_float2(v[0], v[1]);
      if constexpr (CW == 8) {
        if (k > 0 && k < NCH - 1) *reinterpret_cast<float4*>(row + 2) = make_float4(v[2], v[3], v[4], v[5]);
        if (k < NCH - 1) *reinterpret_cast<float2*>(row + 6) = make_float2(v[6], v[7]);
      } else {
        if (k < NCH - 1) *reinterpret_cast<float2*>(row + 2) = make_float2(v[2], v[3]);
      }
    }
  } else {
    for (int r = threadIdx.y; r < SH; r += BY) {
      const T* src = mosaic + static_cast<size_t>(r2f::reflect101(y0 - R + r, H)) * W;
      for (int c = threadIdx.x; c < SW; c += BX)
        win[r][c] = load_px(src, r2f::reflect101(x0 - R + c, W), norm, black, inv_range);
    }
  }
}

// (RY, RX): the red site's row and column parity.
template <typename T, bool VEC, int RY, int RX>
__global__ void __launch_bounds__(BX* BY)
    demosaic_kernel(const T* __restrict__ mosaic, float* __restrict__ out, int H, int W,
                    int norm, float black, float inv_range, int has_mat, Mat9 mat) {
  __shared__ __align__(16) float win[SH][SW];
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  stage<T, VEC>(win, mosaic, H, W, x0, y0, norm, black, inv_range);
  __syncthreads();

  const int x = x0 + DX * threadIdx.x;
  const int y = y0 + 2 * threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    if (y + dy >= H) break;
    // window rows y + dy - 2 .. y + dy + 2, columns x - 2 .. x + DX + 1
    float v[5][DX + 4];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float* row = &win[2 * threadIdx.y + dy + i][DX * threadIdx.x];
#pragma unroll
      for (int j = 0; j < DX + 4; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(row + j);
        v[i][j] = q.x;
        v[i][j + 1] = q.y;
        v[i][j + 2] = q.z;
        v[i][j + 3] = q.w;
      }
    }
    float o[3][DX];
#pragma unroll
    for (int dx = 0; dx < DX; ++dx) {
      const int cx = dx + R;
      const float m = v[2][cx];
      const float h1 = v[2][cx - 1] + v[2][cx + 1];
      const float v1 = v[1][cx] + v[3][cx];
      const float h2 = v[2][cx - 2] + v[2][cx + 2];
      const float v2 = v[0][cx] + v[4][cx];
      const float dg = (v[1][cx - 1] + v[1][cx + 1]) + (v[3][cx - 1] + v[3][cx + 1]);
      const float e = 0.125f;
      const bool r_row = dy == RY;         // compile-time after unrolling
      const bool r_col = (dx & 1) == RX;
      float r, g, b;
      if (r_row == r_col) {  // R or B site
        const float hv2 = h2 + v2;
        const float t_g = e * (4.0f * m + 2.0f * (h1 + v1) - hv2);
        const float t_opp = e * (6.0f * m + 2.0f * dg - 1.5f * hv2);
        g = t_g;
        r = r_row ? m : t_opp;
        b = r_row ? t_opp : m;
      } else {  // G site
        const float t_row = e * (5.0f * m + 4.0f * h1 - dg - h2 + 0.5f * v2);
        const float t_col = e * (5.0f * m + 4.0f * v1 - dg - v2 + 0.5f * h2);
        g = m;
        r = r_row ? t_row : t_col;
        b = r_row ? t_col : t_row;
      }
      if (has_mat) {
        r = fminf(fmaxf(r, 0.0f), 1.0f);
        g = fminf(fmaxf(g, 0.0f), 1.0f);
        b = fminf(fmaxf(b, 0.0f), 1.0f);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          o[c][dx] = fmaxf(mat.m[3 * c] * r + mat.m[3 * c + 1] * g + mat.m[3 * c + 2] * b, 0.0f);
      } else {
        o[0][dx] = r;
        o[1][dx] = g;
        o[2][dx] = b;
      }
    }
    float* dst = out + static_cast<size_t>(y + dy) * W + x;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (VEC) {
#pragma unroll
        for (int j = 0; j < DX; j += 4) store4(dst + c * plane + j, &o[c][j]);
      } else {
#pragma unroll
        for (int dx = 0; dx < DX; ++dx)
          if (x + dx < W) dst[c * plane + dx] = o[c][dx];
      }
    }
  }
}

template <typename T, bool VEC>
void launch_demosaic(const T* mosaic, float* out, int H, int W, int ry, int rx, int norm,
                     float black, float inv_range, int has_mat, const Mat9& m, cudaStream_t s) {
  const dim3 block(BX, BY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  switch (2 * ry + rx) {
    case 0:
      demosaic_kernel<T, VEC, 0, 0><<<grid, block, 0, s>>>(mosaic, out, H, W, norm, black, inv_range, has_mat, m);
      break;
    case 1:
      demosaic_kernel<T, VEC, 0, 1><<<grid, block, 0, s>>>(mosaic, out, H, W, norm, black, inv_range, has_mat, m);
      break;
    case 2:
      demosaic_kernel<T, VEC, 1, 0><<<grid, block, 0, s>>>(mosaic, out, H, W, norm, black, inv_range, has_mat, m);
      break;
    default:
      demosaic_kernel<T, VEC, 1, 1><<<grid, block, 0, s>>>(mosaic, out, H, W, norm, black, inv_range, has_mat, m);
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

constexpr int EXPO_THREADS = 256;

struct Expo {
  float black, inv_range, c0, c1, c2, e;
  int ry, rx;
};

__device__ __forceinline__ float unit(float p, const Expo& x) {
  return fminf(fmaxf(__fmul_rn(__fsub_rn(p, x.black), x.inv_range), 0.0f), 1.0f);
}

// The term of the cell (a0 a1 / b0 b1): rows 4i and 4i + 1, columns 4j and
// 4j + 1.
__device__ __forceinline__ double expo_term(float a0, float a1, float b0, float b1, const Expo& x) {
  a0 = unit(a0, x);
  a1 = unit(a1, x);
  b0 = unit(b0, x);
  b1 = unit(b1, x);
  const float r = x.ry ? (x.rx ? b1 : b0) : (x.rx ? a1 : a0);
  const float b = x.ry ? (x.rx ? a0 : a1) : (x.rx ? b0 : b1);
  const float g = x.ry == x.rx ? __fmul_rn(__fadd_rn(a1, b0), 0.5f) : b1;
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(x.c0, r), __fmul_rn(x.c1, g)), __fmul_rn(x.c2, b));
  return static_cast<double>(powf(fmaxf(y, 1e-9f), x.e));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// n_i x n_j samples; VEC: each item a 16-byte chunk of rows 4i and 4i + 1
// (CW / 4 samples), else one sample. partial[blockIdx.x]: the block's sum.
template <typename T, bool VEC>
__global__ void __launch_bounds__(EXPO_THREADS)
    exposure_sample_kernel(const T* __restrict__ mosaic, int W, int n_i, int n_j, Expo x,
                           double* __restrict__ partial) {
  constexpr int CW = 16 / sizeof(T);
  const unsigned n_c = VEC ? n_j / (CW / 4) : n_j;  // items along a sampled row pair
  const unsigned items = static_cast<unsigned>(n_i) * n_c;
  double acc = 0.0;
  for (unsigned t = blockIdx.x * EXPO_THREADS + threadIdx.x; t < items; t += gridDim.x * EXPO_THREADS) {
    const unsigned i = t / n_c;
    const unsigned c = t - i * n_c;
    const T* a = mosaic + static_cast<size_t>(4 * i) * W;
    if constexpr (VEC) {
      float va[CW], vb[CW];
      load16(a + c * CW, va);
      load16(a + W + c * CW, vb);
#pragma unroll
      for (int s = 0; s < CW; s += 4) acc += expo_term(va[s], va[s + 1], vb[s], vb[s + 1], x);
    } else {
      a += 4 * c;
      acc += expo_term(static_cast<float>(a[0]), static_cast<float>(a[1]),
                       static_cast<float>(a[W]), static_cast<float>(a[W + 1]), x);
    }
  }
  __shared__ double warps[EXPO_THREADS / 32];
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = warp_sum(lane < EXPO_THREADS / 32 ? warps[lane] : 0.0);
    if (lane == 0) partial[blockIdx.x] = acc;
  }
}

// One warp: work[0] = work[1] + ... + work[n], in a fixed order.
__global__ void exposure_total_kernel(double* work, int n) {
  double acc = 0.0;
  for (int k = threadIdx.x; k < n; k += 32) acc += work[1 + k];
  acc = warp_sum(acc);
  if (threadIdx.x == 0) work[0] = acc;
}

template <typename T, bool VEC>
void launch_exposure(const T* mosaic, int W, int n_i, int n_j, const Expo& x, double* work,
                     int blocks, cudaStream_t s) {
  exposure_sample_kernel<T, VEC><<<blocks, EXPO_THREADS, 0, s>>>(mosaic, W, n_i, n_j, x, work + 1);
  exposure_total_kernel<<<1, 32, 0, s>>>(work, blocks);
}

}  // namespace

// mosaic: (H, W) uint16 (is_u16=1) or float32, H, W >= 2; work: n_work + 1
// doubles on the device, work[0] the sum on return of the stream's work.
// (c0, c1, c2): the camera matrix's Y row; e: the power. vec: the 16-byte
// path, which takes W a multiple of 8 (u16) or 4 (f32) and a 16-byte
// aligned mosaic; 0: any shape.
R2F_API int r2f_exposure_sample(const void* mosaic, int is_u16, int H, int W, int ry, int rx,
                                float black, float inv_range, float c0, float c1, float c2,
                                float e, double* work, int n_work, int vec, void* stream) {
  const int n_i = (H / 2 + 1) / 2;
  const int n_j = (W / 2 + 1) / 2;
  if (H < 2 || W < 2 || n_work < 1 || ((ry | rx) & ~1) != 0 ||
      static_cast<long long>(n_i) * n_j > 0x7fffffffLL ||
      (vec && (W % (is_u16 ? 8 : 4) != 0 || (reinterpret_cast<uintptr_t>(mosaic) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Expo x{black, inv_range, c0, c1, c2, e, ry, rx};
  // items: 16-byte chunks of the sampled row pairs, or samples
  const long long items = static_cast<long long>(n_i) * (vec ? W / (is_u16 ? 8 : 4) : n_j);
  const long long wanted = (items + EXPO_THREADS - 1) / EXPO_THREADS;
  const int blocks = wanted < n_work ? static_cast<int>(wanted) : n_work;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u16) {
    const auto* src = static_cast<const uint16_t*>(mosaic);
    if (vec)
      launch_exposure<uint16_t, true>(src, W, n_i, n_j, x, work, blocks, s);
    else
      launch_exposure<uint16_t, false>(src, W, n_i, n_j, x, work, blocks, s);
  } else {
    const auto* src = static_cast<const float*>(mosaic);
    if (vec)
      launch_exposure<float, true>(src, W, n_i, n_j, x, work, blocks, s);
    else
      launch_exposure<float, false>(src, W, n_i, n_j, x, work, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// mat: 9 host floats, row-major, or null for the plain RGB output. vec: the
// 16-byte path, which takes W a multiple of 8 (u16) or 4 (f32) and a
// 16-byte aligned mosaic and out; 0: the general path, any shape.
R2F_API int r2f_demosaic(const void* mosaic, int is_u16, float* out, int H,
                         int W, int ry, int rx, int norm, float black,
                         float inv_range, const float* mat, int vec, void* stream) {
  if (H < 1 || W < 1 || ((ry | rx) & ~1) != 0 ||
      (vec && (W % (is_u16 ? 8 : 4) != 0 || (reinterpret_cast<uintptr_t>(mosaic) & 15) != 0 ||
               (reinterpret_cast<uintptr_t>(out) & 15) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Mat9 m{};
  const int has_mat = mat != nullptr;
  if (has_mat)
    for (int i = 0; i < 9; ++i) m.m[i] = mat[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u16) {
    const auto* src = static_cast<const uint16_t*>(mosaic);
    if (vec)
      launch_demosaic<uint16_t, true>(src, out, H, W, ry, rx, norm, black, inv_range, has_mat, m, s);
    else
      launch_demosaic<uint16_t, false>(src, out, H, W, ry, rx, norm, black, inv_range, has_mat, m, s);
  } else {
    const auto* src = static_cast<const float*>(mosaic);
    if (vec)
      launch_demosaic<float, true>(src, out, H, W, ry, rx, norm, black, inv_range, has_mat, m, s);
    else
      launch_demosaic<float, false>(src, out, H, W, ry, rx, norm, black, inv_range, has_mat, m, s);
  }
  return static_cast<int>(cudaGetLastError());
}

R2F_API const char* r2f_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
