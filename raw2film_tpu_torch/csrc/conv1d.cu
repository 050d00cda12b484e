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
// The taps come packed by ops/sep_conv.py::pack (Taps, by value): the span
// of the nonzero taps, at window offset `off` from the output (off = the
// first kept tap's index - r), so the kernels compute
//
//   out[i] = sum_{q < n, t[q] != 0} t[q] in[refl(i + off + q)]
//
// in ascending q. K5's pack also moves `off` down to a multiple of 4 with
// leading zero taps and pads n to a multiple of 8 with trailing ones, which
// the zero skip passes over. Each sum starts from -0.0f: -0 + x is x for
// every x, so the first term stands alone as in the plain version; with no
// tap left (all zero) the output is +0, as the plain version's zeros. A
// vector above MAX_TAPS comes from a device buffer (`buf`, uploaded once per
// distinct vector by the wrapper) instead of the struct.
//
// Bound on the H100: device memory, 8 bytes per output (one read, one
// write) against 2 n FLOPs; bit-equality forbids the FMA, so an output
// issues 2 n fp32 instructions (46 at the MTF's 23 taps, about 0.19 ms at
// 45 MP). The design keeps both the loads and the tap reads per output far
// below n:
// - K6 (along H): a block of H_WY warps takes a strip of 128 columns and
//   walks H_T tiles of H_TR rows down it. Per (tile, chunk of H_CH taps) it
//   stages the window of H_TR + len - 1 rows in shared memory by cp.async
//   (16 bytes a lane where W % 4 == 0 and both buffers are 16-byte aligned,
//   a warp copying 512 contiguous bytes of a row; else 4 bytes), the next
//   stage in flight while this one is used. A lane owns a quad of columns,
//   a warp a run of H_R rows; it walks its window rows once, in ascending
//   order, H_R taps a group: it holds the group's first H_R rows and reads
//   the next H_R from shared memory before the group's arithmetic, which
//   adds first every term on the rows held, then those on the rows read, so
//   every output still gets its terms in ascending q. The tap and its zero
//   test are uniform across the block. A row comes from L2 (H_TR + n - 1) /
//   H_TR times, not (H_R + n - 1) / H_R.
// - K5 (along W): a block of 128 threads stages W_TH rows x (W_TW + chunk)
//   columns in shared memory by cp.async, the reflect-101 halo filled while
//   staging at the row's two ends (16-byte copies inside the row where W %
//   4 == 0 and the input is aligned, else 4-byte ones), one chunk of W_CH
//   taps at a time, so any n fits. A block walks W_T row tiles, two
//   buffers: it stages the next (tile, chunk) while it computes this one.
//   Each thread makes a run of W_Y rows x W_V = 4 columns: per 8 taps it
//   reads its window of W_V + 8 columns with 16-byte shared loads, and adds
//   the 8 taps (each read once for its W_Y rows) in ascending order; it
//   stores 16 bytes a row.
// The TPU pads H to its tile and drops to XLA on small images; these
// kernels serve every shape.
#include "common.cuh"

namespace r2f {
namespace conv1d {

constexpr int MAX_TAPS = 256;  // floats of taps passed by value

// One launch's packed taps (ops/sep_conv.py::Taps): the window offset of
// t[0] from the output, the count, the taps (the first n used).
struct Taps {
  int off;
  int n;
  float t[MAX_TAPS];
};
static_assert(sizeof(Taps) == 8 + 4 * MAX_TAPS, "Taps: the layout ops/sep_conv.py packs");

}  // namespace conv1d
}  // namespace r2f

namespace {

using r2f::conv1d::Taps;

// K6: a quad of columns a thread (H_V), H_R rows a run (and taps a group),
// H_WY warps a block stacked along H: a tile of H_TR rows x H_SW columns;
// H_CH taps a stage (a multiple of H_R), H_T tiles a block.
constexpr int H_V = 4;
constexpr int H_R = 8;
constexpr int H_WY = 8;
constexpr int H_CH = 32;
constexpr int H_T = 4;
constexpr int H_TR = H_WY * H_R;
constexpr int H_SW = 32 * H_V;
constexpr int H_SR = H_TR + H_CH - 1;  // window rows a stage, at most
constexpr int H_SMEM = 2 * H_SR * H_SW * 4;  // two windows: dynamic shared memory
static_assert(H_V == 4, "one 16-byte quad a lane");
static_assert(H_CH % H_R == 0, "chunks of whole groups of H_R taps");
// K5: W_TX x W_TY threads, each W_V columns x W_Y rows; W_CH taps a
// staged chunk (a multiple of 8). (Other values: scripts/k5_k6_variants.py.)
constexpr int W_V = 4;
constexpr int W_TX = 64;
constexpr int W_TY = 2;
constexpr int W_Y = 2;
constexpr int W_CH = 32;
constexpr int W_T = 4;  // row tiles a block walks, one stage staged ahead
constexpr int W_TW = W_TX * W_V;
constexpr int W_TH = W_TY * W_Y;
constexpr int W_SW = W_TW + W_CH;
constexpr int W_SQ = (W_SW / 4 + W_TX - 1) / W_TX;  // quads a thread stages a row, at most
static_assert(W_TH % W_TY == 0, "whole rows a thread stages");
static_assert(W_V % 4 == 0, "whole 16-byte quads a thread");
static_assert(W_CH % 8 == 0, "chunks of whole groups of 8 taps");

template <bool BUF>
__device__ __forceinline__ float tap(const Taps& tp, const float* __restrict__ buf, int q) {
  return BUF ? __ldg(buf + q) : tp.t[q];
}

// A row of the staged window at the thread's quad of columns.
__device__ __forceinline__ void load_quad(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// One group of H_R taps from qb (of a chunk of len taps from q0): load
// window rows lb + qb + H_R + j into b (those a later step reads: j < len -
// qb - 1; the rest 0), then step s adds t[q0 + qb + s] times row k + s (a,
// or b past H_R) to accumulator k: first every term on a, then every term
// on b (each accumulator still takes its taps in ascending order).
template <bool BUF>
__device__ __forceinline__ void tap_group(float (&acc)[H_R][H_V], const float (&a)[H_R][H_V],
                                          float (&b)[H_R][H_V], const float* win, int qb, int len,
                                          int q0, const Taps& tp, const float* __restrict__ buf) {
#pragma unroll
  for (int j = 0; j < H_R; ++j) {
    if (j < len - qb - 1) {
      load_quad(win + (qb + H_R + j) * H_SW, b[j]);
    } else {
#pragma unroll
      for (int i = 0; i < H_V; ++i) b[j][i] = 0.0f;
    }
  }
  float t[H_R];
#pragma unroll
  for (int s = 0; s < H_R; ++s) t[s] = qb + s < len ? tap<BUF>(tp, buf, q0 + qb + s) : 0.0f;
#pragma unroll
  for (int s = 0; s < H_R; ++s)
    if (t[s] != 0.0f)
#pragma unroll
      for (int k = 0; k < H_R - s; ++k)
#pragma unroll
        for (int i = 0; i < H_V; ++i) acc[k][i] = __fadd_rn(acc[k][i], __fmul_rn(t[s], a[k + s][i]));
#pragma unroll
  for (int s = 1; s < H_R; ++s)
    if (t[s] != 0.0f)
#pragma unroll
      for (int k = H_R - s; k < H_R; ++k)
#pragma unroll
        for (int i = 0; i < H_V; ++i)
          acc[k][i] = __fadd_rn(acc[k][i], __fmul_rn(t[s], b[k + s - H_R][i]));
}

// One stage of K6: window rows r < rows of the tile (image rows y + r,
// reflect-101) at the block's 128 columns from xt into `win` (H_SW floats a
// row), by cp.async: 16 bytes a lane where its quad lies inside the row
// (VEC), else 4 values (columns past W read column W - 1; nothing stores
// them).
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* win, const float* __restrict__ src, int y,
                                           int rows, int xt, int H, int W) {
  const int x = xt + 4 * static_cast<int>(threadIdx.x);
  for (int r = threadIdx.y; r < rows; r += H_WY) {
    const float* row = src + static_cast<size_t>(r2f::reflect101(y + r, H)) * W;
    float* dst = win + r * H_SW + 4 * threadIdx.x;
    if (VEC) {
      if (x < W) r2f::cp_async16(dst, row + x);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) r2f::cp_async4(dst + e, row + min(x + e, W - 1));
    }
  }
}

template <bool VEC, bool BUF>
__global__ void __launch_bounds__(32 * H_WY)
    conv_h_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                  const __grid_constant__ Taps tp, const float* __restrict__ buf) {
  extern __shared__ __align__(16) float sm[];  // two windows of H_SR x H_SW
  const int xt = blockIdx.x * H_SW;
  const int x = xt + 4 * static_cast<int>(threadIdx.x);
  const int y0 = blockIdx.y * (H_TR * H_T);
  const int ntile = min(H_T, (H - y0 + H_TR - 1) / H_TR);
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  const float* src = img + plane;
  const int n = tp.n;
  const int nch = (n + H_CH - 1) / H_CH;  // chunks a tile
  const int stages = ntile * nch;  // (tile, chunk) pairs, in order
  const int lb = threadIdx.y * H_R;  // the warp's run: window rows lb + ...
  const float init = n > 0 ? -0.0f : 0.0f;
  float acc[H_R][H_V], ra[H_R][H_V], rb[H_R][H_V];
#pragma unroll
  for (int k = 0; k < H_R; ++k)
#pragma unroll
    for (int i = 0; i < H_V; ++i) acc[k][i] = init;
  if (stages > 0) stage_rows<VEC>(sm, src, y0 + tp.off, H_TR + min(H_CH, n) - 1, xt, H, W);
  r2f::cp_async_commit();
  for (int si = 0, ti = 0, ch = 0; ti < ntile; ++si) {
    // stage si + 1 into the other window while this one is used
    const int ti1 = ch + 1 < nch ? ti : ti + 1, ch1 = ch + 1 < nch ? ch + 1 : 0;
    if (si + 1 < stages) {
      const int q1 = ch1 * H_CH;
      stage_rows<VEC>(sm + ((si + 1) & 1) * (H_SR * H_SW), src, y0 + ti1 * H_TR + tp.off + q1,
                      H_TR + min(H_CH, n - q1) - 1, xt, H, W);
    }
    r2f::cp_async_commit();
    r2f::cp_async_wait<1>();  // every group but the newest: stage si is in
    __syncthreads();
    if (stages > 0) {
      const int q0 = ch * H_CH, len = min(H_CH, n - q0);
      const float* win = sm + (si & 1) * (H_SR * H_SW) + lb * H_SW + 4 * threadIdx.x;
#pragma unroll
      for (int k = 0; k < H_R; ++k) load_quad(win + k * H_SW, ra[k]);
      for (int qb = 0; qb < len; qb += 2 * H_R) {
        tap_group<BUF>(acc, ra, rb, win, qb, len, q0, tp, buf);
        if (qb + H_R >= len) break;
        tap_group<BUF>(acc, rb, ra, win, qb + H_R, len, q0, tp, buf);
      }
    }
    if (ch + 1 >= nch) {  // the tile's last chunk: store its run, start the next
      const int yr = y0 + ti * H_TR + lb;
#pragma unroll
      for (int k = 0; k < H_R; ++k) {
        if (x < W && yr + k < H) {
          float* o = out + plane + static_cast<size_t>(yr + k) * W + x;
          if (VEC) {
            *reinterpret_cast<float4*>(o) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
          } else {
#pragma unroll
            for (int i = 0; i < H_V; ++i)
              if (x + i < W) o[i] = acc[k][i];
          }
        }
#pragma unroll
        for (int i = 0; i < H_V; ++i) acc[k][i] = init;
      }
    }
    ti = stages > 0 ? ti1 : ti + 1;
    ch = stages > 0 ? ch1 : 0;
    __syncthreads();  // window si & 1 is free for stage si + 2
  }
}

// One stage of K5: tile rows yt .. yt + W_TH - 1 (past H: the last row) at
// image columns g0 .. g0 + 4 quads - 1 into `tile`, by cp.async: 16 bytes
// where the quad lies inside the row (VEC), else 4 values by reflect-101.
template <bool VEC>
__device__ __forceinline__ void stage(float (*tile)[W_SW], const float* __restrict__ src, int yt,
                                      int g0, int quads, int H, int W) {
#pragma unroll
  for (int i = 0; i < W_TH / W_TY; ++i) {
    const int r = threadIdx.y + i * W_TY;
    const float* row = src + static_cast<size_t>(min(yt + r, H - 1)) * W;
#pragma unroll
    for (int j = 0; j < W_SQ; ++j) {
      const int c = threadIdx.x + j * W_TX;
      if (c >= quads) continue;
      const int g = g0 + 4 * c;
      if (VEC && g >= 0 && g + 4 <= W) {
        r2f::cp_async16(&tile[r][4 * c], row + g);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) r2f::cp_async4(&tile[r][4 * c + e], row + r2f::reflect101(g + e, W));
      }
    }
  }
}

template <bool VEC, bool BUF>
__global__ void __launch_bounds__(W_TX * W_TY)
    conv_w_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W,
                  const __grid_constant__ Taps tp, const float* __restrict__ buf) {
  __shared__ __align__(16) float tile[2][W_TH][W_SW];
  const int xt = blockIdx.x * W_TW;
  const int y0 = blockIdx.y * (W_TH * W_T);
  const int ntile = min(W_T, (H - y0 + W_TH - 1) / W_TH);
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  const float* src = img + plane;
  const int n = tp.n;
  const int xl = threadIdx.x * W_V;  // the thread's first column in the tile
  const int yl = threadIdx.y * W_Y;  // and its first row
  const int x = xt + xl;
  const int nch = (n + W_CH - 1) / W_CH;  // chunks a tile
  const int stages = ntile * nch;  // (tile, chunk) pairs, in order
  const float init = n > 0 ? -0.0f : 0.0f;
  float acc[W_Y][W_V];
#pragma unroll
  for (int y = 0; y < W_Y; ++y)
#pragma unroll
    for (int k = 0; k < W_V; ++k) acc[y][k] = init;
  if (stages > 0) stage<VEC>(tile[0], src, y0, xt + tp.off, (W_TW + min(W_CH, n)) / 4, H, W);
  r2f::cp_async_commit();
  for (int si = 0, ti = 0, ch = 0; ti < ntile; ++si) {
    // stage si + 1 into the other buffer while this one is used
    const int ti1 = ch + 1 < nch ? ti : ti + 1, ch1 = ch + 1 < nch ? ch + 1 : 0;
    if (si + 1 < stages) {
      const int q1 = ch1 * W_CH;
      stage<VEC>(tile[(si + 1) & 1], src, y0 + ti1 * W_TH, xt + tp.off + q1,
                 (W_TW + min(W_CH, n - q1)) / 4, H, W);
    }
    r2f::cp_async_commit();
    r2f::cp_async_wait<1>();  // every group but the newest: stage si is in
    __syncthreads();
    if (stages > 0) {
      const int q0 = ch * W_CH, len = min(W_CH, n - q0);
      const float(*tl)[W_SW] = tile[si & 1];
      for (int qb = 0; qb < len; qb += 8) {
        float win[W_Y][W_V + 8];
#pragma unroll
        for (int y = 0; y < W_Y; ++y)
#pragma unroll
          for (int j = 0; j < W_V / 4 + 2; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(&tl[yl + y][xl + qb + 4 * j]);
            win[y][4 * j] = v.x;
            win[y][4 * j + 1] = v.y;
            win[y][4 * j + 2] = v.z;
            win[y][4 * j + 3] = v.w;
          }
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const float t = tap<BUF>(tp, buf, q0 + qb + s);
          if (t != 0.0f) {
#pragma unroll
            for (int y = 0; y < W_Y; ++y)
#pragma unroll
              for (int k = 0; k < W_V; ++k)
                acc[y][k] = __fadd_rn(acc[y][k], __fmul_rn(t, win[y][k + s]));
          }
        }
      }
    }
    if (ch + 1 >= nch && x < W) {  // the tile's last chunk: store its run, start the next
#pragma unroll
      for (int y = 0; y < W_Y; ++y) {
        const int yy = y0 + ti * W_TH + yl + y;
        if (yy >= H) break;
        float* o = out + plane + static_cast<size_t>(yy) * W + x;
        if (VEC) {
#pragma unroll
          for (int j = 0; j < W_V / 4; ++j)
            if (j == 0 || x + 4 * j < W)
              reinterpret_cast<float4*>(o)[j] =
                  make_float4(acc[y][4 * j], acc[y][4 * j + 1], acc[y][4 * j + 2], acc[y][4 * j + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < W_V; ++k)
            if (x + k < W) o[k] = acc[y][k];
        }
      }
    }
    if (ch + 1 >= nch) {
#pragma unroll
      for (int y = 0; y < W_Y; ++y)
#pragma unroll
        for (int k = 0; k < W_V; ++k) acc[y][k] = init;
    }
    ti = stages > 0 ? ti1 : ti + 1;
    ch = stages > 0 ? ch1 : 0;
    __syncthreads();  // tile[si & 1] is free for stage si + 2
  }
}

template <bool VEC, bool BUF>
cudaError_t launch(const float* img, float* out, int C, int H, int W, const Taps& tp,
                   const float* buf, int axis, cudaStream_t s) {
  if (axis == 0) {
    const dim3 grid((W + W_TW - 1) / W_TW, (H + W_TH * W_T - 1) / (W_TH * W_T), C);
    conv_w_kernel<VEC, BUF><<<grid, dim3(W_TX, W_TY), 0, s>>>(img, out, H, W, tp, buf);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        conv_h_kernel<VEC, BUF>, cudaFuncAttributeMaxDynamicSharedMemorySize, H_SMEM);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((W + H_SW - 1) / H_SW, (H + H_TR * H_T - 1) / (H_TR * H_T), C);
    conv_h_kernel<VEC, BUF><<<grid, dim3(32, H_WY), H_SMEM, s>>>(img, out, H, W, tp, buf);
  }
  return cudaSuccess;
}

}  // namespace

// img, out: (C, H, W) float32; taps: the host's packed Taps (ops/sep_conv.py
// ::pack; for K5 off a multiple of 4 and n of 8); buf: its n taps on the
// device when n > MAX_TAPS, else null. axis 0: along W (K5), 1: along H
// (K6). vec: the 16-byte path (W % 4 == 0, img and out 16-byte aligned).
R2F_API int r2f_conv1d(const float* img, float* out, int C, int H, int W, const Taps* taps,
                       const float* buf, int axis, int vec, void* stream) {
  const Taps& tp = *taps;
  const int rows = axis == 0 ? W_TH * W_T : H_TR * H_T;
  if (C < 1 || H < 1 || W < 1 || C > 65535 || (H + rows - 1) / rows > 65535 || tp.n < 0 ||
      (tp.n > r2f::conv1d::MAX_TAPS) != (buf != nullptr) || (vec && W % 4 != 0) ||
      (axis == 0 && (tp.off % 4 != 0 || tp.n % 8 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = vec ? (buf ? launch<true, true>(img, out, C, H, W, tp, buf, axis, s)
                                   : launch<true, false>(img, out, C, H, W, tp, buf, axis, s))
                            : (buf ? launch<false, true>(img, out, C, H, W, tp, buf, axis, s)
                                   : launch<false, false>(img, out, C, H, W, tp, buf, axis, s));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
