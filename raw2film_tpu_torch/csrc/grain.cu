// K7, K8 and K9: the film-grain field alone, and film grain applied to a
// density image without the MTF.
//
// K7 grain_field replaces raw2film_tpu/ops/pallas_grain.py::grain_field_pallas
// (the correlated unit-variance field, C = 3 channels, or one for
// black-and-white grain, which the caller broadcasts):
//
//   out[c] = field_c,  z = c * 0x9E3779B9 + seed
//
// The TPU kernel's row0_offset on x is always 0 and is not carried over; the
// row offset rides on y, as in every other grain form.
//
// K8 grain_apply replaces raw2film_tpu/ops/pallas_grain.py::grain_apply_pallas
// (colour grain, one field per channel):
//
//   out[c] = max(d[c] + rms_eff * shape(d[c]) * field_c, 0),  z = c * 0x9E3779B9 + seed
//
// K9 grain_apply_bw replaces pallas_grain.py::grain_apply_bw_pallas (grain 1:
// one field shared by the three channels, the channel-mean amplitude):
//
//   g = rms_eff * (1/3) * (shape(d0) + shape(d1) + shape(d2)) * field,  z = seed
//   out[c] = max(d[c] + g, 0)
//
// field and shape are those of K2's grain epilogue (grain.cuh). The TPU pads
// H with edge rows to its tile; the hash depends only on position, so the
// padding changes nothing and these kernels serve every shape without it.
//
// Bound on the H100: device memory. K7 writes 4 bytes per output, K8 reads
// and writes 8; per output they compute about one hash (8 IMADs, 2 POPCs, 7
// ALU operations) and 2 n FMAs of correlation (n = 3 taps at 45 MP, 1 at
// the half-size default), K8 its amplitude (one SFU ex2) besides: about
// 0.13 ms of issue at 45 MP against 0.161 (K7) and 0.322 ms (K8) of bytes.
//
// Design (K7, K8): the tap count is compiled in where users run it.
// - 1 tap (white noise: the half-size default, sigma < 0.3 px): the field is
//   the noise, so the kernel is elementwise, with no shared memory and no
//   barrier. A warp takes a 128-column row piece, each lane a run of V = 4
//   columns, WHITE_R rows a warp.
// - 3 or 5 taps (full resolution): one block per (channel, 32 x 128 tile),
//   128 threads, at most 128 registers a thread. The block hashes its noise
//   window once into shared memory (16-byte stores, a lane's run of columns;
//   one barrier), and each thread then makes a run of TAPS_R = 8 rows x V =
//   4 columns in registers: it reads each window row once with 16-byte loads
//   into a ring of N rows, and runs the column pass and the row pass there
//   with the taps at compile-time indices. K8 loads its densities before the
//   hash, so their latency hides behind it. (8-warp blocks, 64 x 128 tiles
//   and 2 blocks an SM, made the 3-tap K7 7 % slower on the H100:
//   scripts/k7_k8_variants.py.)
// - Any other count (<= 31 taps) takes the general path: a 32 x 64 tile,
//   the noise window and its column pass in shared memory, then 8 outputs a
//   thread from the row pass.
// On the first two paths the 16-byte path (W % 4 == 0, every buffer 16-byte
// aligned: ops/grain.py::vec_path) loads and stores 16 bytes at a time, each
// warp access 512 contiguous bytes; otherwise a thread works value by value.
// The noise is S - 32 (grain_centred, no I2F), its factor 1/4 folded into
// the column pass's taps: (t / 4) m == t (m / 4) bit for bit. The launch
// struct is __grid_constant__, so no thread copies it. K8's amplitude runs
// its exponential on the SFU (shape_sfu), as K2's epilogue does.
//
// K9 keeps the general design with the library exponential.
#include "grain.cuh"

namespace {

using r2f::grain::Amp;
using r2f::grain::Args;

// The white-noise and compiled-tap paths.
constexpr int WARPS = 4;          // warps a block
constexpr int NT = 32 * WARPS;    // threads a block
constexpr int V = 4;              // consecutive columns a thread (a multiple of 4)
constexpr int TW = 32 * V;        // tile width: one warp across
constexpr int WHITE_R = 4;        // consecutive rows a warp, white noise
constexpr int TAPS_R = 8;         // consecutive rows a thread, compiled taps
static_assert(V % 4 == 0, "16-byte runs");

// The general path (and K9).
constexpr int GTW = 64;
constexpr int GTY = 4;
constexpr int GRPT = 8;
constexpr int GTH = GTY * GRPT;
constexpr int GNT = GTW * GTY;

// The window of the compiled-tap path: rows, the 16-byte loads a thread
// reads of a row (its V + N - 1 columns), and the row stride, a multiple of
// 4 that holds the tile's TW + N - 1 columns and lane 31's last load.
template <int N>
__host__ __device__ constexpr int win_rows() { return WARPS * TAPS_R + N - 1; }
template <int N>
__host__ __device__ constexpr int win_loads() { return (V + N - 1 + 3) / 4; }
template <int N>
__host__ __device__ constexpr int win_stride() {
  constexpr int tile = (TW + N - 1 + 3) & ~3;
  constexpr int last = 31 * V + 4 * win_loads<N>();
  return tile > last ? tile : last;
}
template <int N>
__host__ __device__ constexpr size_t win_bytes() { return sizeof(float) * win_rows<N>() * win_stride<N>(); }

// The V values of row p from column x (x < W). On the 16-byte path a run of
// 4 lies wholly inside the row or outside it (W % 4 == 0).
template <bool kVec>
__device__ __forceinline__ void load_run(const float* __restrict__ p, int x, int W, float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    if constexpr (kVec) {
      if (x + j < W) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p + x + j));
        v[j] = q.x;
        v[j + 1] = q.y;
        v[j + 2] = q.z;
        v[j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + j + e < W) v[j + e] = __ldg(p + x + j + e);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_run(float* __restrict__ p, int x, int W, const float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    if constexpr (kVec) {
      if (x + j < W)
        *reinterpret_cast<float4*>(p + x + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + j + e < W) p[x + j + e] = v[j + e];
    }
  }
}

// The centred noise S - 32 at the run's V columns (their LCG steps X) of
// one row (Y, Z and yz = Y * Z).
__device__ __forceinline__ void noise_run(const uint32_t (&X)[V], uint32_t Y, uint32_t Z,
                                          uint32_t yz, float (&m)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    uint32_t a, b;
    r2f::pcg3d_row(X[j], Y, Z, yz, a, b);
    m[j] = r2f::grain_centred(a, b);
  }
}

// K8's output from density v and field f: max(v + rms_eff shape(v) f, 0),
// the product fused with the add.
__device__ __forceinline__ float grained(float v, float f, const Amp& p) {
  return fmaxf(fmaf(p.rms_eff * r2f::grain::shape_sfu(v, p), f, v), 0.0f);
}

// White noise (1 tap): field = m / 4. K8 folds the 1/4 into rms_eff, which
// leaves its product with the shape unchanged bit for bit.
template <bool kApply, bool kVec>
__global__ void __launch_bounds__(NT)
    grain_white_kernel(const float* __restrict__ d, float* __restrict__ out, int H, int W,
                       const float* __restrict__ prm, uint32_t seed, uint32_t row_off) {
  const int x = blockIdx.x * TW + (threadIdx.x & 31) * V;
  if (x >= W) return;
  const int c = blockIdx.z;
  const int y0 = (blockIdx.y * WARPS + (threadIdx.x >> 5)) * WHITE_R;
  const size_t plane = static_cast<size_t>(H) * W;
  float dv[WHITE_R][V];
  Amp p{};
  if constexpr (kApply) {
#pragma unroll
    for (int k = 0; k < WHITE_R; ++k)
      if (y0 + k < H) load_run<kVec>(d + c * plane + static_cast<size_t>(y0 + k) * W, x, W, dv[k]);
    p = r2f::grain::load_amp(prm);
    p.rms_eff *= 0.25f;
  }
  const uint32_t Z = r2f::lcg(r2f::grain_z(c, seed));
  uint32_t X[V];
#pragma unroll
  for (int j = 0; j < V; ++j) X[j] = r2f::lcg(static_cast<uint32_t>(x + j));
#pragma unroll
  for (int k = 0; k < WHITE_R; ++k) {
    const int y = y0 + k;
    if (y >= H) break;
    const uint32_t Y = r2f::lcg(static_cast<uint32_t>(y) + row_off);
    float v[V];
    noise_run(X, Y, Z, Y * Z, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (kApply)
        v[j] = grained(dv[k][j], v[j], p);
      else
        v[j] *= 0.25f;
    }
    store_run<kVec>(out + c * plane + static_cast<size_t>(y) * W, x, W, v);
  }
}

// N taps compiled in (N odd, 3 <= N): the block's window, then a register
// run of TAPS_R x V outputs a thread.
template <int N, bool kApply, bool kVec>
__global__ void __launch_bounds__(NT, 512 / NT)
    grain_taps_kernel(const float* __restrict__ d, float* __restrict__ out, int H, int W,
                      const float* __restrict__ prm, const __grid_constant__ Args g) {
  constexpr int GH = win_rows<N>();
  constexpr int GS = win_stride<N>();
  constexpr int NL = win_loads<N>();
  constexpr int RW = V + N - 1;  // window columns a thread reads
  extern __shared__ float4 win4[];
  float* win = reinterpret_cast<float*>(win4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * (WARPS * TAPS_R);
  const int x = x0 + lane * V;       // the run's first column
  const int yt = y0 + warp * TAPS_R;  // and its first row
  const size_t plane = static_cast<size_t>(H) * W;

  float dv[TAPS_R][V];
  if constexpr (kApply) {
    if (x < W) {
#pragma unroll
      for (int r = 0; r < TAPS_R; ++r)
        if (yt + r < H) load_run<kVec>(d + c * plane + static_cast<size_t>(yt + r) * W, x, W, dv[r]);
    }
  }

  // The noise window: a warp a row, a lane its run of V columns (16-byte
  // stores); then the N - 1 columns right of the tile, from the block's
  // last threads (warps 0 and 1 hash the window's last rows).
  const uint32_t Z = r2f::lcg(r2f::grain_z(c, g.seed));
  {
    uint32_t X[V];
#pragma unroll
    for (int j = 0; j < V; ++j) X[j] = r2f::lcg(static_cast<uint32_t>(x + j));
#pragma unroll 1
    for (int ly = warp; ly < GH; ly += WARPS) {
      const uint32_t Y = r2f::lcg(static_cast<uint32_t>(y0 + ly) + g.row_off);
      float m[V];
      noise_run(X, Y, Z, Y * Z, m);
#pragma unroll
      for (int j = 0; j < V; j += 4)
        win4[(ly * GS + lane * V + j) / 4] = make_float4(m[j], m[j + 1], m[j + 2], m[j + 3]);
    }
    for (int i = NT - 1 - static_cast<int>(threadIdx.x); i < GH * (N - 1); i += NT) {
      const int ly = i / (N - 1);
      const int lx = TW + i - ly * (N - 1);
      const uint32_t Y = r2f::lcg(static_cast<uint32_t>(y0 + ly) + g.row_off);
      uint32_t a, b;
      r2f::pcg3d_row(r2f::lcg(static_cast<uint32_t>(x0 + lx)), Y, Z, Y * Z, a, b);
      win[ly * GS + lx] = r2f::grain_centred(a, b);
    }
  }
  __syncthreads();
  if (x >= W) return;

  float tc[N], tr[N];  // column taps with the noise's 1/4, row taps
#pragma unroll
  for (int q = 0; q < N; ++q) {
    tr[q] = g.taps[q];
    tc[q] = 0.25f * tr[q];
  }
  Amp p{};
  if constexpr (kApply) p = r2f::grain::load_amp(prm);
  const float* wb = win + warp * TAPS_R * GS + lane * V;
  float ring[N][RW];  // the last N window rows of the run's columns
#pragma unroll
  for (int k = 0; k < TAPS_R + N - 1; ++k) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float4 q = *reinterpret_cast<const float4*>(wb + k * GS + 4 * l);
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * l + i < RW) ring[k % N][4 * l + i] = e[i];
    }
    if (k < N - 1) continue;
    const int r = k - (N - 1);  // the output row of the run
    float cs[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      float s = tc[0] * ring[r % N][j];
#pragma unroll
      for (int q = 1; q < N; ++q) s = fmaf(tc[q], ring[(r + q) % N][j], s);
      cs[j] = s;
    }
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f = tr[0] * cs[j];
#pragma unroll
      for (int q = 1; q < N; ++q) f = fmaf(tr[q], cs[j + q], f);
      if constexpr (kApply)
        v[j] = grained(dv[r][j], f, p);
      else
        v[j] = f;
    }
    if (yt + r < H) store_run<kVec>(out + c * plane + static_cast<size_t>(yt + r) * W, x, W, v);
  }
}

__host__ __device__ __forceinline__ int smem_floats(int ntaps) {
  return r2f::grain::win_h(GTH, ntaps) * r2f::grain::win_w(GTW, ntaps) +
         GTH * r2f::grain::win_w(GTW, ntaps);
}

// Any tap count: the window and its column pass in shared memory, then 8
// outputs a thread from the row pass. kApply: K8, else K7.
template <bool kApply>
__global__ void __launch_bounds__(GNT)
    grain_general_kernel(const float* __restrict__ d, float* __restrict__ out, int H, int W,
                         const float* __restrict__ prm, const __grid_constant__ Args g) {
  extern __shared__ float smem[];
  float* win = smem;
  float* tmp = smem + r2f::grain::win_h(GTH, g.ntaps) * r2f::grain::win_w(GTW, g.ntaps);
  const int c = blockIdx.z;
  const int x0 = blockIdx.x * GTW;
  const int y0 = blockIdx.y * GTH;
  const int tid = threadIdx.y * GTW + threadIdx.x;
  r2f::grain::column_field(win, tmp, x0, y0, GTH, GTW, r2f::grain_z(c, g.seed), g, tid, GNT);
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  Amp p{};
  if constexpr (kApply) p = r2f::grain::load_amp(prm);
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int k = 0; k < GRPT; ++k) {
    const int row = threadIdx.y + GTY * k;
    const int y = y0 + row;
    if (y >= H) break;
    const size_t o = c * plane + static_cast<size_t>(y) * W + x;
    const float field = r2f::grain::row_field(tmp, row, threadIdx.x, GTW, g);
    if constexpr (kApply)
      out[o] = grained(d[o], field, p);
    else
      out[o] = field;
  }
}

__global__ void __launch_bounds__(GNT)
    grain_apply_bw_kernel(const float* __restrict__ d, float* __restrict__ out, int H,
                          int W, const float* __restrict__ prm, r2f::grain::Args g) {
  extern __shared__ float smem[];
  float* win = smem;
  float* tmp = smem + r2f::grain::win_h(GTH, g.ntaps) * r2f::grain::win_w(GTW, g.ntaps);
  const int x0 = blockIdx.x * GTW;
  const int y0 = blockIdx.y * GTH;
  const int tid = threadIdx.y * GTW + threadIdx.x;
  r2f::grain::column_field(win, tmp, x0, y0, GTH, GTW, r2f::grain_z(0, g.seed), g, tid, GNT);
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const r2f::grain::Amp p = r2f::grain::load_amp(prm);
  const float third = 1.0f / 3.0f;
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int k = 0; k < GRPT; ++k) {
    const int row = threadIdx.y + GTY * k;
    const int y = y0 + row;
    if (y >= H) break;
    const size_t o = static_cast<size_t>(y) * W + x;
    const float d0 = d[o], d1 = d[plane + o], d2 = d[2 * plane + o];
    const float field = r2f::grain::row_field(tmp, row, threadIdx.x, GTW, g);
    const float amp = p.rms_eff * third *
                      (r2f::grain::shape(d0, p) + r2f::grain::shape(d1, p) +
                       r2f::grain::shape(d2, p));
    const float gv = amp * field;
    out[o] = fmaxf(d0 + gv, 0.0f);
    out[plane + o] = fmaxf(d1 + gv, 0.0f);
    out[2 * plane + o] = fmaxf(d2 + gv, 0.0f);
  }
}

template <int N, bool kApply, bool kVec>
int launch_taps(const float* d, float* out, int C, int H, int W, const float* prm, const Args& g,
                cudaStream_t s) {
  const auto kernel = grain_taps_kernel<N, kApply, kVec>;
  constexpr size_t smem = win_bytes<N>();
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + TW - 1) / TW, (H + WARPS * TAPS_R - 1) / (WARPS * TAPS_R), C);
  kernel<<<grid, NT, smem, s>>>(d, out, H, W, prm, g);
  return static_cast<int>(cudaGetLastError());
}

// The K7 / K8 path for g.ntaps taps (ops/grain.py::grain_path mirrors the
// choice: 1 white, COMPILED_TAPS compiled, else general).
template <bool kApply>
int launch(const float* d, float* out, int C, int H, int W, const float* prm, const Args& g,
           int vec, cudaStream_t s) {
  if (g.ntaps == 1) {
    const dim3 grid((W + TW - 1) / TW, (H + WARPS * WHITE_R - 1) / (WARPS * WHITE_R), C);
    if (vec)
      grain_white_kernel<kApply, true><<<grid, NT, 0, s>>>(d, out, H, W, prm, g.seed, g.row_off);
    else
      grain_white_kernel<kApply, false><<<grid, NT, 0, s>>>(d, out, H, W, prm, g.seed, g.row_off);
    return static_cast<int>(cudaGetLastError());
  }
  // COMPILED_TAPS: 3 5
  if (g.ntaps == 3)
    return vec ? launch_taps<3, kApply, true>(d, out, C, H, W, prm, g, s)
               : launch_taps<3, kApply, false>(d, out, C, H, W, prm, g, s);
  if (g.ntaps == 5)
    return vec ? launch_taps<5, kApply, true>(d, out, C, H, W, prm, g, s)
               : launch_taps<5, kApply, false>(d, out, C, H, W, prm, g, s);
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(g.ntaps));
  const dim3 grid((W + GTW - 1) / GTW, (H + GTH - 1) / GTH, C);
  grain_general_kernel<kApply><<<grid, dim3(GTW, GTY), smem, s>>>(d, out, H, W, prm, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d, out: (C, H, W) float32 (bw: C = 3). prm: 6 device floats [rms_eff,
// floor, peak_half, inv_width, lo, inv_rng]; taps: n host floats (n <= 31).
// vec: the 16-byte path (W % 4 == 0, d and out 16-byte aligned; not read by
// K9).
R2F_API int r2f_grain_apply(const float* d, float* out, int C, int H, int W, int bw,
                            unsigned int seed, unsigned int row_off, const float* prm,
                            const float* taps, int n, int vec, void* stream) {
  r2f::grain::Args g{};
  const int e = r2f::grain::make_args(g, seed, row_off, taps, n);
  if (e != 0) return e;
  if ((bw && C != 3) || (vec && W % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bw) return launch<true>(d, out, C, H, W, prm, g, vec, s);
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(n));
  const dim3 grid((W + GTW - 1) / GTW, (H + GTH - 1) / GTH, 1);
  grain_apply_bw_kernel<<<grid, dim3(GTW, GTY), smem, s>>>(d, out, H, W, prm, g);
  return static_cast<int>(cudaGetLastError());
}

// out: (C, H, W) float32, channel c salted with c * 0x9E3779B9 (C = 1 for
// black-and-white grain); taps: n host floats (n <= 31); vec: the 16-byte
// path (W % 4 == 0, out 16-byte aligned).
R2F_API int r2f_grain_field(float* out, int C, int H, int W, unsigned int seed,
                            unsigned int row_off, const float* taps, int n, int vec,
                            void* stream) {
  r2f::grain::Args g{};
  const int e = r2f::grain::make_args(g, seed, row_off, taps, n);
  if (e != 0) return e;
  if (vec && W % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(nullptr, out, C, H, W, nullptr, g, vec, static_cast<cudaStream_t>(stream));
}
