// K16: the development, exposure to status density, in one pass.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the develop section of
// raw2film_tpu/pipeline/render.py:264-277 (jnp code) into one elementwise
// pass; eager PyTorch launched each of its ~130 operations on its own,
// writing and reading back every intermediate plane. Per pixel, with e_c
// the (3, H, W) exposure's three channels:
//
//   x_c  = log10(max(e_c + flare, 1e-6))
//   hd_c = cdmin_c + gamma_c (softplus(x_c - x_toe_c, w_toe_c)
//                             - softplus(x_c - x_sh_c, w_sh_c))
//   d_i  = dmin_i + sum_j mask_ij (hd_j - dmin_j)
//
// cdmin is the H&D curve's base density and dmin the bundle's (the same
// values in every bundle the port builds, kept apart as the plain version
// keeps them). The parameters come from the host by value: the 31 floats of
// the bundle's develop_host (ops/develop.py::PARAMS), folded here once per
// launch into the base-2 factors of K14's epilogue (common.cuh's fold_curve2
// and softplus2): t = log2(e + flare) k1 + k0 is one FMA, and the softplus
// term is g softplus2(t), g = gamma w ln(2). So a launch copies nothing to or
// from the device, and the FMAs read the factors from the parameter bank.
//
// Bound on the H100: device memory. 24 bytes a pixel (three floats read,
// three written): 0.322 ms at 45 MP at 3.35 TB/s. The arithmetic is 5 SFU
// operations (lg2, and ex2 + lg2 twice) and ~20 FMA-pipe operations a value:
// ~0.17 ms of the SFU's time at 45 MP, hidden under the bytes.
//
// Design: a grid-stride streaming pass, sized to the card (its SMs times
// the blocks of this kernel an SM holds, asked once per device). Each plane
// is H * W contiguous floats, so the pass runs over the flat plane, not by
// rows: on the 16-byte path (H * W % 4 == 0 and both buffers 16-byte
// aligned, as the entry point finds them) a thread takes 4 pixels an
// iteration, one 16-byte load and store on each plane; elsewhere (H * W odd
// or not a multiple of 4, W = 1, H = 1, an unaligned view) one pixel, 4-byte
// accesses, still coalesced. No shared memory: nothing is reused.
#include <atomic>

#include "common.cuh"

namespace r2f {
namespace dev {

constexpr int NT = 256;         // threads a block
constexpr int PARAMS = 31;      // the host vector: ops/develop.py::PARAMS
constexpr int MAX_DEVICES = 64;  // devices whose grid size is kept

// K16's launch, passed by value (__grid_constant__): the plane's length and
// the folded parameters.
struct Args {
  long long n;  // H * W
  float flare;
  r2f::Curve2 curve[3];  // common.cuh's fold_curve2
  float base[3];         // cdmin - dmin
  float dmin[3];
  float mask[9];
};

}  // namespace dev
}  // namespace r2f

namespace {

using r2f::dev::Args;
using r2f::dev::NT;

// hd_c - dmin_c of exposure e in channel c
__device__ __forceinline__ float curve(const Args& a, int c, float e) {
  const r2f::Curve2& k = a.curve[c];
  const float l2 = r2f::lg2_sfu(fmaxf(e + a.flare, 1e-6f));
  return a.base[c] + k.g_t * r2f::softplus2(fmaf(l2, k.k1_t, k.k0_t)) -
         k.g_s * r2f::softplus2(fmaf(l2, k.k1_s, k.k0_s));
}

// the three densities of one pixel, in place
__device__ __forceinline__ void develop3(const Args& a, float& e0, float& e1, float& e2) {
  const float q0 = curve(a, 0, e0), q1 = curve(a, 1, e1), q2 = curve(a, 2, e2);
  e0 = a.dmin[0] + (a.mask[0] * q0 + a.mask[1] * q1 + a.mask[2] * q2);
  e1 = a.dmin[1] + (a.mask[3] * q0 + a.mask[4] * q1 + a.mask[5] * q2);
  e2 = a.dmin[2] + (a.mask[6] * q0 + a.mask[7] * q1 + a.mask[8] * q2);
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
    develop_kernel(const float* __restrict__ ep, float* __restrict__ out, const __grid_constant__ Args a) {
  const size_t stride = static_cast<size_t>(gridDim.x) * NT;
  size_t i = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  if constexpr (VEC) {
    const size_t n4 = static_cast<size_t>(a.n) / 4;
    const float4* src = reinterpret_cast<const float4*>(ep);
    float4* dst = reinterpret_cast<float4*>(out);
    for (; i < n4; i += stride) {
      float4 p0 = src[i], p1 = src[n4 + i], p2 = src[2 * n4 + i];
      develop3(a, p0.x, p1.x, p2.x);
      develop3(a, p0.y, p1.y, p2.y);
      develop3(a, p0.z, p1.z, p2.z);
      develop3(a, p0.w, p1.w, p2.w);
      dst[i] = p0;
      dst[n4 + i] = p1;
      dst[2 * n4 + i] = p2;
    }
  } else {
    const size_t n = static_cast<size_t>(a.n);
    for (; i < n; i += stride) {
      float e0 = ep[i], e1 = ep[n + i], e2 = ep[2 * n + i];
      develop3(a, e0, e1, e2);
      out[i] = e0;
      out[n + i] = e1;
      out[2 * n + i] = e2;
    }
  }
}

// The blocks that fill the current device: its SMs times the blocks of the
// kernel one SM holds, asked once per device. Returns a CUDA error code.
template <bool VEC>
int resident_blocks(int& blocks) {
  static std::atomic<int> kept[r2f::dev::MAX_DEVICES];
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (d < r2f::dev::MAX_DEVICES && (blocks = kept[d].load(std::memory_order_relaxed)) > 0) return 0;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, d);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, develop_kernel<VEC>, NT, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  blocks = sms * per_sm;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (d < r2f::dev::MAX_DEVICES) kept[d].store(blocks, std::memory_order_relaxed);
  return 0;
}

template <bool VEC>
int launch(const float* ep, float* out, const Args& a, cudaStream_t stream) {
  int resident = 0;
  const int e = resident_blocks<VEC>(resident);
  if (e != 0) return e;
  const long long items = VEC ? a.n / 4 : a.n;
  const long long need = (items + NT - 1) / NT;
  const int grid = static_cast<int>(need < resident ? need : resident);
  develop_kernel<VEC><<<grid, NT, 0, stream>>>(ep, out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ep, out: (3, H, W) float32 on the device; params: the host vector of
// r2f::dev::PARAMS floats [flare, cdmin*3, gamma*3, x_toe*3, x_shoulder*3,
// w_toe*3, w_shoulder*3, dmin*3, mask*9 (row-major)], read here and passed
// by value. The 16-byte path where H * W % 4 == 0 and both buffers are
// 16-byte aligned, else the 4-byte one.
R2F_API int r2f_develop(const float* ep, float* out, const float* params, int H, int W, void* stream) {
  if (H < 1 || W < 1 || params == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = params;
  Args a;
  a.n = static_cast<long long>(H) * W;
  a.flare = p[0];
  for (int c = 0; c < 3; ++c) {
    a.curve[c] = r2f::fold_curve2(p, c);
    a.base[c] = p[1 + c] - p[19 + c];
    a.dmin[c] = p[19 + c];
  }
  for (int k = 0; k < 9; ++k) a.mask[k] = p[22 + k];
  const bool vec = a.n % 4 == 0 && reinterpret_cast<uintptr_t>(ep) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(ep, out, a, s) : launch<false>(ep, out, a, s);
}
