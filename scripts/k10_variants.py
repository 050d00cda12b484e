"""Variants of K10's 16-byte path (the /4 box downsample,
``csrc/pyramid.cu::box_downsample_slots_kernel``) timed on one NVIDIA GPU
at the 45 MP frame, each in turns with ``F.avg_pool2d``.

    python3 scripts/k10_variants.py

Builds its own small library from the source below (one ``nvcc``, a few
seconds): one kernel template over the outputs per lane (RUN), the output
rows per warp (ROWS), the load (0 ``__ldcs``; 1 ``__ldg``; 2
``ld.global.nc`` with no L1 allocation and a 256-byte L2 prefetch; 3 the
same without the prefetch; 4 ``ld.global`` with no L1 allocation) and the
block shape; the first variants come again at the end, for the spread. Each
variant is checked against ``F.avg_pool2d`` (1e-6), then timed in turns
with it (kernel, call, kernel, call: 20 turns of 5 calls each, CUDA events
around each turn). Prints the card's name and power limit first, and the
bytes each variant moves over its time. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

H, W = 5472, 8208

SOURCE = r"""
#include <cuda_runtime.h>

template <int LOAD>
__device__ __forceinline__ float4 load(const float* p) {
  if constexpr (LOAD == 0) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  } else if constexpr (LOAD == 1) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else if constexpr (LOAD == 2) {
    float4 v;
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  } else if constexpr (LOAD == 3) {
    float4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  } else {
    float4 v;
    asm volatile("ld.global.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  }
}

// f = 4: a warp makes 32 RUN consecutive outputs of ROWS output rows; lane
// l reads 16-byte slots l + 32 k of each input row (k < RUN).
template <int RUN, int ROWS, int LOAD>
__global__ void __launch_bounds__(256)
    slots(const float* __restrict__ img, float* __restrict__ out, int H, int W, int h2, int w2,
          float inv) {
  const int lane = threadIdx.x & 31;
  const int xb = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32 * RUN;
  const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * ROWS;
  const int c = blockIdx.z;
  if (xb >= w2) return;
  float4 col[ROWS][RUN];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int y = min(y0 + r, h2 - 1);
    const float* src = img + static_cast<size_t>(c) * H * W + static_cast<size_t>(y) * 4 * W +
                       static_cast<size_t>(xb) * 4;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const int s = min(lane + 32 * k, w2 - 1 - xb);
      const float* p = src + 4 * s;
      col[r][k] = load<LOAD>(p);
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        const float4 b = load<LOAD>(p + static_cast<size_t>(i) * W);
        col[r][k].x += b.x;
        col[r][k].y += b.y;
        col[r][k].z += b.z;
        col[r][k].w += b.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int y = y0 + r;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const int s = lane + 32 * k;
      float t = col[r][k].x;
      t += col[r][k].y;
      t += col[r][k].z;
      t += col[r][k].w;
      if (y < h2 && xb + s < w2) out[(static_cast<size_t>(c) * h2 + y) * w2 + xb + s] = t * inv;
    }
  }
}

template <int RUN, int ROWS, int LOAD>
int run(const float* img, float* out, int C, int H, int W, int bx, int by) {
  const int h2 = H / 4, w2 = W / 4;
  const int per_block_x = bx / 32 * 32 * RUN;
  const dim3 grid((w2 + per_block_x - 1) / per_block_x, (h2 + by * ROWS - 1) / (by * ROWS), C);
  slots<RUN, ROWS, LOAD><<<grid, dim3(bx, by)>>>(img, out, H, W, h2, w2, 1.0f / 16.0f);
  return static_cast<int>(cudaGetLastError());
}

#define VARIANT(RUN, ROWS, LOAD)                                                            \
  extern "C" int v_##RUN##_##ROWS##_##LOAD(const float* i, float* o, int C, int H, int W,  \
                                           int bx, int by) {                               \
    return run<RUN, ROWS, LOAD>(i, o, C, H, W, bx, by);                                    \
  }
VARIANT(2, 1, 0)
VARIANT(2, 1, 1)
VARIANT(2, 1, 2)
VARIANT(2, 1, 3)
VARIANT(2, 1, 4)
VARIANT(1, 1, 0)
VARIANT(1, 1, 1)
VARIANT(1, 1, 3)
VARIANT(4, 1, 0)
VARIANT(4, 1, 1)
VARIANT(2, 2, 0)
VARIANT(1, 2, 0)
"""

# (entry point, block x, block y)
VARIANTS = [
    ("v_2_1_0", 32, 8), ("v_2_1_1", 32, 8), ("v_2_1_2", 32, 8), ("v_2_1_3", 32, 8), ("v_2_1_4", 32, 8),
    ("v_1_1_0", 32, 8), ("v_1_1_1", 32, 8), ("v_1_1_3", 32, 8), ("v_4_1_0", 32, 8), ("v_4_1_1", 32, 8),
    ("v_2_2_0", 32, 8), ("v_1_2_0", 32, 8), ("v_2_1_0", 128, 2), ("v_2_1_0", 256, 1),
    ("v_2_1_0", 32, 8), ("v_2_1_1", 32, 8), ("v_2_1_3", 32, 8), ("v_2_1_4", 32, 8),
]


def in_turns(fns: dict, rounds: int = 20, per: int = 5) -> dict:
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            fn()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per):
                fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / per)
    return {name: statistics.median(t) for name, t in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("k10_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    nvcc = nvcc if os.path.isfile(nvcc) else shutil.which("nvcc")
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "k10.cu"), os.path.join(tmp, "k10.so")
        with open(cu, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
                        "-Xcompiler", "-fPIC", "-o", so, cu], check=True)
        lib = ctypes.CDLL(so)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand((3, H, W), generator=g, device="cuda") * 3.0
    out = torch.empty((3, H // 4, W // 4), device="cuda")
    ref = F.avg_pool2d(x[None], 4)[0]
    nbytes = (x.numel() + out.numel()) * 4
    for name, bx, by in VARIANTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5

        def launch():
            err = fn(x.data_ptr(), out.data_ptr(), 3, H, W, bx, by)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        out.zero_()
        launch()
        err = float((out - ref).abs().max())
        if not err <= 1e-6:
            raise AssertionError(f"{name} {bx}x{by}: error {err}")
        t = in_turns({"kernel": launch, "avg_pool2d": lambda: F.avg_pool2d(x[None], 4)})
        print(f"{name} block {bx}x{by}: kernel {t['kernel']!r} ms ({nbytes / t['kernel'] / 1e9!r} TB/s), "
              f"F.avg_pool2d {t['avg_pool2d']!r} ms, max_abs_err {err!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
