"""Host cost of each step of the K2/K4 wrapper (``ops/sep_rank.py::
fused_sep_rank``) on one NVIDIA GPU, at K4's preview shape.

    python3 scripts/k4_wrapper_cost.py

Times, in microseconds per call (host clock over 2000 calls, the device
synchronised before and after), the dispatch check, the tensor checks, the
packed-stack lookup, the output allocation, the stream query, the C call
that launches the kernel, the whole wrapper and, for comparison, the host
side of one grouped ``F.conv2d`` on the same input. Prints the card's name
and power limit first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raw2film_tpu_torch import load_film_bundle  # noqa: E402
from raw2film_tpu_torch.kernels import build as kb  # noqa: E402
from raw2film_tpu_torch.ops import mtf as mtf_ops  # noqa: E402
from raw2film_tpu_torch.ops import pyramid, sep_rank  # noqa: E402

N = 2000


def us_per_call(fn) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N):
        fn()
    t = (time.perf_counter() - t0) / N * 1e6
    torch.cuda.synchronize()
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_wrapper_cost: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    _, cfg = load_film_bundle(h=540, w=360, device="cpu", grain=2, sharpness=True)
    u3, v3 = mtf_ops.mtf_taps(cfg.mtf_key, cfg.scale)
    x = torch.rand((3, 540, 360), device=dev)
    lib = kb.lib()
    p = sep_rank.pack(u3, v3, 3, 540, 360)
    # the same work in a stack above SMALL_TAPS floats: 4 zero ranks more
    # per channel, skipped by the kernel, so it launches the full struct
    pad = lambda t: np.concatenate([t, np.zeros((3, 4, t.shape[2]), np.float32)], 1)  # noqa: E731
    p_full = sep_rank.pack(pad(u3), pad(v3), 3, 540, 360)
    out = torch.empty_like(x)
    stream = kb.stream_ptr(x)
    k2d = np.einsum("crk,crl->ckl", u3.astype(np.float64), v3.astype(np.float64)).astype(np.float32)
    wt = torch.as_tensor(k2d[:, None], device=dev)
    xp = F.pad(x[None], (1, 1, 1, 1), mode="reflect")
    hw = torch.empty(1, dtype=torch.int32, device=dev)
    tiny, up = torch.rand((1, 2, 2), device=dev), torch.empty((1, 4, 4), device=dev)
    steps = {
        "use_kernel": lambda: kb.use_kernel(x),
        "require": lambda: kb.require(x, "img", torch.float32),
        "pack (cache hit)": lambda: sep_rank.pack(u3, v3, 3, 540, 360),
        "empty_like": lambda: torch.empty_like(x),
        "stream_ptr": lambda: kb.stream_ptr(x),
        "lib": kb.lib,
        "C call, K4's stack (r2f_sep_rank, small struct)": lambda: lib.r2f_sep_rank(
            x.data_ptr(), out.data_ptr(), p.args_ptr, None, None, None, stream),
        "C call, padded stack (r2f_sep_rank, 8.4 KB struct)": lambda: lib.r2f_sep_rank(
            x.data_ptr(), out.data_ptr(), p_full.args_ptr, None, None, None, stream),
        "C call, 44 B of parameters (r2f_hash_words, one block)": lambda: lib.r2f_hash_words(
            hw.data_ptr(), hw.data_ptr(), 1, 1, 0, 0, 0, 0, 0, stream),
        "C call, 800 B of parameters (r2f_upsample, one block)": lambda: lib.r2f_upsample(
            tiny.data_ptr(), up.data_ptr(), 1, 2, 2, 4, 4, pyramid.ctypes.byref(pyramid.phases(2)), stream),
        "fused_sep_rank (whole)": lambda: sep_rank.fused_sep_rank(x, u3, v3),
        "F.conv2d (whole)": lambda: F.conv2d(xp, wt, groups=3),
    }
    for name, fn in steps.items():
        print(f"{name:56s} {us_per_call(fn)!r} us per call (host)")
    k4 = steps["fused_sep_rank (whole)"]
    conv = steps["F.conv2d (whole)"]
    for name in ("C call, K4's stack (r2f_sep_rank, small struct)",
                 "C call, padded stack (r2f_sep_rank, 8.4 KB struct)",
                 "C call, 44 B of parameters (r2f_hash_words, one block)"):
        print(f"{name}: {batch_us(steps[name])!r} us per call, CUDA events around 500 back-to-back calls")
    for name, fn in (("fused_sep_rank", k4), ("F.conv2d", conv)):
        print(f"{name}: {batch_us(fn)!r} us per call, CUDA events around 500 back-to-back calls; "
              f"device time by kernel under the profiler (us per call): {profiled_us(fn)!r}")
    one = torch.zeros(1, device=dev)
    singles = {
        "fused_sep_rank": k4,
        "F.conv2d": conv,
        "C call (r2f_sep_rank, small struct)": steps["C call, K4's stack (r2f_sep_rank, small struct)"],
        "C call (r2f_hash_words, one block)": steps["C call, 44 B of parameters (r2f_hash_words, one block)"],
        "one-element add_ (a PyTorch kernel)": lambda: one.add_(1.0),
    }
    for name, fn in singles.items():
        print(f"{name}: median {single_us(fn)!r} us, CUDA events around each call after a synchronize "
              f"(chip_smoke.py's cuda_ms)")
    return 0


def single_us(fn, n: int = 200) -> float:
    times = []
    fn()
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def batch_us(fn, n: int = 500) -> float:
    for _ in range(20):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def profiled_us(fn, n: int = 50) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            out[e.key[:60]] = (e.self_cuda_time_total if t is None else t) / n
    return out


if __name__ == "__main__":
    sys.exit(main())
