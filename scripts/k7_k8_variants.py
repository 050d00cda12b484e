"""Variants of K7 and K8 (``csrc/grain.cu``: the grain field, and colour
grain applied without the MTF) timed on one NVIDIA GPU at the 45 MP frame
(3 x 5472 x 8208, 3 grain taps: the compiled-tap path) and the half-size
frame (3 x 2736 x 4104, 1 tap: the white-noise path), each in turns with
the kernels as the repository builds them.

    python3 scripts/k7_k8_variants.py

Builds one small library per variant from the repository's own sources with
one substitution each (one ``nvcc`` per variant, all started together) and
prints ``nvcc -Xptxas -v``'s registers and spills of its K7 / K8 kernels:

- ``r4``, ``r16``: runs of 4 or 16 rows a thread on the compiled-tap path,
  not 8 (32- or 128-row tiles);
- ``w8``: 8 warps a block, not 4 (64-row tiles at 8 rows a thread; the
  first build's blocks);
- ``v8``: runs of 8 columns a thread, not 4 (256-column tiles, two 16-byte
  accesses a row);
- ``stcs``: streaming 16-byte stores (``__stcs``), not plain;
- ``white_r2``, ``white_r8``: 2 or 8 rows a warp on the white-noise path,
  not 4;
- ``taps_general``: 3 taps sent to the general path (the design before the
  compiled taps, with the same hash, amplitude and launch struct).

Besides, the repository's kernels on their value-by-value path (the same
aligned buffers launched with vec = 0) against their 16-byte path. Each is
checked against the plain version (1e-5), then timed in turns with the
repository's kernel (variant, kernel, variant, kernel: 10 turns of 5 calls,
CUDA events around each turn). Prints the card's name and power limit first.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raw2film_tpu_torch import load_film_bundle  # noqa: E402
from raw2film_tpu_torch.device import disable_tf32  # noqa: E402
from raw2film_tpu_torch.kernels import build as kb  # noqa: E402
from raw2film_tpu_torch.ops import grain as grain_ops  # noqa: E402

H, W = 5472, 8208
SOURCES = ("common.cuh", "grain.cuh", "grain.cu")
STORE = "        *reinterpret_cast<float4*>(p + x + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);"
# name -> substitutions in grain.cu
VARIANTS = {
    "r4": [("constexpr int TAPS_R = 8;", "constexpr int TAPS_R = 4;")],
    "r16": [("constexpr int TAPS_R = 8;", "constexpr int TAPS_R = 16;")],
    "w8": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")],
    "v8": [("constexpr int V = 4;", "constexpr int V = 8;")],
    "stcs": [(STORE, "        __stcs(reinterpret_cast<float4*>(p + x + j), make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));")],
    "white_r2": [("constexpr int WHITE_R = 4;", "constexpr int WHITE_R = 2;")],
    "white_r8": [("constexpr int WHITE_R = 4;", "constexpr int WHITE_R = 8;")],
    "taps_general": [("if (g.ntaps == 3)", "if (g.ntaps == -3)")],
}


def build(tmp: str) -> dict:
    """name -> loaded library, each from the repository's sources with its
    substitutions; prints each one's K7 / K8 registers and spills."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    nvcc = nvcc if os.path.isfile(nvcc) else shutil.which("nvcc")
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in SOURCES:
            with open(os.path.join(kb.CSRC, f)) as src:
                text = src.read()
            if f == "grain.cu":
                for old, new in subs:
                    if old not in text:
                        raise AssertionError(f"{name}: {old!r} not in {f}")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as dst:
                dst.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kb.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"), os.path.join(d, "grain.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"(grain_(?:white|taps|general)_kernel(?:I\w+?EE)?)", line)
            if "Compiling entry" in line and m:
                info = " ".join(f.split(":", 1)[-1].strip() for f in lines[i + 1: i + 4]
                                if re.search(r"registers|spill", f))
                print(f"  {name} ptxas {m.group(1)}: {info}")
        lib = ctypes.CDLL(os.path.join(tmp, name, "lib.so"))
        for fn in ("r2f_grain_apply", "r2f_grain_field"):
            getattr(lib, fn).argtypes = list(kb._SIGNATURES[fn])
        libs[name] = lib
    return libs


def in_turns(fns: dict, rounds: int = 10, per: int = 5) -> dict:
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
        print("k7_k8_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    disable_tf32()
    dev = torch.device("cuda", 0)
    _, cfg = load_film_bundle(h=H, w=W, device=dev, grain=2, sharpness=True)
    g = torch.Generator(device=dev).manual_seed(3)
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=dev)
    seed, row_off = 0xDEADBEEF, (-7) & 0xFFFFFFFF
    cases = {}  # (kernel, frame) -> (inputs, taps, repository launch, plain output)
    for frame, hw, scale in (("45mp", (H, W), cfg.scale), ("half", (H // 2, W // 2), cfg.scale / 2)):
        sigma = grain_ops.correlation_sigma_px(scale, cfg.grain_size_mm, cfg.grain_sigma)
        taps = grain_ops.grain_corr_taps(sigma)
        d = torch.rand((3, *hw), generator=g, device=dev) * 3.0
        with kb.plain_reference():
            ref8 = grain_ops.grain_apply(d, (seed, row_off), sigma, prm)
            ref7 = grain_ops.grain_field((seed, row_off), hw, sigma, device=dev)
        cases["k8", frame] = (d, taps, lambda d=d, s=sigma: grain_ops.grain_apply(d, (seed, row_off), s, prm), ref8)
        cases["k7", frame] = (d, taps, lambda hw=hw, s=sigma: grain_ops.grain_field((seed, row_off), hw, s,
                                                                                   device=dev), ref7)

    def launcher(lib, kernel: str, frame: str, vec: int):
        d, taps, _, _ = cases[kernel, frame]
        out = torch.empty_like(d)
        ct = (ctypes.c_float * len(taps))(*taps)
        stream = torch.cuda.current_stream().cuda_stream
        _, h, w = d.shape
        if kernel == "k8":
            args = (d.data_ptr(), out.data_ptr(), 3, h, w, 0, seed, row_off, prm.data_ptr(),
                    ctypes.cast(ct, ctypes.c_void_p), len(taps), vec, stream)
            fn = lib.r2f_grain_apply
        else:
            args = (out.data_ptr(), 3, h, w, seed, row_off, ctypes.cast(ct, ctypes.c_void_p), len(taps), vec, stream)
            fn = lib.r2f_grain_field

        def launch():
            err = fn(*args)
            if err:
                raise RuntimeError(f"{kernel}: CUDA error {err}")
            return out

        launch.keep = ct  # the taps live as long as the launcher
        return launch

    def run(name: str, lib, vec: int) -> None:
        for (kernel, frame), (_, taps, repo, ref) in cases.items():
            launch = launcher(lib, kernel, frame, vec)
            launch().zero_()
            err = float((launch() - ref).abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"{name} {kernel} {frame}: error {err}")
            t = in_turns({"variant": launch, "kernel": repo})
            print(f"{name} {kernel} {frame} ({len(taps)} taps): variant {t['variant']!r} ms, kernel "
                  f"{t['kernel']!r} ms, max_abs_err {err!r}", flush=True)

    run("scalar_path", kb.lib(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, lib in build(tmp).items():
            run(name, lib, 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
