"""Variants of K1 (``csrc/demosaic.cu``, the demosaic + input matrix) and
K12 (``csrc/pyramid.cu``, the x4 row upsample) timed on one NVIDIA GPU at
the 45 MP frame, each in turns with the kernel as the repository builds it.

    python3 scripts/k1_k12_variants.py

Builds one small library per variant from the repository's own sources with
one substitution each (one ``nvcc`` per variant, all started together, a
few seconds) and prints ``nvcc -Xptxas -v``'s registers and spills of each:

- K1 ``stcs``: the output's 16-byte stores streaming (``__stcs``), not
  plain; ``dx8``: runs of 2 x 8 outputs a thread (256-column tiles), not
  2 x 4; ``by16``: 32-row tiles (512 threads), not 16;
- K12 ``stcs``: streaming 16-byte stores; ``rpt8``, ``rpt16``: runs of 8
  or 16 output rows a thread, not 4.

Besides, the repository's K1 on its general path (the same aligned input
launched with vec = 0) against its 16-byte path, and K12 likewise. Each
variant is checked against the plain version (K1: 2e-6 on the 45 MP uint16
mosaic with the normalize and a matrix; K12: 2e-6 on the /4 level, 3 x 1368
x 2052, back to 5472 rows), then timed in turns with the repository's
kernel (variant, kernel, variant, kernel: 10 turns of 5 calls each, CUDA
events around each turn). Prints the card's name and power limit first.
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

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raw2film_tpu_torch.device import disable_tf32  # noqa: E402
from raw2film_tpu_torch.kernels import build as kb  # noqa: E402
from raw2film_tpu_torch.ops import demosaic as dm  # noqa: E402
from raw2film_tpu_torch.ops import pyramid  # noqa: E402

H, W = 5472, 8208
NORM = (512.0, 1.0 / 15000.0)
SOURCES = ("common.cuh", "demosaic.cu", "pyramid.cu")
K1_STORE = "  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);"
K12_STORE = "      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);"
# name -> (kernel, [(file, text, replacement)])
VARIANTS = {
    "k1_stcs": ("k1", [("demosaic.cu", K1_STORE,
                        "  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));")]),
    "k1_dx8": ("k1", [("demosaic.cu", "constexpr int DX = 4;", "constexpr int DX = 8;")]),
    "k1_by16": ("k1", [("demosaic.cu", "constexpr int BY = 8;", "constexpr int BY = 16;")]),
    "k12_stcs": ("k12", [("pyramid.cu", K12_STORE,
                          "      __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));")]),
    "k12_rpt8": ("k12", [("pyramid.cu", "constexpr int ROWS_RPT = 4;", "constexpr int ROWS_RPT = 8;")]),
    "k12_rpt16": ("k12", [("pyramid.cu", "constexpr int ROWS_RPT = 4;", "constexpr int ROWS_RPT = 16;")]),
}


def build(tmp: str) -> dict:
    """name -> loaded library, each from the repository's sources with its
    substitutions; prints each one's registers and spills."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    nvcc = nvcc if os.path.isfile(nvcc) else shutil.which("nvcc")
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in SOURCES:
            with open(os.path.join(kb.CSRC, f)) as src:
                text = src.read()
            for file, old, new in subs:
                if file == f:
                    if old not in text:
                        raise AssertionError(f"{name}: {old!r} not in {f}")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as dst:
                dst.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kb.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"), os.path.join(d, "demosaic.cu"),
             os.path.join(d, "pyramid.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        kernel = "demosaic_kernel" if VARIANTS[name][0] == "k1" else "upsample_rows_kernel"
        lines = log.splitlines()
        seen = set()  # one line each: the instances of a kernel mostly agree
        for i, line in enumerate(lines):
            if "Compiling entry" in line and kernel in line:
                for follow in lines[i + 1: i + 4]:
                    text = follow.split(":", 1)[-1].strip()
                    if re.search(r"registers|spill", follow) and text not in seen:
                        seen.add(text)
                        print(f"  {name} ptxas {kernel}: {text}")
        lib = ctypes.CDLL(os.path.join(tmp, name, "lib.so"))
        for fn in ("r2f_demosaic", "r2f_upsample_rows"):
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
        print("k1_k12_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    disable_tf32()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    codes = (512.0 + 15000.0 * torch.rand((H, W), generator=g, device=dev)).to(torch.int32).to(torch.uint16)
    mat = np.array([[0.9, 0.2, -0.1], [0.1, 1.1, -0.2], [-0.05, 0.15, 0.95]], np.float32)
    mat_arg = (ctypes.c_float * 9)(*mat.ravel().tolist())
    small = torch.rand((3, H // 4, W // 4), generator=g, device=dev) * 3.0
    table = pyramid.phases(4)
    k1_out = torch.empty((3, H, W), device=dev)
    k12_out = torch.empty((3, H, W // 4), device=dev)
    with kb.plain_reference():
        refs = {"k1": dm.demosaic_exposure(codes, "RGGB", mat, NORM), "k12": pyramid.bilinear_upsample_rows(small, 4, H)}
    repo = {"k1": lambda: dm.demosaic_exposure(codes, "RGGB", mat, NORM),
            "k12": lambda: pyramid.bilinear_upsample_rows(small, 4, H)}

    def launcher(lib, kernel: str, vec: int):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "k1":
            args = (codes.data_ptr(), 1, k1_out.data_ptr(), H, W, 0, 0, 1, *NORM,
                    ctypes.cast(mat_arg, ctypes.c_void_p), vec, stream)
            fn, out = lib.r2f_demosaic, k1_out
        else:
            args = (small.data_ptr(), k12_out.data_ptr(), 3, H // 4, W // 4, H, ctypes.byref(table), vec, stream)
            fn, out = lib.r2f_upsample_rows, k12_out

        def launch():
            err = fn(*args)
            if err:
                raise RuntimeError(f"{kernel}: CUDA error {err}")
            return out

        return launch

    kb.lib()
    runs = {f"{k}_general": (k, launcher(kb.lib(), k, 0)) for k in ("k1", "k12")}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        runs.update({name: (VARIANTS[name][0], launcher(lib, VARIANTS[name][0], 1)) for name, lib in libs.items()})
        for name, (kernel, launch) in runs.items():
            launch().zero_()
            got = launch()
            torch.cuda.synchronize()
            err = float((got - refs[kernel]).abs().max())
            if not err <= 2e-6:
                raise AssertionError(f"{name}: error {err}")
            t = in_turns({"variant": launch, "kernel": repo[kernel]})
            print(f"{name}: variant {t['variant']!r} ms, kernel {t['kernel']!r} ms, max_abs_err {err!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
