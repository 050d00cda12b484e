"""Variants of K5 and K6 (``csrc/conv1d.cu``: the 1-D correlations along W
and along H) timed on one NVIDIA GPU at the 45 MP frame (3 x 5472 x 8208)
with a 23-tap row and with 1 tap, each in turns with the kernels as the
repository builds them, and K11 (the half-size decode) beside its bound.

    python3 scripts/k5_k6_variants.py [parent checkout]

Builds one small library per variant from the repository's own sources with
one substitution each (one ``nvcc`` per variant, all started together) and
prints ``nvcc -Xptxas -v``'s registers and spills of its K5 / K6 kernels:

- ``h_r4``, ``h_r16``: K6 runs of 4 or 16 rows (and groups of as many
  taps), not 8;
- ``h_wy4``, ``h_wy16``: K6 blocks of 4 or 16 warps stacked along H
  (tiles of 32 or 128 rows), not 8; ``h_r4_wy16``: runs of 4 rows, 16
  warps (tiles of 64 rows);
- ``h_ch16``, ``h_ch64``: K6 stages of 16 or 64 taps, not 32;
- ``h_t2``, ``h_t8``: K6 blocks walking 2 or 8 tiles, not 4;
- ``w_y1``, ``w_y4``: K5 runs of 1 or 4 rows a thread, not 2;
- ``w_ty1``, ``w_ty4``: K5 blocks of 1 or 4 thread rows, not 2;
- ``w_tx32``, ``w_tx128``: K5 blocks 32 or 128 threads wide (tiles of 128
  or 512 columns), not 64;
- ``w_v8``: K5 runs 8 columns wide, not 4;
- ``w_ch16``, ``w_ch64``: K5 chunks of 16 or 64 taps, not 32;
- ``w_t2``, ``w_t8``: K5 blocks walking 2 or 8 row tiles, not 4.

Each variant's library takes the repository's packed taps
(``ops/sep_conv.py::pack``). Besides, the repository's kernels on their
scalar path (the same aligned buffers launched with vec = 0), and, given a
parent checkout (e.g. one unpacked with ``git archive`` into ``build/parent``),
that checkout's ``csrc/conv1d.cu`` built alone and launched with its own
arguments (the taps as a device vector). Each is checked bit for bit against
the plain version, then timed in turns with the repository's kernel
(variant, kernel, variant, kernel: 10 turns of 5 calls, CUDA events around
each turn), and K11 at the half-size frame (a 5472 x 8208 uint16 mosaic to
3 x 2736 x 4104) in turns with itself, beside its byte bound. Prints the
card's name and power limit first. Exits non-zero without a CUDA device.
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

from raw2film_tpu_torch import load_film_bundle  # noqa: E402
from raw2film_tpu_torch.device import disable_tf32  # noqa: E402
from raw2film_tpu_torch.kernels import build as kb  # noqa: E402
from raw2film_tpu_torch.ops import demosaic as dm  # noqa: E402
from raw2film_tpu_torch.ops import mtf as mtf_ops  # noqa: E402
from raw2film_tpu_torch.ops import sep_conv  # noqa: E402

H, W = 5472, 8208
SOURCES = ("common.cuh", "conv1d.cu")
# name -> substitutions in conv1d.cu
VARIANTS = {
    "h_r4": [("constexpr int H_R = 8;", "constexpr int H_R = 4;")],
    "h_r16": [("constexpr int H_R = 8;", "constexpr int H_R = 16;")],
    "h_wy4": [("constexpr int H_WY = 8;", "constexpr int H_WY = 4;")],
    "h_wy16": [("constexpr int H_WY = 8;", "constexpr int H_WY = 16;")],
    "h_r4_wy16": [("constexpr int H_R = 8;", "constexpr int H_R = 4;"),
                  ("constexpr int H_WY = 8;", "constexpr int H_WY = 16;")],
    "h_ch16": [("constexpr int H_CH = 32;", "constexpr int H_CH = 16;")],
    "h_ch64": [("constexpr int H_CH = 32;", "constexpr int H_CH = 64;")],
    "h_t2": [("constexpr int H_T = 4;", "constexpr int H_T = 2;")],
    "h_t8": [("constexpr int H_T = 4;", "constexpr int H_T = 8;")],
    "w_y1": [("constexpr int W_Y = 2;", "constexpr int W_Y = 1;")],
    "w_y4": [("constexpr int W_Y = 2;", "constexpr int W_Y = 4;")],
    "w_ty1": [("constexpr int W_TY = 2;", "constexpr int W_TY = 1;")],
    "w_ty4": [("constexpr int W_TY = 2;", "constexpr int W_TY = 4;")],
    "w_tx32": [("constexpr int W_TX = 64;", "constexpr int W_TX = 32;")],
    "w_tx128": [("constexpr int W_TX = 64;", "constexpr int W_TX = 128;")],
    "w_v8": [("constexpr int W_V = 4;", "constexpr int W_V = 8;")],
    "w_ch16": [("constexpr int W_CH = 32;", "constexpr int W_CH = 16;")],
    "w_ch64": [("constexpr int W_CH = 32;", "constexpr int W_CH = 64;")],
    "w_t2": [("constexpr int W_T = 4;", "constexpr int W_T = 2;")],
    "w_t8": [("constexpr int W_T = 4;", "constexpr int W_T = 8;")],
}
HBM_BYTES_PER_S = 3.35e12


def nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.isfile(path) else shutil.which("nvcc")


def build(tmp: str, parent: str | None) -> dict:
    """name -> loaded library, each from the repository's sources with its
    substitutions (and "parent" from the parent's sources); prints each
    one's K5 / K6 registers and spills."""
    procs = {}
    jobs = {name: (kb.CSRC, subs) for name, subs in VARIANTS.items()}
    if parent:
        jobs["parent"] = (os.path.join(parent, "raw2film_tpu_torch", "csrc"), [])
    for name, (csrc, subs) in jobs.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in SOURCES:
            with open(os.path.join(csrc, f)) as src:
                text = src.read()
            if f == "conv1d.cu":
                for old, new in subs:
                    if old not in text:
                        raise AssertionError(f"{name}: {old!r} not in {f}")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as dst:
                dst.write(text)
        procs[name] = subprocess.Popen(
            [nvcc(), *kb.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"), os.path.join(d, "conv1d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"(conv_[hw]_kernel\w*?)'", line)
            if "Compiling entry" in line and m:
                info = " ".join(f.split(":", 1)[-1].strip() for f in lines[i + 1: i + 4]
                                if re.search(r"registers|spill", f))
                print(f"  {name} ptxas {m.group(1)}: {info}")
        lib = ctypes.CDLL(os.path.join(tmp, name, "lib.so"))
        lib.r2f_conv1d.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                                   if name == "parent" else list(kb._SIGNATURES["r2f_conv1d"]))
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
        print("k5_k6_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    parent = sys.argv[1] if len(sys.argv) > 1 else None
    disable_tf32()
    dev = torch.device("cuda", 0)
    _, cfg = load_film_bundle(h=H, w=W, device=dev, grain=2, sharpness=True)
    taps23 = np.asarray(mtf_ops.mtf_taps(cfg.mtf_key, cfg.scale)[1][0, 0], np.float32)
    x = torch.rand((3, H, W), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    cases = {}  # (kernel, taps) -> (taps, repository launch, plain output)
    for name in ("conv_w", "conv_h"):
        fn = getattr(sep_conv, name)
        for t in (taps23, np.ones(1, np.float32)):
            with kb.plain_reference():
                ref = fn(x, t)
            cases[name, len(t)] = (t, lambda fn=fn, t=t: fn(x, t), ref)

    def launcher(lib, name: str, t: np.ndarray, vec: int, old: bool = False):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        axis = 0 if name == "conv_w" else 1
        if old:
            dt = torch.as_tensor(t.copy(), device=dev)
            args = (x.data_ptr(), out.data_ptr(), 3, H, W, dt.data_ptr(), len(t), axis, stream)
        else:
            p = sep_conv.pack(t, axis)
            args = (x.data_ptr(), out.data_ptr(), 3, H, W, p.args_ptr, None, axis, vec, stream)

        def launch():
            err = lib.r2f_conv1d(*args)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return out

        launch.keep = args if not old else (args, dt)
        return launch

    def run(label: str, lib, vec: int = 1, old: bool = False, only: str = "") -> None:
        for (name, n), (t, repo, ref) in cases.items():
            if only and not name.startswith(only):
                continue
            launch = launcher(lib, name, t, vec, old)
            launch().zero_()
            got = launch()
            if not torch.equal(got, ref):
                raise AssertionError(f"{label} {name} {n} taps: not bit-equal ({(got - ref).abs().max().item()})")
            turns = in_turns({"variant": launch, "kernel": repo})
            print(f"{label} {name} {n} taps: variant {turns['variant']!r} ms, kernel {turns['kernel']!r} ms, "
                  f"bit-equal; bound {x.numel() * 8 / HBM_BYTES_PER_S * 1e3!r} ms", flush=True)

    run("scalar_path", kb.lib(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        for label, lib in build(tmp, parent).items():
            run(label, lib, old=label == "parent", only={"h": "conv_h", "w": "conv_w"}.get(label[0], ""))
    del x, cases

    codes = (torch.rand((H, W), generator=torch.Generator(device=dev).manual_seed(5), device=dev) * 15000
             + 512).to(torch.int32).to(torch.uint16)
    norm = (512.0, 1.0 / 15000.0)
    k11 = lambda: dm.half_size_decode(codes, "RGGB", norm)  # noqa: E731
    with kb.plain_reference():
        ref = k11()
    if not torch.equal(k11(), ref):
        raise AssertionError("half_size_decode: not bit-equal to its plain version")
    nbytes = H * W * 2 + H // 2 * (W // 2) * 12
    turns = in_turns({"k11": k11, "k11_again": k11})
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"half_size_decode {H}x{W} -> 3x{H // 2}x{W // 2}: in turns {turns['k11']!r}, {turns['k11_again']!r} ms; "
          f"bound {bound_ms!r} ms (bytes): {bound_ms / turns['k11']:.1%} of it", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
