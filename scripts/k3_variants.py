"""Variants of K3 (``csrc/print_encode.cu``, the burn + print + encode tail)
timed on one NVIDIA GPU at the 45 MP frame, each in turns with the kernel
as the repository's source builds it (``repo``, the same build without a
substitution), all launched the same way: straight through the C entry
point, the film parameters packed once (the wrapper copies them to the host
on every call, a synchronize that would weigh on one side only).

    python3 scripts/k3_variants.py

Builds one small library per variant from the repository's own sources with
one substitution each (one ``nvcc`` per variant, all started together), and
prints ``nvcc -Xptxas -v``'s registers and spills of each:

- ``rb8``: bands of 8 rows, not 16 (32 burn sums a thread, half the shared
  memory; colmat read from L2 once per 8 rows);
- ``rb32``: bands of 32 rows;
- ``blocks6``: launch bounds for 6 blocks of 128 threads per SM (at most 80
  registers a thread);
- ``vx2``: 2 columns a thread, 256-column blocks (8-byte density loads).

Each is held to the plain version (1 code) on the benchmark config's tail
(print, sRGB, the burn's 49 x 74 small map of a 45 MP density), then timed
in turns with ``repo`` (10 turns of 3 calls, CUDA events
around each turn), with and without the burn. Prints the card's name and
power limit first. Exits non-zero without a CUDA device.
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
from raw2film_tpu_torch.ops import burn as burn_ops  # noqa: E402
from raw2film_tpu_torch.ops import print_encode as pe  # noqa: E402

H, W = 5472, 8208
SOURCES = ("common.cuh", "print_encode.cu")
VARIANTS = {
    "repo": [],
    "rb8": [("constexpr int RB = 16;", "constexpr int RB = 8;")],
    "rb32": [("constexpr int RB = 16;", "constexpr int RB = 32;")],
    "blocks6": [("__launch_bounds__(NTH)", "__launch_bounds__(NTH, 6)")],
    "vx2": [("constexpr int VX = 4;", "constexpr int VX = 2;"),
            ("  if (vec) return __ldg(reinterpret_cast<const float4*>(p));\n",
             "  if (vec) return make_float4(__ldg(p), __ldg(p + 1), 0.0f, 0.0f);\n"),
            ("const float up[VX] = {u.x, u.y, u.z, u.w};", "const float up[VX] = {u.x, u.y};"),
            ("const float m[VX] = {v.x, v.y, v.z, v.w};", "const float m[VX] = {v.x, v.y};"),
            ("make_float4(up[r][0], up[r][1], up[r][2], up[r][3]);", "make_float4(up[r][0], up[r][1], 0.0f, 0.0f);"),
            ("""          *reinterpret_cast<uint32_t*>(dst) =
              code(q[c][0]) | code(q[c][1]) << 8 | code(q[c][2]) << 16 | code(q[c][3]) << 24;""",
             """          *reinterpret_cast<uint16_t*>(dst) = code(q[c][0]) | code(q[c][1]) << 8;"""),
            ("*reinterpret_cast<float4*>(dst) = make_float4(q[c][0], q[c][1], q[c][2], q[c][3]);",
             "*reinterpret_cast<float2*>(dst) = make_float2(q[c][0], q[c][1]);"),
            ("""      dp[c][2] = nd[c].z;
      dp[c][3] = nd[c].w;
""", ""),
            ("static_cast<size_t>(RB) * NTH * VX;", "static_cast<size_t>(RB) * NTH * 4;")],
}


def build(tmp: str) -> dict:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    nvcc = nvcc if os.path.isfile(nvcc) else shutil.which("nvcc")
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in SOURCES:
            with open(os.path.join(kb.CSRC, f)) as src:
                text = src.read()
            if f == "print_encode.cu":
                for old, new in subs:
                    if old not in text:
                        raise AssertionError(f"{name}: {old!r} not in {f}")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as dst:
                dst.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kb.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "k3.so"), os.path.join(d, "print_encode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in log.splitlines():
            if re.search(r"registers|spill", line):
                print(f"  {name} ptxas: {line.strip()}")
        lib = ctypes.CDLL(os.path.join(tmp, name, "k3.so"))
        lib.r2f_print_encode.argtypes = list(kb._SIGNATURES["r2f_print_encode"])
        libs[name] = lib
    return libs


def in_turns(fns: dict, rounds: int = 10, per: int = 3) -> dict:
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
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    disable_tf32()
    kb.lib()
    dev = torch.device("cuda", 0)
    bundle, cfg = load_film_bundle(h=H, w=W, device=dev, grain=2, sharpness=True, highlight_burn=0.3)
    d = torch.rand((3, H, W), generator=torch.Generator(device=dev).manual_seed(5), device=dev) * 2.5
    burn = burn_ops.burn_smallmap(d, bundle["d_ref_green"], cfg.burn_scale)
    pvec = pe.pack_print_vec(bundle)
    pv = (ctypes.c_float * pe.PVEC_LEN)(*pvec.cpu().tolist())
    mode = (pe.MODES[cfg.print_mode], int(bool(cfg.shadow_comp)), int(bool(cfg.sat_neutral)),
            pe.GAMMA_CODES[cfg.gamma_func])
    out = torch.empty((3, H, W), dtype=torch.uint8, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for with_burn in (True, False):
            args = (d, pvec, cfg.print_mode, cfg.shadow_comp, cfg.sat_neutral, cfg.gamma_func, True)
            b = burn if with_burn else None
            with kb.plain_reference():
                ref = pe.print_encode(*args, b)
            ptrs = (b[0].data_ptr(), b[1].data_ptr(), b[2].data_ptr()) if with_burn else (None, None, None)
            hs, ws = b[0].shape if with_burn else (0, 0)
            launches = {}
            for name, lib in libs.items():
                def launch(lib=lib, name=name):
                    err = lib.r2f_print_encode(d.data_ptr(), ctypes.cast(pv, ctypes.c_void_p), *ptrs, hs, ws,
                                               out.data_ptr(), H, W, *mode, 1, int(with_burn), 1,
                                               torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                out.zero_()
                launch()
                err = float((out.double() - ref.double()).abs().max())
                if not err <= 1.0:
                    raise AssertionError(f"{name} burn={with_burn}: error {err}")
                launches[name] = launch
            for name in VARIANTS:
                if name != "repo":
                    t = in_turns({"variant": launches[name], "repo": launches["repo"]})
                    print(f"burn={with_burn} {name}: variant {t['variant']!r} ms, repo {t['repo']!r} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
