"""Variants of K2's chunked rank stage (``csrc/sep_rank_grain.cu`` with
``csrc/sep_rank.cuh``) timed on one NVIDIA GPU, each in turns with the
kernel as the repository builds it.

    python3 scripts/k2_variants.py

Builds one small library per variant from the repository's own sources with
one substitution each (one ``nvcc`` per variant, all started together, a
few seconds), and prints ``nvcc -Xptxas -v``'s registers and spills of each:

- ``runtime``: the 45 MP MTF's ranks (3 chunks of 8 taps: 23 taps and one
  zero) on the runtime chunk loop, against the repository's kernel, which
  takes such stacks with the count compiled in and the chunk loops
  unrolled (``FIXED_CHUNKS``);
- ``ck4``: chunks of 4 taps (23 still run 24; the small blur's 27 run 28);
- ``nc8``: column runs of 8 rows, not 16;
- ``blocks2``, ``blocks3``: launch bounds for 2 or 3 blocks per SM, not
  4 (the 3-chunk kernel) and 3 (the others);
- ``tw104``: tiles 104 columns wide (13 columns a thread in the row pass),
  so the 45 MP MTF's column pass is 254 items for 256 threads, not 302.

Each variant is checked against the plain version (1e-5) on the 45 MP MTF +
grain launch (3 x 5472 x 8208, 3 x 4 ranks x 23 taps, 3 grain taps) and,
except ``runtime``, the /4 small blur (3 x 1368 x 2052, ranks of 15 and 27
taps), then timed in turns with the repository's kernel (variant, kernel,
variant, kernel: 10 turns of 3 calls each, CUDA events around each turn).
Prints the card's name and power limit first. Exits non-zero without a
CUDA device.
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
from raw2film_tpu_torch.ops import halation as hal_ops  # noqa: E402
from raw2film_tpu_torch.ops import mtf as mtf_ops  # noqa: E402
from raw2film_tpu_torch.ops import sep_rank  # noqa: E402

H, W = 5472, 8208
SOURCES = ("common.cuh", "grain.cuh", "sep_rank.cuh", "sep_rank_grain.cu")
# name -> (taps per chunk the host packs with, [(file, text, replacement)])
VARIANTS = {
    "runtime": (8, [("sep_rank_grain.cu", "constexpr int FIXED_CHUNKS = 3;", "constexpr int FIXED_CHUNKS = 0;")]),
    "ck4": (4, [("sep_rank.cuh", "constexpr int CK = 8;", "constexpr int CK = 4;")]),
    "nc8": (8, [("sep_rank.cuh", "constexpr int NC = 16;", "constexpr int NC = 8;")]),
    "blocks2": (8, [("sep_rank_grain.cu", "__launch_bounds__(NT, FIX ? 4 : 3)", "__launch_bounds__(NT, 2)")]),
    "blocks3": (8, [("sep_rank_grain.cu", "__launch_bounds__(NT, FIX ? 4 : 3)", "__launch_bounds__(NT, 3)")]),
    "tw104": (8, [("sep_rank.cuh", "constexpr int TW = 128;", "constexpr int TW = 104;"),
                  ("sep_rank.cuh", "constexpr int NR = 16;", "constexpr int NR = 13;")]),
}
# the tile width each variant builds with (the host sizes the window by it)
TILE_W = {"tw104": 104}


def pack_ck(u, v, c: int, h: int, w: int, ck: int, tw: int) -> sep_rank.Ranks:
    """sep_rank.pack's struct with chunks of ck taps, for tiles tw wide."""
    taps, args = sep_rank.chunked(*sep_rank._stack(u, v), c, h, w, sep_rank.pack(u, v, c, h, w).nrank, ck)
    args.EW += tw - sep_rank.TW
    ctypes.memmove(args.taps, taps.ctypes.data, taps.nbytes)
    return args


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
            [nvcc, *kb.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "k2.so"), os.path.join(d, "sep_rank_grain.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in log.splitlines():
            if re.search(r"registers|spill", line) or ("Compiling entry" in line and "sep_rank" in line):
                print(f"  {name} ptxas: {line.strip()}")
        lib = ctypes.CDLL(os.path.join(tmp, name, "k2.so"))
        lib.r2f_sep_rank.argtypes = list(kb._SIGNATURES["r2f_sep_rank"])
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
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    disable_tf32()
    kb.lib()
    dev = torch.device("cuda", 0)
    _, cfg = load_film_bundle(h=H, w=W, device=dev, grain=2, sharpness=True, highlight_burn=0.3)
    u3, v3 = mtf_ops.mtf_taps(cfg.mtf_key, cfg.scale)
    gtaps = grain_ops.grain_corr_taps(grain_ops.correlation_sigma_px(cfg.scale, cfg.grain_size_mm, cfg.grain_sigma))
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=dev)
    seed = (0xDEADBEEF, 5)
    grain = (seed, prm, gtaps)
    gargs = sep_rank.GrainArgs(*seed, len(gtaps), tuple(float(t) for t in gtaps))
    _, _, by_factor = hal_ops._full_res_ranks(cfg.scale / 4.0 * cfg.halation_size)
    su, sv = hal_ops.pyramid_taps(4, by_factor[4])
    g = torch.Generator(device=dev).manual_seed(4)
    cases = {
        "mtf_grain": (torch.rand((3, H, W), generator=g, device=dev) * 3.0, u3, v3, grain, gargs),
        "small_blur": (torch.rand((3, H // 4, W // 4), generator=g, device=dev), su, sv, None, None),
    }
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for case, (x, u, v, gr, ga) in cases.items():
            with kb.plain_reference():
                ref = sep_rank.fused_sep_rank(x, u, v, gr)
            out = torch.empty_like(x)
            repo = lambda: sep_rank.fused_sep_rank(x, u, v, gr)  # noqa: E731
            for name, lib in libs.items():
                if name == "runtime" and case != "mtf_grain":
                    continue
                args = pack_ck(u, v, *x.shape, VARIANTS[name][0], TILE_W.get(name, sep_rank.TW))

                def launch(lib=lib, args=args):
                    err = lib.r2f_sep_rank(x.data_ptr(), out.data_ptr(), ctypes.addressof(args), None,
                                           None if ga is None else ctypes.byref(ga),
                                           None if gr is None else prm.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                out.zero_()
                launch()
                err = float((out - ref).abs().max())
                if not err <= 1e-5:
                    raise AssertionError(f"{name} {case}: error {err}")
                t = in_turns({"variant": launch, "kernel": repo})
                print(f"{case} {name}: variant {t['variant']!r} ms, kernel {t['kernel']!r} ms, "
                      f"max_abs_err {err!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
