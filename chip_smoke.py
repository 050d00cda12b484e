"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), torch and CUDA
   versions and the TF32 flags; exits non-zero without a CUDA device;
2. builds the hand-written kernels from ``raw2film_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together);
3. checks each of the sixteen kernels against its plain PyTorch version on
   the card (K15, the fused path's exposure sample, against the host
   estimate: the power mean within 2e-6 relative), at small ragged shapes and at the shapes of the paths below,
   and times it beside its bound (the larger of its bytes over 3.35 TB/s
   and its fp32 operations over 67 TFLOP/s) and, where one PyTorch call
   computes the same function, that call; K2 also at every odd tap length
   3-73 (shared ragged and per-channel ranks, with and without grain, on
   frames off the tile grid); K2's MTF + grain launch and /4 small blur, K3,
   K4 and K14 also under torch.profiler (the kernel's own device time, and
   a failure if one call copies anything from the host to the device); K3
   with and without the burn, in turns; K4 and K10 timed in turns with
   F.conv2d and F.avg_pool2d, K10 on both its paths, K13 at both pyramid
   levels, K14 at the 45 MP and 24 MP frames; K1 on both its paths at 45 MP
   and at phase (f)'s shapes, K12 on both at the 45 MP and 24 MP /4
   levels, each path named, both paths timed in turns (their device time
   is read from the profiled render below); K7 and K8 on each of their paths
   (white noise, 3 and 5 taps compiled in, the general path; 16-byte and
   value-by-value stores; K8 on an unaligned view), each timed at the 45 MP
   frame (3 taps) and the half-size frame (1 tap) beside its bound, and
   built with no stack frame and no spills (``nvcc -Xptxas -v``); K5 and
   K6 bit-equal to their plain versions on every path (16-byte and scalar,
   tail runs and tiles, 1 tap, above the by-value cap, all-zero taps), at
   45 MP profiled (a failure if one call copies anything from the host to
   the device) and timed in turns with F.conv2d, their scalar path and 1
   tap, with their registers; K16 (the development) on both its paths, with
   colour masking and a black-and-white negative, profiled at 45 MP (a
   failure if a call copies anything from the host to the device), timed at
   45 MP and at the CLI default's 2000 x 3000 beside the plain development,
   with its registers (a failure on spills);
4. renders a seeded 5472x8208 uint16 RGGB mosaic through
   ``render_chain_from_mosaic`` (Kodak Portra 400 printed on Fuji Crystal
   Archive Maxima, halation on, grain 2, MTF, burn 0.3), checks how often
   every kernel of the path launched in that render, and holds the output
   to the same render with the plain versions on the card (within 1 uint8
   code); then the same with halation off;
5. writes the same mosaic as an uncompressed 5472x8208 DNG to a temporary
   directory and renders it with ``Processor(device="cuda").process()`` in
   eight phases, each with its launch counts checked exactly and its output
   held to a plain-version Processor within 1 code: (a) the CLI defaults
   (half-size decode K11, the SVD halation tier on K2, K2 MTF + grain, the
   burn's small-map blur on K4, K3), (b) full res (the fused path), (c)
   sharpness off (grain on K8), (d) grain 1 (K9), (e) halation size 3.0 at
   full res (the /4 and /8 pyramid levels, K13 twice), (f) full res on a
   36 x 23.9 frame, whose H is not a multiple of 4 (the bilinear resize,
   neither K13 nor K14), (g) chroma NR 3 (its blur on K2), (i) grain 3 (the
   field alone, K7);
6. (h) drives ``PreviewEngine`` over that Processor: the full preview of the
   portrait frame at 15 px/mm (540 x 360, where the TPU runs K4) and the
   simplified preview at 30 px/mm, each render held to a plain-version
   engine's within 1 code and its float frame (enlarged by Lanczos-5,
   before the truncation) within what the enlargement makes of those
   differences, its histogram equal to a plain count of its frame,
   the frame latency timed; (j) runs ``ops/sep_conv.py`` (K5, K6) at 45 MP,
   timed;
7. times the renders, (a) and (b) end to end and stage by stage, profiles
   the halation-on render's device time by kernel (a failure if a render
   copies anything from the host to the device, or more than
   D2H_PER_RENDER = 0 from the device to the host);
8. (k) renders the DNG at full res with an ICC transform (a float callable,
   baked into CP factors once per transform): (b)'s launch counts with K3
   once in float mode, within 1 code of a plain-version Processor, a
   profiled render with the factors attached copying nothing to the device,
   the CP apply's device ms and extra peak memory at 45 MP; then an ImageCms
   sRGB soft proof at the CLI defaults; (l) runs the CLI (``cli.main``, its
   defaults, PNG) over two seeded DNGs: exit code 0, each PNG equal to
   ``process()`` of its file with the same launch counts, ms per image; (m)
   serves the viewer on localhost: one parameter change, the frame within 1
   code of a plain-version engine's, JPEGs from /api/frame.jpg and
   /api/thumb/0, /api/about reporting CUDA;
9. (n) renders a seeded 45 MP XYZ frame on virtual meshes of cuda:0
   (``parallel/mesh.py``): the halo space path at space 2, 4 and 8 (8
   multi-hop: the 1080-row halo exceeds a 684-row shard) and the batch
   axis with two images, each with exact launch counts per shard, within 1
   code of the same sharded render on the plain versions, and held to the
   unsharded render within 1 code on 64 rows about each seam and on every
   row more than one halo from the frame's edges (the edge bands
   reported); a profiled space-2 render copying nothing host-to-device;
   ms per sharded frame and peak memory beside the unsharded frame; then
   ``process_batch`` over a 2 x 2 mesh on the two DNGs of (l), and two
   processes of this script (``--gloo-worker``) in a gloo group, both on
   cuda:0, each output equal to this process's render;
10. (o) times the downloads of a 45 MP uint8 frame (134.74 MB) and a 24 MP
   preview frame at 30 px/mm (18.0 MB) through ``utils/trace.py::to_host``
   beside ``.cpu()``, in turns, each equal to ``.cpu()``'s and page-locked;
11. prints one JSON line of per-kernel results, then {"ok": true, "device":
   {...}} as its last line.

Any failed check ends the script with a traceback and a non-zero exit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench import roofline
from raw2film_tpu_torch import PreviewEngine, Processor, load_film_bundle, render_chain, render_chain_from_mosaic
from raw2film_tpu_torch import data as ref_data
from raw2film_tpu_torch.device import disable_tf32, require_cuda
from raw2film_tpu_torch.io import dng
from raw2film_tpu_torch.io import icc as ticc
from raw2film_tpu_torch.io import raw as traw
from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import burn as burn_ops
from raw2film_tpu_torch.ops import chroma_nr
from raw2film_tpu_torch.ops import demosaic as dm
from raw2film_tpu_torch.ops import grain as grain_ops
from raw2film_tpu_torch.ops import halation as hal_ops
from raw2film_tpu_torch.ops import mtf as mtf_ops
from raw2film_tpu_torch.ops import print_encode as pe
from raw2film_tpu_torch.ops import pyramid
from raw2film_tpu_torch.ops import sep_conv, sep_rank
from raw2film_tpu_torch.ops.conv import gaussian_kernel1d
from raw2film_tpu_torch.ops.histogram import generate_histogram, histogram_counts, render_histogram
from raw2film_tpu_torch.ops.lut import apply_lut_3d_cp
from raw2film_tpu_torch.ops.resize import resolution_scaling, weight_matrix
from raw2film_tpu_torch.pipeline import geometry
from raw2film_tpu_torch.pipeline import processor as tproc
from raw2film_tpu_torch.pipeline import render as trender
from raw2film_tpu_torch.pipeline.render import build_render_config
from raw2film_tpu_torch.utils import trace

H, W = 5472, 8208
SEED = 20261016
# max abs error of a kernel against its plain version: float32 images, and
# uint8 codes for the print tail. Its float output is held to 1e-4 (0.03 of
# a code): steep transfer curves near black (Gamma 2.2/2.4, no linear toe)
# amplify the last-ulp differences of exp2f and FMA contraction.
# The pyramid resamples sum or lerp a few float32 values (a few ulp of
# values below 4); halation is held to 1e-5 on exposure and 2e-5 on density
# (the develop epilogue's log2/exp2 chain), as is K16, the same chain; the
# half-size decode selects and averages two values, bit for bit; the grain
# applies as K2's epilogue.
# K15's power mean is held relative to the host estimate's: float32 terms
# (CUDA's powf against the host's) summed in float64 against numpy's
# float32 pairwise sum.
TOL = {
    "demosaic": 2e-6, "sep_rank": 1e-5, "print_encode": 1.0, "print_encode_float": 1e-4,
    "pyramid_down": 1e-6, "pyramid_up_rows": 2e-6, "halation": 1e-5, "halation_density": 2e-5,
    "half_size": 0.0, "pyramid_up": 2e-6, "grain_apply": 1e-5, "grain_apply_bw": 1e-5,
    "sep_rank_narrow": 1e-5, "grain_field": 1e-5, "conv_w": 1e-6, "conv_h": 1e-6,
    "exposure_sample": 2e-6, "develop": 2e-5,
}
# name -> (the TPU kernel's number, source, the TPU kernel it replaces), in
# the order of the TPU kernels. K4 is the K2 kernel on the shapes the TPU's
# K2 declines (ops/sep_rank.py::tpu_declines). K15 replaces a host pass, K16
# the plain development (XLA fuses it on the TPU).
KERNELS = {
    "demosaic": ("K1", "raw2film_tpu_torch/csrc/demosaic.cu", "raw2film_tpu/ops/pallas_demosaic.py:191"),
    "sep_rank": ("K2", "raw2film_tpu_torch/csrc/sep_rank_grain.cu", "raw2film_tpu/ops/pallas_conv2.py:576"),
    "print_encode": ("K3", "raw2film_tpu_torch/csrc/print_encode.cu", "raw2film_tpu/ops/pallas_print.py:164"),
    "sep_rank_narrow": ("K4", "raw2film_tpu_torch/csrc/sep_rank_grain.cu", "raw2film_tpu/ops/pallas_conv2.py:269"),
    "conv_w": ("K5", "raw2film_tpu_torch/csrc/conv1d.cu", "raw2film_tpu/ops/pallas_conv2.py:84"),
    "conv_h": ("K6", "raw2film_tpu_torch/csrc/conv1d.cu", "raw2film_tpu/ops/pallas_conv2.py:117"),
    "grain_field": ("K7", "raw2film_tpu_torch/csrc/grain.cu", "raw2film_tpu/ops/pallas_grain.py:249"),
    "grain_apply": ("K8", "raw2film_tpu_torch/csrc/grain.cu", "raw2film_tpu/ops/pallas_grain.py:306"),
    "grain_apply_bw": ("K9", "raw2film_tpu_torch/csrc/grain.cu", "raw2film_tpu/ops/pallas_grain.py:405"),
    "pyramid_down": ("K10", "raw2film_tpu_torch/csrc/pyramid.cu", "raw2film_tpu/ops/pallas_pyramid.py:65"),
    "half_size": ("K11", "raw2film_tpu_torch/csrc/demosaic.cu", "raw2film_tpu/ops/pallas_pyramid.py:205"),
    "pyramid_up_rows": ("K12", "raw2film_tpu_torch/csrc/pyramid.cu", "raw2film_tpu/ops/pallas_pyramid.py:277"),
    "pyramid_up": ("K13", "raw2film_tpu_torch/csrc/pyramid.cu", "raw2film_tpu/ops/pallas_pyramid.py:374"),
    "halation": ("K14", "raw2film_tpu_torch/csrc/halation.cu", "raw2film_tpu/ops/pallas_halation.py:239"),
    "exposure_sample": ("K15", "raw2film_tpu_torch/csrc/demosaic.cu",
                        "none: the fused path's host estimate (raw2film_tpu/pipeline/processor.py:106, :753)"),
    "develop": ("K16", "raw2film_tpu_torch/csrc/develop.cu",
                "none: XLA's fusion of raw2film_tpu/pipeline/render.py:264-277"),
}
def bound(nbytes: float, flops: float) -> dict:
    """A kernel's least time (``portbench/roofline.py``) and what sets it."""
    by_bytes = nbytes / roofline.HBM_BYTES_PER_S >= flops / roofline.FP32_FLOP_PER_S
    return {"bound_ms": roofline.least_s(nbytes, flops) * 1e3, "bound_by": "bytes" if by_bytes else "operations"}


def counts(**nonzero) -> dict:
    """A full launch-count dict: the given kernels, every other one 0."""
    return {k: nonzero.get(k, 0) for k in kb.launches}


# Launches of each kernel in one 45 MP render: with halation, K2 runs twice
# (the /4 small blur and the MTF + grain); the burn's small map (49 x 74) is
# blurred on K4.
LAUNCHES_ON = counts(demosaic=1, pyramid_down=1, sep_rank=2, sep_rank_narrow=1, pyramid_up_rows=1,
                     halation=1, print_encode=1)
LAUNCHES_OFF = counts(demosaic=1, develop=1, sep_rank=1, sep_rank_narrow=1, print_encode=1)
# Device-to-host copies in one profiled 45 MP render: none. The input matrix
# is folded from the bundle's host copy (m_in_host) and K3 takes the film
# parameters from theirs (pvec_host).
D2H_PER_RENDER = 0
# Processor.process() of the DNG: (overrides of the benchmark settings,
# launches per render, output shape). Every phase blurs the burn's small map
# on K4 once; every full-res phase (the fused path) estimates the exposure
# on K15 once; every phase but (b) develops on K16 (K14 develops on the /4
# tier alone).
HALF = (H // 2, W // 2, 3)
PHASES = {
    "a": ({}, counts(half_size=1, develop=1, sep_rank=2, sep_rank_narrow=1, print_encode=1), HALF),
    "b": (dict(half_size=False, max_scale=None), dict(LAUNCHES_ON, exposure_sample=1), (H, W, 3)),
    "c": (dict(sharpness=False),
          counts(half_size=1, develop=1, sep_rank=1, sep_rank_narrow=1, grain_apply=1, print_encode=1), HALF),
    "d": (dict(grain=1),
          counts(half_size=1, develop=1, sep_rank=2, sep_rank_narrow=1, grain_apply_bw=1, print_encode=1), HALF),
    "e": (
        dict(half_size=False, max_scale=None, halation_size=3.0),
        counts(demosaic=1, pyramid_down=2, sep_rank=4, sep_rank_narrow=1, pyramid_up=2, print_encode=1,
               exposure_sample=1, develop=1),
        (H, W, 3),
    ),
    "f": (
        dict(half_size=False, max_scale=None, frame_height=23.9),
        counts(demosaic=1, pyramid_down=1, sep_rank=3, sep_rank_narrow=1, print_encode=1, exposure_sample=1,
               develop=1),
        (5449, 8207, 3),
    ),
    # chroma NR: its chromaticity blur is one shared rank on K2
    "g": (dict(chroma_nr=3), counts(half_size=1, develop=1, sep_rank=3, sep_rank_narrow=1, print_encode=1), HALF),
    # grain 3: the MTF alone on K2, then the field alone on K7
    "i": (dict(grain=3),
          counts(half_size=1, develop=1, sep_rank=2, sep_rank_narrow=1, grain_field=1, print_encode=1), HALF),
}
# PreviewEngine requests (h): (request parameters, launches of the first
# frame, frame shape). The full preview of the portrait frame renders 540 x
# 360 at 15 px/mm: the halation glow (a 5 x 5 kernel, 2 ranks) and the burn
# blur on K4, the MTF + grain on K2; the simplified one 720 x 1080 at 30
# px/mm without halation, MTF or grain. Both frames are resized back to the
# decoded size, as the JAX Processor does.
PREVIEWS = {
    "full-15-portrait": (
        dict(full_preview=True, max_scale=15.0, rotate_times=1),
        counts(half_size=1, develop=1, sep_rank=1, sep_rank_narrow=2, print_encode=1),
        (W // 2, H // 2, 3),
    ),
    "simplified-30": (
        dict(max_scale=30.0),
        counts(half_size=1, develop=1, sep_rank_narrow=1, print_encode=1),
        (H // 2, W // 2, 3),
    ),
}
STOCKS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima")
SETTINGS = dict(STOCKS, grain=2, sharpness=True, highlight_burn=0.3, seed=SEED)
H24, W24 = 4000, 6000  # a 24 MP frame: 43-tap halation ranks


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> list[float]:
    """Per-call device times in ms, one CUDA event pair per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def plain(fn, *args, **kw):
    with kb.plain_reference():
        return fn(*args, **kw)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def expect(name: str, err: float, tol: float, what: str) -> None:
    print(f"  {name} {what}: max_abs_err={err!r} (tol {tol})")
    if not err <= tol:
        raise AssertionError(f"{name} {what}: error {err} above {tol}")


def mosaic_codes(h: int, w: int, seed: int, device) -> torch.Tensor:
    """Seeded uint16 sensor codes: a banded scene with per-pixel texture,
    made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    row = torch.rand((1, w), generator=g, device=device) * 0.8 + 0.05
    col = torch.rand((h, 1), generator=g, device=device) * 0.8 + 0.4
    tex = torch.rand((h, w), generator=g, device=device) * 0.6 + 0.7
    codes = 512.0 + 15000.0 * row * col * tex
    return codes.clamp(0, 65535).to(torch.int32).to(torch.uint16)


NORM = (512.0, 1.0 / 15000.0)


# ------------------------------------------------------------ kernel checks


def med(fn, iters: int) -> float:
    return statistics.median(cuda_ms(fn, iters))


def dense_kernels(u3, v3, c: int) -> np.ndarray:
    """(c, kv, kh) float32 2-D kernels of (Cb, R, k) rank stacks: the sum of
    each channel's outer products (Cb = 1: shared by the c channels)."""
    k = np.einsum("crk,crl->ckl", np.asarray(u3, np.float64), np.asarray(v3, np.float64))
    return np.ascontiguousarray(np.broadcast_to(k, (c, *k.shape[1:])), np.float32)


def library_conv_ms(x: torch.Tensor, k2d: np.ndarray, iters: int = 5) -> float:
    """One grouped F.conv2d (TF32 off) of the reflect-padded image with the
    per-channel 2-D kernels: the library call that computes a sum of
    separable ranks with reflect-101 borders. The padding is made before
    the clock starts."""
    c = x.shape[0]
    ph, pw = k2d.shape[1] // 2, k2d.shape[2] // 2
    xp = F.pad(x[None], (pw, pw, ph, ph), mode="reflect")
    wt = torch.as_tensor(k2d[:, None], device=x.device)
    return med(lambda: F.conv2d(xp, wt, groups=c), iters)


def demosaic_path(x: torch.Tensor) -> str:
    """The K1 path a mosaic takes (its output is freshly allocated, 16-byte
    aligned)."""
    return "16-byte" if dm.vec_path(x.shape[1], x.dtype, x.data_ptr()) else "general"


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x one element into its storage: not 16-byte
    aligned."""
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = base[1:].view(x.shape)
    view.copy_(x)
    return view


def check_demosaic(device, full_hw) -> dict:
    """K1 at small ragged shapes in every phase, then on both paths at 45 MP
    (the 16-byte path, and the general one on an unaligned copy) and at
    phase (f)'s mosaic (5457 x 8208, odd H) and its 8207-wide crop; the 45
    MP frame timed on both paths, in turns."""
    g = torch.Generator(device=device).manual_seed(1)
    mat = np.array([[0.9, 0.2, -0.1], [0.1, 1.1, -0.2], [-0.05, 0.15, 0.95]], np.float32)
    for pattern in dm.PATTERNS:
        for hw in ((37, 53), (49, 392)):
            codes = mosaic_codes(*hw, 2, device)
            expect("demosaic", max_err(dm.demosaic_exposure(codes, pattern, mat, NORM),
                                       plain(dm.demosaic_exposure, codes, pattern, mat, NORM)),
                   TOL["demosaic"], f"u16+norm+mat {hw[0]}x{hw[1]} {pattern} ({demosaic_path(codes)} path)")
            f = torch.rand(hw, generator=g, device=device)
            expect("demosaic", max_err(dm.demosaic_mhc(f, pattern), plain(dm.demosaic_mhc, f, pattern)),
                   TOL["demosaic"], f"f32 {hw[0]}x{hw[1]} {pattern} ({demosaic_path(f)} path)")
    codes = mosaic_codes(*full_hw, 3, device)
    if demosaic_path(codes) != "16-byte":
        raise AssertionError("the 45 MP mosaic should take K1's 16-byte path")
    launch = lambda: dm.demosaic_exposure(codes, "RGGB", mat, NORM)  # noqa: E731
    err = max_err(launch(), plain(dm.demosaic_exposure, codes, "RGGB", mat, NORM))
    expect("demosaic", err, TOL["demosaic"], f"u16+norm+mat {full_hw[0]}x{full_hw[1]} (16-byte path)")
    off = unaligned(codes)
    if demosaic_path(off) != "general":
        raise AssertionError("an unaligned mosaic should take K1's general path")
    general = lambda: dm.demosaic_exposure(off, "RGGB", mat, NORM)  # noqa: E731
    expect("demosaic", max_err(general(), plain(dm.demosaic_exposure, off, "RGGB", mat, NORM)), TOL["demosaic"],
           f"u16+norm+mat {full_hw[0]}x{full_hw[1]} unaligned (general path)")
    by_path = {}
    for name, (y0, x0, h, w) in {"phase_f": (4, 0, 5457, 8208), "phase_f_crop": (8, 1, 5449, 8207)}.items():
        part = codes[y0:y0 + h, x0:x0 + w].contiguous()
        e = max_err(dm.demosaic_exposure(part, "RGGB", mat, NORM), plain(dm.demosaic_exposure, part, "RGGB", mat, NORM))
        expect("demosaic", e, TOL["demosaic"], f"u16+norm+mat {h}x{w} ({demosaic_path(part)} path)")
        by_path[name] = {"shape": [h, w], "path": demosaic_path(part), "max_abs_err": e}
    turns = in_turns({"16-byte": launch, "general": general}, 10, 3)
    print(f"  demosaic {full_hw[0]}x{full_hw[1]} in turns: 16-byte path {turns['16-byte']!r} ms, general path "
          f"{turns['general']!r} ms; {by_path!r}")
    del off
    px = full_hw[0] * full_hw[1]
    return {
        "max_abs_err": err,
        "ms": med(launch, 20),
        "plain_ms": med(lambda: plain(dm.demosaic_exposure, codes, "RGGB", mat, NORM), 5),
        # u16 in, 3 float32 out; per pixel the normalize, the MHC filter
        # (about 13 taps for each of 2 missing colours) and the 3x3 matrix
        **bound(px * (2 + 12), px * (2 + 2 * 2 * 13 + 15)),
        "library_ms": None,
        "in_turns": turns,
        "by_path": by_path,
    }


def check_sep_rank_lengths(device, prm, seed) -> None:
    """K2 at every odd tap length 3-73 (1 to 10 chunks of 8): shared ragged
    ranks (the length and about half of it), then per-channel stacks of 2
    ranks, with and without the grain, on frames whose H and W are not
    multiples of the 32 x 128 tile (the shorter than the longest taps'
    reach, so the window reflects more than once)."""
    g = torch.Generator(device=device).manual_seed(15)
    rng = np.random.default_rng(15)
    frames = [torch.rand(hw, generator=g, device=device) * 3.0 for hw in ((3, 33, 131), (3, 97, 259))]
    worst = 0.0
    for k in range(3, 75, 2):
        half = 2 * (k // 4) + 1
        shared = ([rng.normal(size=k).astype(np.float32) * 0.1, rng.normal(size=half).astype(np.float32) * 0.1],
                  [rng.normal(size=half).astype(np.float32) * 0.1, rng.normal(size=k).astype(np.float32) * 0.1])
        per_channel = tuple(rng.normal(size=(3, 2, k)).astype(np.float32) * 0.1 for _ in range(2))
        for x in frames:
            for u, v in (shared, per_channel):
                for grain in (None, (seed, prm, grain_ops.grain_corr_taps(0.2 + k / 20.0))):
                    worst = max(worst, max_err(sep_rank.fused_sep_rank(x, u, v, grain),
                                               plain(sep_rank.fused_sep_rank, x, u, v, grain)))
    expect("sep_rank", worst, TOL["sep_rank"],
           "every odd length 3-73, ragged shared and per-channel, with and without grain, 3x33x131 and 3x97x259")


def check_sep_rank(device, full_hw, cfg) -> dict:
    u3, v3 = mtf_ops.mtf_taps(cfg.mtf_key, cfg.scale)
    gtaps = grain_ops.grain_corr_taps(
        grain_ops.correlation_sigma_px(cfg.scale, cfg.grain_size_mm, cfg.grain_sigma)
    )
    print(f"  sep_rank taps {u3.shape}, grain taps {len(gtaps)}")
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=device)
    seed = (0xDEADBEEF, (-7) & 0xFFFFFFFF)
    check_sep_rank_lengths(device, prm, seed)
    g = torch.Generator(device=device).manual_seed(4)
    small = torch.rand((3, 45, 71), generator=g, device=device) * 3.0
    grain = (seed, prm, gtaps)
    expect("sep_rank", max_err(sep_rank.fused_sep_rank(small, u3, v3, grain),
                               plain(sep_rank.fused_sep_rank, small, u3, v3, grain)),
           TOL["sep_rank"], "per-channel + grain 3x45x71")
    expect("sep_rank", max_err(sep_rank.fused_sep_rank(small, u3[0], v3[0]),
                               plain(sep_rank.fused_sep_rank, small, u3[0], v3[0])),
           TOL["sep_rank"], "shared taps 3x45x71")
    lu, lv = (np.random.default_rng(6).normal(size=(2, 2, 63)).astype(np.float32) * 0.02)
    expect("sep_rank", max_err(sep_rank.fused_sep_rank(small, lu, lv, grain),
                               plain(sep_rank.fused_sep_rank, small, lu, lv, grain)),
           TOL["sep_rank"], "63 taps (over 48 KB of shared memory) 3x45x71")
    _, _, by_factor = hal_ops._full_res_ranks(cfg.scale / 4.0 * cfg.halation_size)
    su, sv = hal_ops.pyramid_taps(4, by_factor[4])
    print(f"  sep_rank small-blur ranks of {[len(t) for t in su]} taps")
    expect("sep_rank", max_err(sep_rank.fused_sep_rank(small, su, sv),
                               plain(sep_rank.fused_sep_rank, small, su, sv)),
           TOL["sep_rank"], "ragged shared ranks 3x45x71")
    sm = torch.rand((3, full_hw[0] // 4, full_hw[1] // 4), generator=g, device=device)
    expect("sep_rank", max_err(sep_rank.fused_sep_rank(sm, su, sv),
                               plain(sep_rank.fused_sep_rank, sm, su, sv)),
           TOL["sep_rank"], f"ragged shared ranks {tuple(sm.shape)}")
    blur = lambda: sep_rank.fused_sep_rank(sm, su, sv)  # noqa: E731
    prof = profile_calls(blur, "sep_rank_kernel", 10)
    if prof["h2d_copies"]:
        raise AssertionError(f"sep_rank: a small-blur launch copied to the device: {prof['h2d_copies']}")
    small_blur = {
        "taps": [len(t) for t in su], "ms": med(blur, 20), "device_ms": prof["device_ms"],
        **bound(sm.numel() * 8, roofline.rank_flops(*sep_rank.stack_taps(su, sv), *sm.shape[1:])),
        "library_ms": library_conv_ms(sm, dense_kernels(*sep_rank.stack_taps(su, sv), 3), 5),
    }
    print(f"  sep_rank /4 small blur {tuple(sm.shape)}: {small_blur!r}")
    del sm
    for (x0, y0, ch) in ((0, 0, 0), (8150, 5430, 2)):
        a, b = sep_rank.hash_words_kernel(64, 96, x0, y0, ch, *seed, device)
        pa, pb = grain_ops.hash_words(64, 96, x0, y0, ch, *seed, device=device)
        if not (torch.equal(a, pa) and torch.equal(b, pb)):
            raise AssertionError(f"grain hash words differ at origin {(x0, y0, ch)}")
    print("  sep_rank grain hash words: bit-exact")
    d = torch.rand((3, *full_hw), generator=g, device=device) * 3.0
    got = sep_rank.fused_sep_rank(d, u3, v3, grain)
    err = max_err(got, plain(sep_rank.fused_sep_rank, d, u3, v3, grain))
    expect("sep_rank", err, TOL["sep_rank"], f"per-channel + grain 3x{full_hw[0]}x{full_hw[1]}")
    del got
    px = full_hw[0] * full_hw[1]
    n = len(gtaps)
    launch = lambda: sep_rank.fused_sep_rank(d, u3, v3, grain)  # noqa: E731
    prof = profile_calls(launch, "sep_rank_kernel", 5)
    if prof["h2d_copies"]:
        raise AssertionError(f"sep_rank: an MTF + grain launch copied to the device: {prof['h2d_copies']}")
    print(f"  sep_rank MTF + grain 3x{full_hw[0]}x{full_hw[1]} under the profiler: {prof!r}")
    return {
        "max_abs_err": err,
        "ms": med(launch, 10),
        "plain_ms": med(lambda: plain(sep_rank.fused_sep_rank, d, u3, v3, grain), 3),
        # the ranks, then per output the grain's two correlation passes and
        # its amplitude (about 12 FLOPs); float32 in and out
        **bound(3 * px * 8, roofline.rank_flops(u3, v3, *full_hw) + 3 * px * (4 * n + 12)),
        # the convolution alone: the grain has no library counterpart
        "library_ms": library_conv_ms(d, dense_kernels(u3, v3, 3), 3),
        "device_ms": prof["device_ms"],
        "small_blur": small_blur,
    }


def check_sep_rank_narrow(device) -> dict:
    """K4: the K2 kernel on the narrow preview frame (540 x 360 portrait at
    15 px/mm), which the TPU's K2 declines: the per-channel MTF stack of that
    scale and, with one shared rank, the chroma NR blur of its x and y
    planes; then the burn's small map at 45 MP."""
    g = torch.Generator(device=device).manual_seed(12)
    _, cfg15 = load_film_bundle(h=540, w=360, device=device, grain=2, sharpness=True)
    u3, v3 = mtf_ops.mtf_taps(cfg15.mtf_key, cfg15.scale)
    nr = chroma_nr.cv_gaussian_kernel1d(7, 0.3 * (3.0 - 1.0) + 0.8)[None]
    for shape in ((3, 37, 29), (3, 540, 360)):
        x = torch.rand(shape, generator=g, device=device) * 3.0
        if not sep_rank.tpu_declines(shape[1], shape[2], u3.shape[-1] // 2):
            raise AssertionError(f"K2 should decline {shape}")
        expect("sep_rank_narrow", max_err(sep_rank.fused_sep_rank(x, u3, v3),
                                          plain(sep_rank.fused_sep_rank, x, u3, v3)),
               TOL["sep_rank_narrow"], f"per-channel {u3.shape} {shape}")
        x2 = x[:2].contiguous()
        expect("sep_rank_narrow", max_err(sep_rank.fused_sep_rank(x2, nr, nr),
                                          plain(sep_rank.fused_sep_rank, x2, nr, nr)),
               TOL["sep_rank_narrow"], f"one shared rank of {nr.shape[1]} taps {tuple(x2.shape)}")
    small = torch.rand((1, 49, 74), generator=g, device=device)
    k = gaussian_kernel1d(3.0, truncate=2.0)[None]
    expect("sep_rank_narrow", max_err(sep_rank.fused_sep_rank(small, k, k),
                                      plain(sep_rank.fused_sep_rank, small, k, k)),
           TOL["sep_rank_narrow"], "burn small map 1x49x74")
    err = max_err(sep_rank.fused_sep_rank(x, u3, v3), plain(sep_rank.fused_sep_rank, x, u3, v3))
    px = 540 * 360
    launch = lambda: sep_rank.fused_sep_rank(x, u3, v3)  # noqa: E731
    prof = profile_calls(launch, "sep_rank_kernel", 20)
    if prof["h2d_copies"]:
        raise AssertionError(f"sep_rank_narrow: a launch copied to the device: {prof['h2d_copies']}")
    print(f"  sep_rank_narrow {tuple(x.shape)} under the profiler: {prof!r}")
    # in turns, one call per event pair (after one untimed call): the
    # per-call times of a launch this small swing with the host
    k2d = dense_kernels(u3, v3, 3)
    xp = F.pad(x[None], (k2d.shape[2] // 2,) * 2 + (k2d.shape[1] // 2,) * 2, mode="reflect")
    wt = torch.as_tensor(k2d[:, None], device=device)
    turns = in_turns({"kernel": launch, "conv2d": lambda: F.conv2d(xp, wt, groups=3)}, 100, 1)
    one_call = {"kernel": med(launch, 100), "conv2d": library_conv_ms(x, dense_kernels(u3, v3, 3), 100)}
    print(f"  sep_rank_narrow {tuple(x.shape)}: in turns {turns['kernel']!r} ms per call (CUDA events), "
          f"grouped F.conv2d {turns['conv2d']!r} ms; one call per event pair {one_call!r}; kernel alone "
          f"{prof['device_ms']!r} ms; wrapper on the host {prof['host_ms']!r} ms")
    return {
        "max_abs_err": err,
        "ms": turns["kernel"],
        "plain_ms": med(lambda: plain(sep_rank.fused_sep_rank, x, u3, v3), 5),
        **bound(3 * px * 8, roofline.rank_flops(u3, v3, 540, 360)),
        "library_ms": turns["conv2d"],
        "device_ms": prof["device_ms"],
        "host_ms": prof["host_ms"],
        "one_call": one_call,
    }


def profile_calls(fn, kernel: str, n: int) -> dict:
    """One warm call under torch.profiler, checked for host-to-device
    copies; then n calls for the kernel's own device time (ms per launch,
    kernels whose name holds ``kernel``) and the host time of the wrapper
    alone (ms per call, no synchronize)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    def device_rows(prof):
        rows = []
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(e, "self_device_time_total", None)
                rows.append((e.key, e.count, e.self_cuda_time_total if t is None else t))
        return rows

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as one:
            fn()
            torch.cuda.synchronize()
        rows = device_rows(one)
        if any(kernel in key for key, _, _ in rows):
            break
        # the profiler has returned no device rows at all for one call of a
        # kernel of a few microseconds (K4) on the H100; the next session
        # is taken as the check
        print(f"  profile of one call shows no {kernel} (attempt {attempt}): {rows}")
    else:
        raise AssertionError(f"the profile of one call shows no {kernel}: {rows}")
    h2d = [key for key, _, _ in rows if "HtoD" in key]
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as many:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    launches = sum(c for key, c, _ in device_rows(many) if kernel in key)
    device_us = sum(t for key, _, t in device_rows(many) if kernel in key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return {"device_ms": device_us / 1e3 / max(launches, 1), "launches": launches,
            "host_ms": host_ms, "h2d_copies": h2d}


def conv1d_path(x: torch.Tensor, n: int) -> str:
    """The K5 / K6 path of a launch on x (its output is freshly allocated,
    16-byte aligned) with n taps."""
    p = sep_conv.pack(np.ones(n, np.float32), 0)
    return f"{'16-byte' if sep_conv.vec_path(x.shape[2], x.data_ptr()) else 'scalar'}, " \
           f"{'by value' if p.by_value else 'device buffer'}"


def check_conv1d(device, full_hw, cfg) -> tuple[dict, dict]:
    """K5 and K6 on every path, each bit-equal to the plain version: small
    ragged shapes with 1 to 31 taps (tail runs and tiles, W % 4 != 0: the
    scalar path), 259 and 301 taps (above the by-value cap: the device
    buffer), all-zero taps, an unaligned view; then at 45 MP with the MTF's
    first 23-tap row (16-byte path) and on an unaligned copy (scalar path),
    and with 1 tap. The 45 MP 23-tap launch is profiled (device ms; a
    failure if one call copies anything from the host to the device) and
    timed in turns with F.conv2d; the 1-tap launch and the scalar path in
    turns with it (``by_taps``, ``scalar_path``)."""
    g = torch.Generator(device=device).manual_seed(13)
    taps23 = np.asarray(mtf_ops.mtf_taps(cfg.mtf_key, cfg.scale)[1][0, 0])
    one = np.ones(1, np.float32)
    regs = ptxas_report(r"conv_[hw]_kernel\w*", "K5/K6")
    out = {}
    for name in ("conv_w", "conv_h"):
        fn = getattr(sep_conv, name)
        for shape, n in (((2, 40, 45), 1), ((3, 70, 45), 3), ((1, 71, 37), 9), ((2, 90, 130), 31),
                         ((3, 40, 300), 23), ((2, 29, 261), 23), ((2, 5, 14), 31), ((1, 3, 40), 9),
                         ((1, 1, 1), 3), ((1, 9, 300), 301), ((1, 7, 263), 259), ((1, 11, 12), 0)):
            x = torch.rand(shape, generator=g, device=device)
            t = np.random.default_rng(n).uniform(-0.2, 1.0, max(n, 5))
            t = (t / t.sum()).astype(np.float32) if n else np.zeros(5, np.float32)
            for v in (x, unaligned(x)):
                got, ref = fn(v, t), plain(fn, v, t)
                if not torch.equal(got, ref):
                    raise AssertionError(f"{name} {len(t)} taps {shape}: not bit-equal ({max_err(got, ref)})")
            print(f"  {name} {len(t)} taps {shape}: bit-equal on the {conv1d_path(x, len(t))} path and unaligned")
        x = torch.rand((3, *full_hw), generator=g, device=device)
        off = unaligned(x)
        paths = {}
        for v, t in ((x, taps23), (off, taps23), (x, one)):
            got, ref = fn(v, t), plain(fn, v, t)
            err = max_err(got, ref)
            what = f"{len(t)} taps 3x{full_hw[0]}x{full_hw[1]} ({conv1d_path(v, len(t))} path)"
            expect(name, err, TOL[name], what)
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} {what}: not bit-equal")
            paths[f"{conv1d_path(v, len(t))}, {len(t)} taps"] = err
            del got, ref
        err = paths[f"{conv1d_path(x, len(taps23))}, {len(taps23)} taps"]
        n = int(np.count_nonzero(taps23))
        launch = lambda: fn(x, taps23)  # noqa: E731
        prof = profile_calls(launch, f"{name}_kernel", 10)
        if prof["h2d_copies"]:
            raise AssertionError(f"{name}: a launch copied to the device: {prof['h2d_copies']}")
        k2d = np.repeat(taps23.reshape(1, 1, -1) if name == "conv_w" else taps23.reshape(1, -1, 1), 3, 0)
        xp = F.pad(x[None], (k2d.shape[2] // 2,) * 2 + (k2d.shape[1] // 2,) * 2, mode="reflect")
        wt = torch.as_tensor(k2d[:, None], device=device)
        turns = in_turns({"kernel": launch, "conv2d": lambda: F.conv2d(xp, wt, groups=3),
                          "scalar_path": lambda: fn(off, taps23), "one_tap": lambda: fn(x, one)}, 10, 3)
        del xp
        prof1 = profile_calls(lambda: fn(x, one), f"{name}_kernel", 10)
        print(f"  {name} 3x{full_hw[0]}x{full_hw[1]} in turns (ms): {turns!r}; profiler, 23 taps {prof!r}; "
              f"1 tap {prof1!r}; errors by path {paths!r}")
        out[name] = {
            "max_abs_err": err,
            "ms": med(launch, 20),
            "plain_ms": med(lambda: plain(fn, x, taps23), 3),
            **bound(x.numel() * 8, x.numel() * 2 * n),
            "library_ms": library_conv_ms(x, k2d, 10),
            "device_ms": prof["device_ms"],
            "in_turns": turns,
            "by_taps": {"1": {"in_turns": turns["one_tap"], "device_ms": prof1["device_ms"],
                              **bound(x.numel() * 8, x.numel() * 2)}},
            "scalar_path": {"in_turns": turns["scalar_path"]},
            "registers": {k: v for k, v in regs.items() if name in k},
        }
        del x, off
    return out["conv_w"], out["conv_h"]


# a correlation sigma for each K7 / K8 path (ops/grain.py::grain_path):
# white noise, 3 and 5 taps compiled in, the general path (13 taps)
PATH_SIGMAS = {1: 0.2, 3: 0.547, 5: 0.8, 13: 2.3}


def grain_path_name(n: int, w: int, *ptrs) -> str:
    path = grain_ops.grain_path(n)
    if path == "general":
        return f"general, {n} taps"
    return f"{path}, {n} taps, {'16-byte' if grain_ops.vec_path(w, *ptrs) else 'scalar'}"


def grain_frames(cfg, full_hw) -> dict:
    """The frames K7 and K8 are timed at: the 45 MP frame with its 3 taps and
    the half-size frame (the CLI default) with its 1 tap."""
    frames = {}
    for hw, scale in ((full_hw, cfg.scale), ((full_hw[0] // 2, full_hw[1] // 2), cfg.scale / 2)):
        sigma = grain_ops.correlation_sigma_px(scale, cfg.grain_size_mm, cfg.grain_sigma)
        frames[f"{hw[0]}x{hw[1]}"] = (hw, sigma, len(grain_ops.grain_corr_taps(sigma)))
    if [n for _, _, n in frames.values()] != [3, 1]:
        raise AssertionError(f"K7/K8 frames: want 3 and 1 taps, got {frames}")
    return frames


def check_grain_field(device, full_hw, cfg) -> dict:
    """K7, colour and black-and-white, on every path at ragged shapes (W a
    multiple of 4 or not), then at the 45 MP frame (3 taps) and the
    half-size frame (1 tap), each timed beside its bound (``by_frame``); the
    45 MP colour field is the one in the main keys."""
    seed = (0xDEADBEEF, (-7) & 0xFFFFFFFF)
    frames = grain_frames(cfg, full_hw)
    small = [((70, 96), 1), ((45, 71), 1), ((45, 71), 3), ((70, 132), 3), ((37, 53), 5), ((64, 260), 5),
             ((37, 53), 13), ((70, 96), 13)]
    for bw in (True, False):
        for hw, n in small:
            args = (seed, hw, PATH_SIGMAS[n])
            err = max_err(grain_ops.grain_field(*args, bw=bw, device=device),
                          plain(grain_ops.grain_field, *args, bw=bw, device=device))
            expect("grain_field", err, TOL["grain_field"], f"bw={bw} {hw} ({grain_path_name(n, hw[1], 0)})")
    by_frame = {}
    for name, (hw, sigma, n) in frames.items():
        for bw in (True, False):
            args = (seed, hw, sigma)
            got = grain_ops.grain_field(*args, bw=bw, device=device)
            ref = plain(grain_ops.grain_field, *args, bw=bw, device=device)
            err = max_err(got, ref)
            expect("grain_field", err, TOL["grain_field"],
                   f"bw={bw} {hw} ({grain_path_name(n, hw[1], got.data_ptr())}; bit-equal: {torch.equal(got, ref)})")
            del got, ref
        numel = 3 * hw[0] * hw[1]
        launch = lambda: grain_ops.grain_field(seed, hw, sigma, device=device)  # noqa: E731
        by_frame[name] = {
            "taps": n, "max_abs_err": err, "ms": med(launch, 20),
            "plain_ms": med(lambda: plain(grain_ops.grain_field, seed, hw, sigma, device=device), 3),
            # written once; per output the two correlation passes
            **bound(numel * 4, numel * 4 * n),
        }
        print(f"  grain_field {name} ({n} taps): {by_frame[name]!r}")
    main = by_frame[next(iter(frames))]
    return {**{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
            "by_frame": by_frame}


def ptxas_report(pattern: str, label: str) -> dict:
    """Registers, stack frame and spills of each kernel whose mangled name
    holds a match of ``pattern``, from the build's ``nvcc -Xptxas -v``
    report (empty when this process did not build the library)."""
    import re

    found, name = {}, None
    for line in kb.build_log.splitlines():
        m = re.search(rf"Compiling entry function '\w*?({pattern})", line)
        if m:
            name = m.group(1)
            found[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[name]["registers"] = int(m.group(1))
            name = None
    for k, v in found.items():
        print(f"  {label} kernel {k}: {v}")
    if not found:
        print(f"  {label} kernels: no ptxas report (the library was not built by this process)")
    return found


def grain_registers() -> dict:
    """K7's and K8's kernels in the ptxas report; fails if one has a stack
    frame or spills."""
    found = ptxas_report(r"grain_(?:white|taps|general)_kernel(?:I\w+?EE)?", "K7/K8")
    for k, v in found.items():
        if v.get("stack", 1) or v.get("spill_stores", 1) or v.get("spill_loads", 1):
            raise AssertionError(f"{k}: a stack frame or spills: {v}")
    return found


def check_print_encode(device, full_hw, bundle, cfg) -> dict:
    pvec = bundle["pvec_host"]  # the host copy the render hands K3
    if not np.array_equal(pvec, pe.pack_print_vec(bundle).cpu().numpy()):
        raise AssertionError("print_encode: the bundle's pvec_host differs from its packed device entries")
    g = torch.Generator(device=device).manual_seed(5)
    d = torch.rand((3, 37, 300), generator=g, device=device) * 3.5
    dodd = torch.rand((3, 37, 301), generator=g, device=device) * 3.5
    worst = {}
    for x in (d, dodd):  # the 16-byte path and the scalar one
        for mode in ("print", "inversion"):
            for gamma in ("sRGB", "Rec709", "Gamma 2.2", "Gamma 2.4", "ARRI LogC3", "Linear"):
                for quantize in (True, False):
                    args = (x, pvec, mode, mode == "print", gamma != "sRGB", gamma, quantize)
                    tol = TOL["print_encode"] if quantize else TOL["print_encode_float"]
                    err = max_err(pe.print_encode(*args), plain(pe.print_encode, *args))
                    expect("print_encode", err, tol, f"{mode} {gamma} quantize={quantize} 3x37x{x.shape[2]}")
                    worst[gamma, quantize] = max(worst.get((gamma, quantize), 0.0), err)
    print(f"  print_encode worst error by gamma (float, then uint8): "
          f"{ {f'{k[0]} {k[1]}': v for k, v in worst.items()}!r}")
    wide = (
        torch.rand((3, 2000), generator=g, device=device),
        torch.rand((37, 3), generator=g, device=device) / 3,
        torch.rand((2000, 300), generator=g, device=device) / 2000,
    )
    args = (d, pvec, "print", False, True, "sRGB", True, wide)
    expect("print_encode", max_err(pe.print_encode(*args), plain(pe.print_encode, *args)),
           TOL["print_encode"], "burn with a 2000-wide map (over 48 KB of shared memory)")
    dfull = torch.rand((3, *full_hw), generator=g, device=device) * 2.5
    burn = burn_ops.burn_smallmap(dfull, bundle["d_ref_green"], cfg.burn_scale)
    if burn is None:
        raise AssertionError("the 45 MP burn should take the small-map path")
    print(f"  print_encode burn small map {tuple(burn[0].shape)}")
    args = (dfull, pvec, cfg.print_mode, cfg.shadow_comp, cfg.sat_neutral, cfg.gamma_func, True, burn)
    err = max_err(pe.print_encode(*args), plain(pe.print_encode, *args))
    expect("print_encode", err, TOL["print_encode"], f"burn 3x{full_hw[0]}x{full_hw[1]}")
    no_burn = args[:-1]
    expect("print_encode", max_err(pe.print_encode(*no_burn), plain(pe.print_encode, *no_burn)),
           TOL["print_encode"], f"no burn 3x{full_hw[0]}x{full_hw[1]}")
    prof = profile_calls(lambda: pe.print_encode(*args), "print_encode_kernel", 5)
    if prof["h2d_copies"]:
        raise AssertionError(f"print_encode: a launch copied to the device: {prof['h2d_copies']}")
    turns = in_turns({"burn": lambda: pe.print_encode(*args), "no_burn": lambda: pe.print_encode(*no_burn)}, 10, 2)
    print(f"  print_encode 3x{full_hw[0]}x{full_hw[1]} in turns: with the burn {turns['burn']!r} ms, without "
          f"{turns['no_burn']!r} ms; profiler {prof!r}")
    px = full_hw[0] * full_hw[1]
    hs, ws = burn[0].shape
    return {
        "max_abs_err": err,
        "ms": med(lambda: pe.print_encode(*args), 20),
        "plain_ms": med(lambda: plain(pe.print_encode, *args), 5),
        # 3 float32 in, 3 uint8 out (the burn's matrices are read from L2);
        # per pixel the burn's two products (ws + hs ws / H MACs), the print
        # curves (about 3 x 30 FLOPs with their exp2/log2), the 3x3 mixes
        # and the encode
        **bound(px * (12 + 3), px * (150 + 2 * ws) + 2 * full_hw[0] * hs * ws),
        "library_ms": None,
        "no_burn_ms": med(lambda: pe.print_encode(*no_burn), 20),
        "in_turns": turns,
        "device_ms": prof["device_ms"],
    }


def in_turns(fns: dict, rounds: int, per: int) -> dict:
    """ms per call of each function, timed in turns (a, b, a, b, ...) so
    that clock and power drift fall on all of them alike: each turn queues
    one untimed call, then a CUDA event pair around ``per`` more, so the
    device is busy when the first event is recorded and no timed call waits
    for its launch; the median over ``rounds`` turns."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            fn()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per):
                fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / per)
    return {name: statistics.median(t) for name, t in times.items()}


def rows_path(x: torch.Tensor) -> str:
    """The K12 path an input takes (its output is freshly allocated)."""
    return "16-byte" if pyramid.rows_vec_path(x.shape[2], x.data_ptr()) else "scalar"


def check_pyramid(device, full_hw) -> tuple[dict, dict]:
    """K10 on both paths (the 16-byte one: f = 4 or 8, W a multiple of 4,
    the input aligned; the one-thread-per-output one: W % 4 != 0, f = 3 or
    12, and a contiguous view 4 bytes into its storage), then at 45 MP,
    timed in turns with F.avg_pool2d; K12 at small crops on both paths,
    then on both at the 45 MP and 24 MP /4 levels."""
    g = torch.Generator(device=device).manual_seed(7)
    for shape, f in (((3, 37, 53), 3), ((3, 38, 55), 4), ((2, 9, 9), 4), ((1, 40, 64), 1), ((3, 38, 260), 4),
                     ((3, 37, 252), 4), ((2, 45, 136), 8), ((1, 50, 96), 12)):
        x = torch.rand(shape, generator=g, device=device) * 3.0
        vec = pyramid.box_vec_path(f, shape[2], x.data_ptr())
        expect("pyramid_down", max_err(pyramid.box_downsample_pyramid(x, f),
                                       plain(pyramid.box_downsample_pyramid, x, f)),
               TOL["pyramid_down"], f"f={f} {shape} ({'16-byte' if vec else 'scalar'} path)")
    base = torch.rand(3 * 40 * 64 + 1, generator=g, device=device) * 3.0
    x = base[1:].view(3, 40, 64)  # contiguous, 4 bytes past a 16-byte boundary
    if pyramid.box_vec_path(4, 64, x.data_ptr()):
        raise AssertionError("an unaligned view should take the scalar path")
    expect("pyramid_down", max_err(pyramid.box_downsample_pyramid(x, 4), plain(pyramid.box_downsample_pyramid, x, 4)),
           TOL["pyramid_down"], "f=4 (3, 40, 64) unaligned view (scalar path)")
    for shape, f, oh in (((3, 11, 29), 4, 41), ((3, 11, 29), 4, None), ((2, 7, 30), 3, 20), ((3, 11, 32), 4, 41),
                         ((3, 40, 260), 4, None), ((1, 7, 64), 8, 53)):
        x = torch.rand(shape, generator=g, device=device) * 3.0
        expect("pyramid_up_rows", max_err(pyramid.bilinear_upsample_rows(x, f, oh),
                                          plain(pyramid.bilinear_upsample_rows, x, f, oh)),
               TOL["pyramid_up_rows"], f"f={f} oh={oh} {shape} ({rows_path(x)} path)")
    h, w = full_hw
    x = torch.rand((3, h, w), generator=g, device=device) * 3.0
    if not pyramid.box_vec_path(4, w, x.data_ptr()):
        raise AssertionError("the 45 MP frame should take K10's 16-byte path")
    err = max_err(pyramid.box_downsample_pyramid(x, 4), plain(pyramid.box_downsample_pyramid, x, 4))
    expect("pyramid_down", err, TOL["pyramid_down"], f"f=4 3x{h}x{w} (16-byte path)")
    # kernel, call, kernel, call: the two were within one run's spread
    turns = in_turns({"kernel": lambda: pyramid.box_downsample_pyramid(x, 4),
                      "avg_pool2d": lambda: F.avg_pool2d(x[None], 4)}, 20, 5)
    one_call = {"kernel": med(lambda: pyramid.box_downsample_pyramid(x, 4), 20),
                "avg_pool2d": med(lambda: F.avg_pool2d(x[None], 4), 20)}
    x8 = torch.rand((3, h // 8 * 8, w), generator=g, device=device)
    err8 = max_err(pyramid.box_downsample_pyramid(x8, 8), plain(pyramid.box_downsample_pyramid, x8, 8))
    expect("pyramid_down", err8, TOL["pyramid_down"], f"f=8 {tuple(x8.shape)} (16-byte path)")
    f8 = in_turns({"kernel": lambda: pyramid.box_downsample_pyramid(x8, 8),
                   "avg_pool2d": lambda: F.avg_pool2d(x8[None], 8)}, 10, 5)
    del x8
    print(f"  pyramid_down f=4 3x{h}x{w}, in turns (20 turns of 5 calls each): kernel {turns['kernel']!r} ms, "
          f"F.avg_pool2d {turns['avg_pool2d']!r} ms; one call per event pair (median of 20): kernel "
          f"{one_call['kernel']!r} ms, F.avg_pool2d {one_call['avg_pool2d']!r} ms; f=8 in turns: kernel "
          f"{f8['kernel']!r} ms, F.avg_pool2d {f8['avg_pool2d']!r} ms")
    down = {
        "max_abs_err": err,
        "ms": turns["kernel"],
        "plain_ms": med(lambda: plain(pyramid.box_downsample_pyramid, x, 4), 5),
        **bound(x.numel() * 4 * (1 + 1 / 16), x.numel()),
        "library_ms": turns["avg_pool2d"],
        "one_call": one_call,
        "f8": {"ms": f8["kernel"], "library_ms": f8["avg_pool2d"]},
    }
    del x
    # K12 on both paths at the 45 MP and 24 MP /4 levels (the 16-byte path,
    # and the scalar one on an unaligned copy), each within its tolerance
    # (bit-equality reported); the 45 MP level timed on both, in turns
    by_frame = {}
    for fh, fw in ((h, w), (H24, W24)):
        s = torch.rand((3, fh // 4, fw // 4), generator=g, device=device) * 3.0
        s_off = unaligned(s)
        if (rows_path(s), rows_path(s_off)) != ("16-byte", "scalar"):
            raise AssertionError(f"K12 paths at {tuple(s.shape)}: {rows_path(s)}, {rows_path(s_off)}")
        errs = {}
        for x in (s, s_off):
            got = pyramid.bilinear_upsample_rows(x, 4, fh)
            ref = plain(pyramid.bilinear_upsample_rows, x, 4, fh)
            errs[rows_path(x)] = max_err(got, ref)
            expect("pyramid_up_rows", errs[rows_path(x)], TOL["pyramid_up_rows"],
                   f"f=4 {tuple(x.shape)} -> {fh} rows ({rows_path(x)} path; bit-equal: {torch.equal(got, ref)})")
        by_frame[f"{fh}x{fw}"] = errs
        if fh == h:
            launch = lambda: pyramid.bilinear_upsample_rows(s, 4, h)  # noqa: E731
            turns = in_turns({"16-byte": launch, "scalar": lambda: pyramid.bilinear_upsample_rows(s_off, 4, h)}, 10, 5)
            up = {
                "max_abs_err": errs["16-byte"],
                "ms": med(launch, 20),
                "plain_ms": med(lambda: plain(pyramid.bilinear_upsample_rows, s, 4, h), 5),
                # read the /4 level, write 4x its rows; a lerp (3 FLOPs) per output
                **bound(s.numel() * 4 * 5, s.numel() * 4 * 3),
                "library_ms": med(lambda: F.interpolate(s[None], size=(s.shape[1] * 4, s.shape[2]), mode="bilinear",
                                                        align_corners=False)[..., :h, :], 20),
                "in_turns": turns,
            }
        del s_off
    up["by_frame"] = by_frame
    print(f"  pyramid_up_rows f=4 (3, {h // 4}, {w // 4}) -> {h} rows: in turns {up['in_turns']!r} ms; errors by "
          f"frame and path {by_frame!r}")
    return down, up


def halation_inputs(hw, size, g, device):
    """Exposure, ranks and a row-upsampled pyramid blur at frame size hw."""
    us, vs, _ = hal_ops._full_res_ranks(size)
    img = torch.rand((3, *hw), generator=g, device=device) * 2.0
    rows_up = torch.rand((3, hw[0], -(-hw[1] // 4)), generator=g, device=device) * 0.5
    return img, us, vs, rows_up


def check_halation(device, bundle, cfg) -> dict:
    """K14, colour and black-and-white, with and without the development:
    the 45 MP stack (27 taps), the 24 MP one (43) and the longest ones (49
    taps, 4 and 5 ranks) at the edges of the 32 x 128 tile (H and W one and
    three past a tile multiple, W not a multiple of 4); then a profiled
    call (no host-to-device copy) and the 45 MP and 24 MP frames, timed."""
    g = torch.Generator(device=device).manual_seed(8)
    colour, bw = hal_ops.colour_factors(bundle, False), hal_ops.colour_factors(bundle, True)
    devvec = hal_ops.develop_vector(bundle)
    size = cfg.scale / 4.0 * cfg.halation_size
    print(f"  halation ranks {len(hal_ops._full_res_ranks(size)[0])} x "
          f"{len(hal_ops._full_res_ranks(size)[0][0])} taps (size {size!r})")
    for hsize, hw in ((size, (44, 72)), (size, (33, 259)), (size, (67, 131)), (41.7, (35, 129)),
                      (50.0, (65, 387)), (112.0, (33, 131))):
        img, us, vs, rows_up = halation_inputs(hw, hsize, g, device)
        for fname, fac in (("colour", colour), ("bw", bw)):
            for dv in (None, devvec):
                args = (img, us, vs, rows_up, fac, dv)
                tol = TOL["halation"] if dv is None else TOL["halation_density"]
                expect("halation", max_err(hal_ops.halation_mega(*args), plain(hal_ops.halation_mega, *args)),
                       tol, f"{len(us)}x{len(us[0])} taps {fname} develop={dv is not None} 3x{hw[0]}x{hw[1]}")
    result, times = None, {}
    for hw in ((H, W), (H24, W24)):
        size_hw = max(hw) / 36.0 / 4.0 * cfg.halation_size
        img, us, vs, rows_up = halation_inputs(hw, size_hw, g, device)
        for dv in (None, devvec):
            args = (img, us, vs, rows_up, colour, dv)
            tol = TOL["halation"] if dv is None else TOL["halation_density"]
            err = max_err(hal_ops.halation_mega(*args), plain(hal_ops.halation_mega, *args))
            expect("halation", err, tol, f"{len(us)}x{len(us[0])} taps develop={dv is not None} 3x{hw[0]}x{hw[1]}")
        launch = lambda: hal_ops.halation_mega(*args)  # noqa: E731
        if result is None:
            prof = profile_calls(launch, "halation_kernel", 5)
            if prof["h2d_copies"]:
                raise AssertionError(f"halation: a launch copied to the device: {prof['h2d_copies']}")
            print(f"  halation {hw[0]}x{hw[1]} under the profiler: {prof!r}")
        ms = med(launch, 20)
        plain_ms = med(lambda: plain(hal_ops.halation_mega, *args), 3)
        u2, v2 = sep_rank.stack_taps(us, vs)
        numel = img.numel()
        # the exposure and the /4 rows in, the density out; the shared ranks
        # on 3 channels, then per output the x4 lerp, the combine and the
        # development (about 60 FLOPs)
        b = bound(4 * (2 * numel + rows_up.numel()), roofline.rank_flops(u2, v2, *hw) + numel * 60)
        times[f"{hw[0]}x{hw[1]}"] = {"taps": [len(us), len(us[0])], "ms": ms, "plain_ms": plain_ms, **b}
        print(f"  halation {hw[0]}x{hw[1]} ({len(us)} x {len(us[0])} taps, develop): {ms!r} ms vs plain "
              f"{plain_ms!r} ms, bound {b['bound_ms']!r} ms ({b['bound_by']})")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None,
                      "device_ms": prof["device_ms"]}
        del img, rows_up, args, launch
    result["by_frame"] = times
    return result


def check_half_size(device, full_hw) -> dict:
    g = torch.Generator(device=device).manual_seed(9)
    for pattern in dm.PATTERNS:
        codes = mosaic_codes(37, 53, 4, device)
        expect("half_size", max_err(dm.half_size_decode(codes, pattern, NORM),
                                    plain(dm.half_size_decode, codes, pattern, NORM)),
               TOL["half_size"], f"u16+norm 37x53 {pattern}")
        f = torch.rand((37, 53), generator=g, device=device)
        expect("half_size", max_err(dm.half_size_decode(f, pattern), plain(dm.half_size_decode, f, pattern)),
               TOL["half_size"], f"f32 37x53 {pattern}")
    codes = mosaic_codes(*full_hw, 3, device)
    err = max_err(dm.half_size_decode(codes, "RGGB", NORM), plain(dm.half_size_decode, codes, "RGGB", NORM))
    expect("half_size", err, TOL["half_size"], f"u16+norm {full_hw[0]}x{full_hw[1]}")
    px = full_hw[0] * full_hw[1]
    return {
        "max_abs_err": err,
        "ms": med(lambda: dm.half_size_decode(codes, "RGGB", NORM), 20),
        "plain_ms": med(lambda: plain(dm.half_size_decode, codes, "RGGB", NORM), 5),
        # u16 mosaic in, 3 float32 planes of a quarter of its size out
        **bound(px * 2 + px // 4 * 12, px * 3),
        "library_ms": None,
    }


def check_exposure_sample(device, full_hw) -> dict:
    """K15 against the host estimate (its plain version): the power mean
    within TOL relative on small frames (odd and even, the general path and
    the 16-byte one) of both dtypes and every phase, codes from below black
    to above white; then the 45 MP frame, timed with CUDA events (the
    launch, no fetch) beside its bytes bound, and the wrapper with its
    8-byte fetch on the host clock."""
    cam = np.array([[0.41, 0.36, 0.18], [0.21, 0.72, 0.07], [0.02, 0.12, 0.95]], np.float32)
    factor = float(np.sqrt(4.0**2 / 100 / (1 / 125)) + 1.0)  # ISO 100, 1/125 s, f/4
    g = torch.Generator(device=device).manual_seed(15)

    def rel_err(x, pattern):
        got = dm.exposure_power_mean(x, pattern, cam, NORM, factor)
        return abs(got / plain(dm.exposure_power_mean, x, pattern, cam, NORM, factor) - 1.0)

    for pattern in dm.PATTERNS:
        for hw in ((37, 53), (42, 66), (40, 64)):
            codes = torch.randint(0, 17000, hw, generator=g, device=device, dtype=torch.int32)
            expect("exposure_sample", rel_err(codes.to(torch.uint16), pattern), TOL["exposure_sample"],
                   f"u16 {hw[0]}x{hw[1]} {pattern} (relative)")
            expect("exposure_sample", rel_err(codes.to(torch.float32) + 0.25, pattern), TOL["exposure_sample"],
                   f"f32 {hw[0]}x{hw[1]} {pattern} (relative)")
    codes = mosaic_codes(*full_hw, 3, device)
    err = rel_err(codes, "RGGB")
    expect("exposure_sample", err, TOL["exposure_sample"], f"u16 {full_hw[0]}x{full_hw[1]} (relative)")
    n_i = (full_hw[0] // 2 + 1) // 2
    fetch = [host_ms(lambda: dm.exposure_power_mean(codes, "RGGB", cam, NORM, factor), sync=False)[1]
             for _ in range(10)]
    return {
        "max_rel_err": err,
        "ms": med(lambda: dm.exposure_sum(codes, "RGGB", cam, NORM, factor), 20),
        "plain_ms": med(lambda: plain(dm.exposure_power_mean, codes, "RGGB", cam, NORM, factor), 3),
        "with_fetch_host_ms": statistics.median(fetch),
        # rows 4i and 4i + 1 read whole (u16); per sample 4 normalizes, the
        # green, the Y row (15 operations) and a powf, counted as one
        **bound(n_i * 2 * full_hw[1] * 2, dm.exposure_samples(*full_hw) * 16),
        "library_ms": None,
    }


def develop_exposure(shape, g, device) -> torch.Tensor:
    """Exposures over the H&D curve's whole range, with zeros and negatives
    (the 1e-6 clamp)."""
    ep = torch.rand(shape, generator=g, device=device) ** 3 * 20.0 - 0.05
    ep.view(-1)[::7] = 0.0
    return ep


def check_develop(device, full_hw, bundle) -> dict:
    """K16 against the plain development: both paths (16-byte: H * W a
    multiple of 4, aligned; 4-byte: W = 1, 3, 5, 8207, H = 1, an unaligned
    view), the halation-off bundle, colour masking 0.5 and a black-and-white
    negative; then a profiled call (no host-to-device copy), the 45 MP frame
    and the CLI default's 2000 x 3000, timed in turns with the plain
    development beside the bytes bound, and the kernel's registers (a
    failure on a stack frame or spills)."""
    g = torch.Generator(device=device).manual_seed(16)
    films = {
        "identity": bundle,
        "masking 0.5": load_film_bundle(device=device, halation=False, color_masking=0.5)[0],
        "Kodak Tri-X 400": load_film_bundle("Kodak Tri-X 400", device=device, halation=False)[0],
    }
    for hw in ((45, 70), (7, 1), (7, 3), (7, 5), (5, 8207), (1, 8208), (1, 5), (1, 1)):
        ep = develop_exposure((3, *hw), g, device)
        for fname, b in films.items():
            expect("develop", max_err(trender._develop(ep, b), plain(trender._develop, ep, b)), TOL["develop"],
                   f"3x{hw[0]}x{hw[1]} {fname} ({'16-byte' if hw[0] * hw[1] % 4 == 0 else '4-byte'})")
    ep = develop_exposure((3 * 37 * 76 + 1,), g, device)[1:].view(3, 37, 76)
    expect("develop", max_err(trender._develop(ep, bundle), plain(trender._develop, ep, bundle)), TOL["develop"],
           "3x37x76 unaligned view (4-byte)")
    result, times = None, {}
    for hw in (full_hw, (2000, 3000)):
        ep = develop_exposure((3, *hw), g, device)
        err = max(max_err(trender._develop(ep, b), plain(trender._develop, ep, b)) for b in films.values())
        expect("develop", err, TOL["develop"], f"3x{hw[0]}x{hw[1]} (16-byte)")
        launch = lambda: trender._develop(ep, bundle)  # noqa: E731
        prof = profile_calls(launch, "develop_kernel", 10)
        if prof["h2d_copies"]:
            raise AssertionError(f"develop: a launch copied to the device: {prof['h2d_copies']}")
        turns = in_turns({"kernel": launch, "plain": lambda: plain(trender._develop, ep, bundle)}, 5, 3)
        px = hw[0] * hw[1]
        # the exposure in and the density out, 24 B a pixel; 31 operations a
        # value, as portbench/metrics/develop_roofline.render.py counts them
        b = bound(24 * px, 31 * 3 * px)
        times[f"{hw[0]}x{hw[1]}"] = {"ms": turns["kernel"], "plain_ms": turns["plain"],
                                     "device_ms": prof["device_ms"], "host_ms": prof["host_ms"], **b}
        print(f"  develop {hw[0]}x{hw[1]}: {turns['kernel']!r} ms in turns (device {prof['device_ms']!r}, "
              f"host {prof['host_ms']!r}) vs plain {turns['plain']!r} ms, bound {b['bound_ms']!r} ms "
              f"({b['bound_by']}): {b['bound_ms'] / prof['device_ms'] * 100.0!r} % of it")
        if result is None:
            result = {"max_abs_err": err, "ms": turns["kernel"], "plain_ms": turns["plain"], **b,
                      "library_ms": None, "device_ms": prof["device_ms"]}
        del ep, launch
    regs = ptxas_report(r"develop_kernel(?:I\w+?EE)?", "K16")
    for k, v in regs.items():
        if v.get("stack", 1) or v.get("spill_stores", 1) or v.get("spill_loads", 1):
            raise AssertionError(f"{k}: a stack frame or spills: {v}")
    result["by_frame"], result["registers"] = times, regs
    return result


def check_upsample(device, full_hw) -> dict:
    """Small ragged crops, then the /4 and /8 levels of the 45 MP frame back
    to full size (phase e's shapes), each timed beside F.interpolate; the
    /8 level is the one in the main keys, both are under ``by_factor``."""
    g = torch.Generator(device=device).manual_seed(10)
    for shape, f, out_hw in (((3, 11, 29), 4, (41, 115)), ((2, 7, 9), 8, (50, 70)), ((1, 5, 6), 3, None),
                             ((3, 40, 70), 8, (301, 557)), ((2, 45, 71), 3, (118, 209))):
        x = torch.rand(shape, generator=g, device=device) * 3.0
        expect("pyramid_up", max_err(pyramid.bilinear_upsample(x, f, out_hw),
                                     plain(pyramid.bilinear_upsample, x, f, out_hw)),
               TOL["pyramid_up"], f"f={f} {shape} -> {out_hw}")
    by_factor = {}
    for f in (4, 8):
        s_ = torch.rand((3, full_hw[0] // f, full_hw[1] // f), generator=g, device=device)
        err = max_err(pyramid.bilinear_upsample(s_, f, full_hw), plain(pyramid.bilinear_upsample, s_, f, full_hw))
        expect("pyramid_up", err, TOL["pyramid_up"], f"f={f} {tuple(s_.shape)} -> {full_hw}")
        ms = med(lambda: pyramid.bilinear_upsample(s_, f, full_hw), 20)
        plain_ms = med(lambda: plain(pyramid.bilinear_upsample, s_, f, full_hw), 5)
        library_ms = med(lambda: F.interpolate(
            s_[None], size=(s_.shape[1] * f, s_.shape[2] * f), mode="bilinear",
            align_corners=False)[..., : full_hw[0], : full_hw[1]], 20)
        out_numel = 3 * full_hw[0] * full_hw[1]
        by_factor[str(f)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            # the level in, the full frame out; a 2-D lerp (6 FLOPs) per output
            **bound(4 * (s_.numel() + out_numel), 6 * out_numel),
            "library_ms": library_ms,
        }
        print(f"  pyramid_up f={f} {tuple(s_.shape)} -> {full_hw}: {ms!r} ms vs plain {plain_ms!r} ms, "
              f"F.interpolate {library_ms!r} ms, bound {by_factor[str(f)]['bound_ms']!r} ms")
        del s_
    return {**by_factor["8"], "by_factor": by_factor}


def check_grain_apply(device, full_hw, cfg) -> tuple[dict, dict]:
    """K8 on every path at small ragged shapes (W a multiple of 4 or not, an
    unaligned view), K9 with 3 and 13 taps; both at the half-size frame with
    its white-noise grain (phases c and d) and at the 45 MP frame with its
    3 taps. K8 is timed at both frames beside its bound (``by_frame``), K9
    at 45 MP; the 45 MP times are in the main keys."""
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=device)
    seed = (0xDEADBEEF, (-7) & 0xFFFFFFFF)
    g = torch.Generator(device=device).manual_seed(11)
    frames = grain_frames(cfg, full_hw)
    full = next(iter(frames))
    out = {}
    for bw, name in ((False, "grain_apply"), (True, "grain_apply_bw")):
        small = ([((3, 45, 71), 3), ((3, 45, 71), 13)] if bw else
                 [((3, 45, 71), 1), ((3, 45, 72), 1), ((3, 45, 71), 3), ((3, 45, 72), 3), ((3, 37, 53), 5),
                  ((3, 64, 260), 5), ((3, 45, 71), 13), ((3, 70, 132), 13)])
        for shape, n in small:
            d = torch.rand(shape, generator=g, device=device) * 3.0
            for x in ([d] if bw else [d, unaligned(d)]):
                args = (x, seed, PATH_SIGMAS[n], prm, bw)
                what = f"{shape}, {n} taps" if bw else f"{shape} ({grain_path_name(n, shape[2], x.data_ptr())})"
                expect(name, max_err(grain_ops.grain_apply(*args), plain(grain_ops.grain_apply, *args)), TOL[name], what)
        by_frame = {}
        for fname, (hw, sigma, n) in reversed(frames.items()):
            d = torch.rand((3, *hw), generator=g, device=device) * 3.0
            args = (d, seed, sigma, prm, bw)
            err = max_err(grain_ops.grain_apply(*args), plain(grain_ops.grain_apply, *args))
            path = f", {n} taps" if bw else f" ({grain_path_name(n, hw[1], d.data_ptr())})"
            expect(name, err, TOL[name], f"3x{hw[0]}x{hw[1]}{path}")
            if bw and fname != full:
                continue
            fields = 1 if bw else 3
            by_frame[fname] = {
                "taps": n, "max_abs_err": err,
                "ms": med(lambda: grain_ops.grain_apply(*args), 20),
                "plain_ms": med(lambda: plain(grain_ops.grain_apply, *args), 3),
                # density in and out; per field value the two correlation
                # passes, per density the amplitude (about 12 FLOPs) and the add
                **bound(d.numel() * 8, d.numel() // 3 * fields * 4 * n + d.numel() * 14),
            }
            print(f"  {name} {fname} ({n} taps): {by_frame[fname]!r}")
            del d, args
        main = by_frame[full]
        out[name] = {**{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
                     "library_ms": None, **({} if bw else {"by_frame": by_frame})}
    return out["grain_apply"], out["grain_apply_bw"]


# ------------------------------------------------------------ main path


def main_path(device, codes, bundle, cfg, card: str, want: dict, label: str):
    """One checked render, counted launches, then timings."""
    cam = ref_data.REC709_TO_XYZ

    def render():
        return render_chain_from_mosaic(codes, cam, bundle, cfg, SEED, norm=NORM, device=device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    out = render()
    torch.cuda.synchronize()
    launches = dict(kb.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: launches {launches}")
    print(f"{label}: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want} per render")
    if out.dtype != torch.uint8 or tuple(out.shape) != (3, H, W):
        raise AssertionError(f"output {out.dtype} {tuple(out.shape)}")
    ref = plain(render)
    diff = (out.to(torch.int16) - ref.to(torch.int16)).abs()
    worst = int(diff.max())
    equal = float((diff == 0).to(torch.float64).mean())
    print(f"{label} vs plain versions on the card: max {worst} code, {equal!r} of codes equal")
    if worst > 1:
        raise AssertionError(f"{label} differs from the plain path by {worst} codes")
    mean = out.to(torch.float64).mean().item()
    print(f"{label}: output mean {mean!r}")
    if not 10.0 < mean < 245.0:
        raise AssertionError(f"implausible output mean {mean}")
    del ref, diff, out

    ms = cuda_ms(render, 10, warmup=2)
    plain_ms = cuda_ms(lambda: plain(render), 3)
    mp = H * W / 1e6
    med, best = statistics.median(ms), min(ms)
    print(
        f"{label} {H}x{W} on {card}: median {med!r} ms/frame "
        f"({mp / med * 1e3!r} MP/s), best {best!r} ms ({mp / best * 1e3!r} MP/s), "
        f"plain versions median {statistics.median(plain_ms)!r} ms; all ms {ms!r}"
    )
    timing = {
        "ms": med, "best_ms": best, "mp_per_s": mp / med * 1e3,
        "plain_ms": statistics.median(plain_ms), "peak_bytes": peak, "codes_equal": equal,
    }
    return launches, timing, render


def profile(render, label: str, n: int = 3) -> dict:
    """Device time by kernel over n renders, and the device's idle share
    (torch.profiler); fails if a render copies anything from the host to
    the device, or more than D2H_PER_RENDER from the device to the host.
    Returns the device ms per render of each kernel (by its profiler key)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    render()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            render()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((t, e.key, e.count))
    total = sum(t for t, _, _ in rows)
    if total <= 0:
        raise AssertionError(f"{label} profile: the profiler saw no device time")
    print(
        f"{label} profile over {n} renders: device {total / n / 1e3!r} ms/render, wall "
        f"{wall_us / n / 1e3!r} ms/render under the profiler, device idle share "
        f"{1.0 - total / wall_us!r}"
    )
    for t, key, count in sorted(rows, reverse=True)[:14]:
        print(f"  {t / n / 1e3:9.4f} ms/render  x{count // n:<3d} {key[:90]}")
    h2d = [(key, count) for _, key, count in rows if "HtoD" in key]
    if h2d:
        raise AssertionError(f"{label}: {n} renders copied host to device: {h2d}")
    d2h = sum(count for _, key, count in rows if "DtoH" in key) / n
    print(f"{label} profile: no host-to-device copy; {d2h!r} device-to-host copies per render")
    if d2h > D2H_PER_RENDER:
        raise AssertionError(f"{label}: {d2h} device-to-host copies per render, at most {D2H_PER_RENDER}")
    return {key: t / n / 1e3 for t, key, _ in rows}


# ------------------------------------------------------------ Processor


def write_dng(path: str, device) -> None:
    """The seeded mosaic as an uncompressed 16-bit RGGB DNG."""
    codes = mosaic_codes(H, W, SEED, device).cpu().numpy()
    dng.write_dng(path, codes, black_level=512, white_level=24000)


def processor_phase(device, path: str, name: str) -> dict:
    """One checked process() of the DNG: exact launch counts, the output
    against a Processor on the plain versions within 1 code."""
    overrides, want, shape = PHASES[name]
    kw = dict(SETTINGS, **overrides)
    label = f"process ({name}) {overrides or 'CLI defaults'}"
    proc = Processor(device=device)
    torch.cuda.synchronize()
    kb.reset_launches()
    out = proc.process(path, cache=False, **kw)
    torch.cuda.synchronize()
    launches = dict(kb.launches)
    print(f"{label}: launches {launches}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    if out.dtype != np.uint8 or out.shape != shape:
        raise AssertionError(f"{label}: output {out.dtype} {out.shape}, want {shape}")
    ref = plain(Processor(device=device).process, path, cache=False, **kw)
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    worst, equal, mean = int(diff.max()), float((diff == 0).mean()), float(out.mean())
    print(f"{label} vs plain versions: max {worst} code, {equal!r} of codes equal, output mean {mean!r}")
    if worst > 1:
        raise AssertionError(f"{label} differs from the plain path by {worst} codes")
    if not 10.0 < mean < 245.0:
        raise AssertionError(f"{label}: implausible output mean {mean}")
    return launches


class PlainProcessor(Processor):
    """A Processor whose renders run the plain versions (on its preview
    worker's thread, where the engine calls it)."""

    def process(self, *args, **kw):
        with kb.plain_reference():
            return super().process(*args, **kw)


def kept_resizes(proc: Processor) -> list:
    """What ``proc``'s finish resizes from now on, a pair a frame, left on
    the card: the (3, h, w) float32 render that it enlarges back to the
    decoded size, and the float32 frame that the enlargement gives, before
    the clamp and the truncation to uint8."""
    kept = []

    def resize(img, resolution):
        out = resolution_scaling(img, resolution)
        kept.append((img, out))
        return out

    def finish(*a, **k):
        tproc.resolution_scaling = resize
        try:
            return Processor._finish(proc, *a, **k)
        finally:
            tproc.resolution_scaling = resolution_scaling

    proc._finish = finish
    return kept


# Nonzero Lanczos-5 weights of one output in an enlargement (radius 5): 10 or 11.
LANCZOS_TAPS = 11


def enlargement_bound(d_render: torch.Tensor, out_hw) -> torch.Tensor:
    """How far the finish's enlargement (``ops/resize.py``: Lanczos-5 on
    each axis that grows) can carry the absolute render differences
    ``d_render`` ((3, h, w)) into the float frame, at each output. The
    resize is linear and separable, F = Wy^T r Wx, so a difference of F is
    at most |Wy|^T |d r| |Wx| (float64 here). Plus the float32 rounding of
    the two frames (TF32 off): each is two GEMMs of at most LANCZOS_TAPS
    nonzero terms an output, each pass off by at most LANCZOS_TAPS u (u =
    2^-24) times the sum of its terms' magnitudes, at most 255 G, G the
    largest product of the two axes' sums of |weights| of one output; so
    2 LANCZOS_TAPS u 255 G a frame, twice that for the difference."""
    (h, w), (oh, ow) = d_render.shape[-2:], out_hw
    if oh < h or ow < w:
        raise AssertionError(f"finish: {h}x{w} -> {oh}x{ow} is no enlargement")

    def absw(n_in, n_out):
        if n_in == n_out:
            return torch.eye(n_in, dtype=torch.float64, device=d_render.device)
        return torch.from_numpy(np.abs(weight_matrix(n_in, n_out, "lanczos5")).astype(np.float64)).to(d_render.device)

    wy, wx = absw(h, oh), absw(w, ow)
    gain = float(wy.sum(0).max() * wx.sum(0).max())
    rounding = 4 * LANCZOS_TAPS * 2.0**-24 * 255.0 * gain
    return wy.T @ d_render.double() @ wx + rounding


def run_engine(proc, path: str, kw: dict, frames: int) -> tuple[list, list]:
    """``frames`` requests through one PreviewEngine, each awaited: (the
    (image, histogram) frames, the host ms from request to frame)."""
    got, errors, lat = [], [], []
    done = threading.Event()
    engine = PreviewEngine(proc, on_frame=lambda img, hist: (got.append((img, hist)), done.set()),
                           on_error=lambda e: (errors.append(e), done.set()))
    try:
        for _ in range(frames):
            done.clear()
            t0 = time.perf_counter()
            engine.request(path, **kw)
            if not done.wait(600):
                raise AssertionError("preview frame timed out")
            lat.append((time.perf_counter() - t0) * 1e3)
            if errors:
                raise errors[0]
    finally:
        engine.close()
    return got, lat


def preview_phase(device, path: str, name: str, card: str) -> tuple[dict, dict]:
    """(h): one cold frame with exact launch counts, its render held to a
    plain-version engine's within 1 code, and its float frame (that render
    enlarged back to the decoded size by Lanczos-5, 7.6x for the full
    preview, before the truncation to uint8) to the plain engine's within
    what the enlargement makes of the render's differences
    (:func:`enlargement_bound`); its histogram equal to a plain count of its
    frame on the host; then the latency of 5 frames after it (the decode
    cached, as when a slider moves)."""
    params, want, shape = PREVIEWS[name]
    kw = dict(SETTINGS, **params)
    label = f"preview ({name}) {params}"
    proc = Processor(device=device)
    resizes = kept_resizes(proc)
    torch.cuda.synchronize()
    kb.reset_launches()
    (frame,), (cold,) = run_engine(proc, path, kw, 1)
    del proc._finish
    launches = dict(kb.launches)
    print(f"{label}: launches {launches}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    img, hist = frame
    if img.dtype != np.uint8 or img.shape != shape:
        raise AssertionError(f"{label}: frame {img.dtype} {img.shape}, want {shape}")
    plain_proc = PlainProcessor(device=device)
    plain_resizes = kept_resizes(plain_proc)
    ref, ref_hist = run_engine(plain_proc, path, kw, 1)[0][0]
    ((got_r, got_f),), ((ref_r, ref_f),) = resizes, plain_resizes
    d_render = (got_r - ref_r).abs()
    worst_r = int(d_render.max())
    # the frame is the float frame clamped to [0, 255], which moves no
    # difference further apart, then truncated
    d_frame = (got_f.clamp(0, 255) - ref_f.clamp(0, 255)).abs()
    limit = enlargement_bound(d_render, tuple(got_f.shape[-2:]))
    over = int((d_frame.double() > limit).sum())
    diff = np.abs(img.astype(np.int16) - ref.astype(np.int16))
    worst, equal = int(diff.max()), float((diff == 0).mean())
    print(f"{label} vs a plain-version engine: render {tuple(got_r.shape)} max {worst_r} code; float frame "
          f"max {float(d_frame.max())!r} (its bound there max {float(limit.max())!r}, {over} values above it); "
          f"uint8 frame max {worst} code, {equal!r} of codes equal")
    if worst_r > 1 or over:
        raise AssertionError(f"{label} differs from the plain engine by {worst_r} codes in the render, "
                             f"{over} float frame values beyond what the enlargement makes of that")
    host_counts = histogram_counts(torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))))
    if not np.array_equal(hist, render_histogram(host_counts.numpy(), hist.shape[0])):
        raise AssertionError(f"{label}: the histogram differs from a host count of its frame")
    print(f"{label}: histogram equal to a host count of its frame; equal to the plain engine's: "
          f"{bool(np.array_equal(hist, ref_hist))}")
    _, lat = run_engine(proc, path, kw, 6)
    lat = lat[1:]
    print(f"{label} on {card}: cold frame {cold!r} ms, then median {statistics.median(lat)!r} ms "
          f"(host clock, request to frame), all {lat!r}")
    # A warm frame's parts, as the engine's worker runs them: process()
    # with the request's settings (the decode cached), then the histogram
    # of the frame it left on the card; and, inside process(), its finish
    # alone (the render's uint8 tensor resized back to the decoded size,
    # clipped and cast on the card, and downloaded once as uint8).
    pk = dict(kw)
    if not pk.pop("full_preview", False):
        pk.update(sharpness=False, grain=0, halation=False)
    parts = {"process_ms": [], "finish_ms": [], "histogram_ms": []}
    for _ in range(3):
        image, t = host_ms(lambda: proc.process(path, **pk))
        parts["process_ms"].append(t)
        frame = proc.last_frame_device
        xyz, orig_resolution, _ = proc._image_cache
        rendered = torch.zeros((3, *xyz.shape[-2:]), dtype=torch.uint8, device=device)
        parts["finish_ms"].append(host_ms(lambda: proc._finish(rendered, orig_resolution=orig_resolution))[1])
        parts["histogram_ms"].append(host_ms(lambda: generate_histogram(frame, device=device))[1])
    parts = {k: statistics.median(v) for k, v in parts.items()}
    print(f"{label} warm frame parts on {card}, median of 3 (ms): {parts!r}")
    return launches, {"cold_ms": cold, "frame_ms": statistics.median(lat), "all_ms": lat,
                      "codes_equal": equal, **parts}


def sep_conv_phase(device, cfg, card: str) -> tuple[dict, dict]:
    """(j): ``ops/sep_conv.py`` at 45 MP, the sum of the MTF's four
    23-tap ranks of one channel (K6 then K5 per rank), held to the plain
    versions."""
    u, v = (np.asarray(t[0]) for t in mtf_ops.mtf_taps(cfg.mtf_key, cfg.scale))
    x = torch.rand((3, H, W), generator=torch.Generator(device=device).manual_seed(14), device=device)
    want = counts(conv_w=len(u), conv_h=len(u))
    torch.cuda.synchronize()
    kb.reset_launches()
    got = sep_conv.sep_conv_rank(x, u, v)
    torch.cuda.synchronize()
    launches = dict(kb.launches)
    print(f"sep_conv_rank 3x{H}x{W}, {u.shape} ranks: launches {launches}")
    if launches != want:
        raise AssertionError(f"sep_conv_rank: launches {launches}, want {want}")
    expect("sep_conv_rank", max_err(got, plain(sep_conv.sep_conv_rank, x, u, v)), 1e-5, f"3x{H}x{W}")
    del got
    times = cuda_ms(lambda: sep_conv.sep_conv_rank(x, u, v), 10)
    print(f"sep_conv_rank 3x{H}x{W} on {card}: median {statistics.median(times)!r} ms (CUDA events, "
          f"{len(u)} ranks: {2 * len(u)} launches and {len(u) - 1} adds), all {times!r}")
    return launches, {"ms": statistics.median(times), "all_ms": times}


def download_phase(device, card: str) -> dict:
    """(o): the export's and the preview's uint8 frames down through
    ``to_host`` (page-locked, from torch's caching host allocator) and
    through ``.cpu()`` (pageable), in 10 turns (``in_turns``: the CUDA
    event pair around each blocking copy)."""
    out = {}
    g = torch.Generator(device=device).manual_seed(15)
    for name, shape in (("export_45mp", (3, H, W)), ("preview_24mp", (3, 2000, 3000))):
        frame = torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=g)
        got = trace.to_host(frame)
        if not (got.is_pinned() and torch.equal(got, frame.cpu())):
            raise AssertionError(f"{name}: to_host gave pinned={got.is_pinned()} or other bytes than .cpu()")
        del got
        times = in_turns({"to_host": lambda: trace.to_host(frame), "cpu": frame.cpu}, rounds=10, per=1)
        nbytes = frame.numel()
        out[name] = {"bytes": nbytes, "is_pinned": True, **times,
                     "to_host_gb_per_s": nbytes / times["to_host"] / 1e6,
                     "cpu_gb_per_s": nbytes / times["cpu"] / 1e6}
        print(f"download {name} ({nbytes} B) on {card}: to_host {times['to_host']!r} ms "
              f"(is_pinned True), .cpu() {times['cpu']!r} ms")
    out["host_memory_stats"] = {k: v for k, v in torch.cuda.host_memory_stats().items()
                                if k in ("allocated_bytes.current", "num_host_alloc")}
    print(f"host_memory_stats: {out['host_memory_stats']}")
    return out


def host_ms(fn, sync: bool = True) -> tuple[object, float]:
    """(fn(), host ms), with a device synchronize before the clock stops."""
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def timed_render(fn) -> tuple[float, float]:
    """(device ms between CUDA events around the render, host ms of the
    render plus the download of its uint8 output)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    out.cpu()
    return a.elapsed_time(b), (time.perf_counter() - t0) * 1e3


def time_processor(device, path: str, card: str) -> dict:
    """(a), (b), (g) and (i) end to end (host clock around process(), which ends with
    the download of the uint8 image), then stage by stage: the host read of
    the DNG, (a) upload + device decode, the exposure fetch and the geometry
    round trip through the host, (b) the host exposure estimate and crop,
    and the render with CUDA events around its device part."""
    proc = Processor(device=device)
    result = {}
    for name in ("a", "b", "g", "i"):
        kw = dict(SETTINGS, **PHASES[name][0])
        proc.process(path, cache=False, **kw)  # warm-up
        wall = [host_ms(lambda: proc.process(path, cache=False, **kw), sync=False)[1] for _ in range(5)]
        print(f"process ({name}) end to end on {card}: median {statistics.median(wall)!r} ms, all {wall!r}")
        result[name] = {"process_ms": statistics.median(wall), "all_ms": wall}

    neg, prt = tproc._resolve_stock(STOCKS["negative_film"]), tproc._resolve_stock(STOCKS["print_film"])
    merged = dict(tproc._MERGED_DEFAULTS, grain=2, sharpness=True, highlight_burn=0.3)
    bundle, mode = proc.load_film_bundle(neg, prt, merged)
    cfg_a = build_render_config(neg, prt, mode, (W // 2) / 36.0, merged)
    cfg_b = build_render_config(neg, prt, mode, W / 36.0, merged)
    fused_kw = dict(half_size=False, max_scale=None, lens_correction=True)
    stages = {"a": {}, "b": {}}

    def add(name, key, value):
        stages[name].setdefault(key, []).append(value)

    for _ in range(3):
        raw, t = host_ms(lambda: dng.read_raw(path), sync=False)
        add("a", "read_raw", t)
        add("b", "read_raw", t)
        xyz, t = host_ms(lambda: traw.decode_raw(raw, half_size=True, device=device))
        add("a", "upload_decode", t)
        _, t = host_ms(lambda: xyz[1, ::2, ::2].cpu().numpy(), sync=False)
        add("a", "exposure_fetch", t)
        staged, t = host_ms(lambda: torch.as_tensor(
            geometry.crop_rotate_zoom(xyz.cpu().numpy(), 36.0, 24.0, 0.0, 1.0, 0, False), device=device))
        add("a", "geometry_round_trip", t)
        dev, host = timed_render(lambda: render_chain(staged, bundle, cfg_a, SEED))
        add("a", "render_device", dev)
        add("a", "render_and_download", host)
        (fast, _), t = host_ms(lambda: proc._try_load_mosaic_impl(raw, fused_kw), sync=False)
        add("b", "prep_upload_exposure_crop", t)
        mosaic, norm, pattern, cam, gain, crop = fast
        dev, host = timed_render(lambda: render_chain_from_mosaic(
            mosaic, cam, bundle, cfg_b, SEED, pattern, gain, crop, norm, device=device))
        add("b", "render_device", dev)
        add("b", "render_and_download", host)
        del xyz, staged
    for name in ("a", "b"):
        med = {k: statistics.median(v) for k, v in stages[name].items()}
        print(f"process ({name}) stages on {card}, median of 3 (ms): {med!r}")
        result[name]["stages_ms"] = med
    return result


# ------------------------------------------------------------ ICC, CLI, viewer


def icc_gamma(x):
    """The float ICC transform of phase (k): a callable, so the bake needs no
    profile file (io/icc.py::apply_transform_to_lut)."""
    return np.clip(x, 0, 1) ** 1.35


def fused_render(proc: Processor, path: str, kw: dict, icc):
    """The fused path's render of ``path`` as process() runs it, with the
    mosaic uploaded once (before the returned callable is called) and the
    ICC factors ``icc`` attached: for profiling a render alone."""
    fast, _ = proc._try_load_mosaic_impl(dng.read_raw(path), dict(half_size=False, max_scale=None,
                                                                    lens_correction=True))
    mosaic, norm, pattern, cam, gain, crop = fast
    mos = torch.as_tensor(mosaic, device=proc.device)
    neg, prt = tproc._resolve_stock(kw["negative_film"]), tproc._resolve_stock(kw["print_film"])
    merged = dict(tproc._MERGED_DEFAULTS, grain=kw["grain"], sharpness=kw["sharpness"],
                  highlight_burn=kw["highlight_burn"])
    bundle, mode = proc.load_film_bundle(neg, prt, merged)
    out_h, out_w = (crop[2], crop[3]) if crop is not None else mosaic.shape
    cfg = build_render_config(neg, prt, mode, max(out_h, out_w) / 36.0, merged)
    bundle, cfg = proc._attach_icc(bundle, cfg, icc)
    seed = tproc.grain_seed(tproc.fold_in(tproc.prng_key(kw["seed"]), 0))  # process()'s grain key
    return lambda: render_chain_from_mosaic(mos, cam, bundle, cfg, seed, pattern, gain, crop,
                                            tuple(float(v) for v in norm), device=proc.device)


def icc_phase(device, path: str, tmp: str, card: str) -> tuple[dict, dict]:
    """(k): process() of the DNG at full res (the fused path) with a float
    ICC transform: (b)'s launch counts with K3 launched once, in float mode;
    within 1 code of a plain-version Processor with the same transform; the
    factors baked and uploaded once, so a render with them attached copies
    nothing to the device (profiled); the CP apply's device ms and extra
    peak memory at 45 MP, the render's ms and peak. Then an ImageCms soft
    proof (sRGB to sRGB) at the CLI defaults, where Pillow imports."""
    overrides, want, shape = PHASES["b"]
    kw = dict(SETTINGS, **overrides, icc_transform=icc_gamma)
    label = "process (k) full res, ICC"
    proc = Processor(device=device)
    k3_outputs = []
    orig_k3 = pe.print_encode

    def k3_spy(*args, **kwargs):
        out = orig_k3(*args, **kwargs)
        k3_outputs.append(out.dtype)
        return out

    pe.print_encode = k3_spy
    try:
        torch.cuda.synchronize()
        kb.reset_launches()
        out = proc.process(path, cache=False, **kw)
        torch.cuda.synchronize()
        launches = dict(kb.launches)
    finally:
        pe.print_encode = orig_k3
    print(f"{label}: launches {launches}, K3 outputs {k3_outputs}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    if k3_outputs != [torch.float32]:
        raise AssertionError(f"{label}: K3 ran {k3_outputs}, want once in float mode")
    if out.dtype != np.uint8 or out.shape != shape:
        raise AssertionError(f"{label}: output {out.dtype} {out.shape}, want {shape}")
    ref = plain(Processor(device=device).process, path, cache=False, **kw)
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    worst, equal = int(diff.max()), float((diff == 0).mean())
    off = proc.process(path, cache=False, **dict(kw, icc_transform=None))
    print(f"{label} vs plain versions: max {worst} code, {equal!r} of codes equal; output mean "
          f"{float(out.mean())!r}, without the transform {float(off.mean())!r}")
    if worst > 1:
        raise AssertionError(f"{label} differs from the plain path by {worst} codes")
    if not 10.0 < float(out.mean()) < float(off.mean()) - 1.0:
        raise AssertionError(f"{label}: the transform (x ** 1.35) did not darken the print")
    del ref, diff, off

    icc = proc._icc_arrays(icc_gamma)
    if any(a is not b for a, b in zip(icc, proc._icc_arrays(icc_gamma))):
        raise AssertionError(f"{label}: the CP factors were not cached per transform")
    render = fused_render(proc, path, kw, icc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = render()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(first.cpu().numpy().transpose(1, 2, 0), out):
        raise AssertionError(f"{label}: the profiled render differs from process()")
    del first
    profile(render, "ICC render (k)")
    ms = cuda_ms(render, 5, warmup=1)

    u, v, w = icc
    x = torch.rand((3, H, W), generator=torch.Generator(device=device).manual_seed(21), device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = apply_lut_3d_cp(x, u, v, w, scale=1.0)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - y.numel() * y.element_size()
    plane = H * W * 4
    cp_ms = cuda_ms(lambda: apply_lut_3d_cp(x, u, v, w, scale=1.0), 5)
    cp_host = apply_lut_3d_cp(x[:, :64, :256].cpu(), u.cpu(), v.cpu(), w.cpu(), scale=1.0)
    expect("apply_lut_3d_cp", max_err(y[:, :64, :256].cpu(), cp_host), 1e-5, "card vs CPU, 3x64x256 corner")
    del x, y
    result = {
        "render_ms": statistics.median(ms), "render_all_ms": ms, "render_peak_bytes": peak,
        "codes_equal": equal, "cp_apply_ms": statistics.median(cp_ms), "cp_apply_all_ms": cp_ms,
        "cp_apply_extra_peak_bytes": extra, "cp_apply_extra_peak_planes": extra / plane,
    }
    print(f"{label} on {card}: render median {result['render_ms']!r} ms (CUDA events, all {ms!r}), peak "
          f"{peak} bytes; CP apply 3x{H}x{W} rank {u.shape[1]}: median {result['cp_apply_ms']!r} ms, all "
          f"{cp_ms!r}, extra peak {extra} bytes ({extra / plane!r} planes of {plane} bytes)")

    try:
        from PIL import ImageCms
    except ImportError as e:
        print(f"{label}: Pillow's ImageCms does not import ({e}); the soft proof was not run")
        return launches, result
    prof = os.path.join(tmp, "srgb.icc")
    with open(prof, "wb") as f:
        f.write(ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes())
    proof = ticc.build_softproof_transform(prof)
    _, want_a, shape_a = PHASES["a"]
    label = "process (k) CLI defaults, ImageCms sRGB soft proof"
    kb.reset_launches()
    out = proc.process(path, cache=False, **dict(SETTINGS, icc_transform=proof))
    torch.cuda.synchronize()
    proof_launches = dict(kb.launches)
    print(f"{label}: launches {proof_launches}")
    if proof_launches != want_a or out.shape != shape_a:
        raise AssertionError(f"{label}: launches {proof_launches} (want {want_a}), shape {out.shape}")
    ref = plain(Processor(device=device).process, path, cache=False, **dict(SETTINGS, icc_transform=proof))
    worst = int(np.abs(out.astype(np.int16) - ref.astype(np.int16)).max())
    print(f"{label} vs plain versions: max {worst} code")
    if worst > 1:
        raise AssertionError(f"{label} differs from the plain path by {worst} codes")
    for k, n in proof_launches.items():
        launches[k] += n
    return launches, result


def write_roll(device, folder: str) -> list[str]:
    """Two seeded 45 MP DNGs in ``folder`` (the seeds SEED + 1, SEED + 2)."""
    os.makedirs(folder)
    paths = []
    for i, name in enumerate(("a.dng", "b.dng")):
        codes = mosaic_codes(H, W, SEED + 1 + i, device).cpu().numpy()
        paths.append(os.path.join(folder, name))
        dng.write_dng(paths[-1], codes, black_level=512, white_level=24000)
    return paths


def cli_phase(device, folder: str, paths: list, out_dir: str, card: str) -> tuple[dict, dict]:
    """(l): the CLI (``cli.main``) over the folder at its defaults (the
    first CUDA device, half-size decode) with lossless PNG output: exit code
    0 and one PNG per DNG, each equal to the port Processor's process() of
    the file under the CLI's merged settings and seed, with the same launch
    counts. BatchRunner records a failed item instead of raising, so a
    non-zero exit fails here."""
    from PIL import Image

    from raw2film_tpu_torch import cli
    from raw2film_tpu_torch.pipeline.params import apply_film_format, merge_params

    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([folder, "-o", out_dir, "--ext", ".png"])
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(kb.launches)
    print(f"cli (l) over {len(paths)} DNGs: exit code {rc}, launches {launches}, {wall!r} ms")
    if rc != 0:
        raise AssertionError(f"cli (l): exit code {rc}")
    names = sorted(os.listdir(out_dir))
    if names != ["a.png", "b.png"]:
        raise AssertionError(f"cli (l): outputs {names}")
    proc = Processor(device=device)
    want = counts()
    for path in paths:
        merged = merge_params(None, {})
        merged.pop("profile", None)
        apply_film_format(merged)
        kb.reset_launches()
        ref = proc.process(path, merged.pop("negative_film"), print_film=merged.pop("print_film"),
                           half_size=True, max_scale=400.0, seed=0, **merged)
        for k, n in kb.launches.items():
            want[k] += n
        with Image.open(os.path.join(out_dir, os.path.basename(path)[:-4] + ".png")) as im:
            got = np.asarray(im)
        if got.shape != ref.shape or not np.array_equal(got, ref):
            raise AssertionError(f"cli (l): {path}'s PNG differs from process() of the file")
    if launches != want:
        raise AssertionError(f"cli (l): launches {launches}, process() of the files {want}")
    print(f"cli (l) on {card}: each PNG equal to process() of its file; {wall / len(paths)!r} ms per "
          f"image (host clock around cli.main: decode, render, PNG encode; host-bound, not a claim)")
    return launches, {"ms_per_image": wall / len(paths), "wall_ms": wall}


def viewer_phase(device, folder: str, card: str) -> tuple[dict, dict]:
    """(m): the viewer's HTTP handler over a ViewerState on the default
    device, on localhost port 0: one parameter change through /api/params,
    /api/wait, then /api/frame.jpg and /api/thumb/0 (non-empty JPEGs); the
    frame the engine rendered (before its JPEG encode) within 1 code of a
    plain-version engine's frame for the same request; /api/about reports
    CUDA."""
    import urllib.request
    from http.server import ThreadingHTTPServer

    from raw2film_tpu_torch import viewer

    def get(url):
        with urllib.request.urlopen(url, timeout=300) as r:
            return r.status, r.read()

    frames = []
    orig_jpeg = viewer._jpeg_bytes
    viewer._jpeg_bytes = lambda a, quality=88: frames.append(a) or orig_jpeg(a, quality)
    state = viewer.ViewerState(folder)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(state))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        about = json.loads(get(base + "/api/about")[1])
        print(f"viewer (m) /api/about: {about}")
        if about["backend"] != "cuda" or not about["device"].startswith("cuda"):
            raise AssertionError(f"viewer (m): /api/about reports {about}")
        params = {"exp_comp": 0.3}
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        req = urllib.request.Request(base + "/api/params", method="POST",
                                     data=json.dumps({"i": 0, "params": params}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            if not json.loads(r.read())["ok"]:
                raise AssertionError("viewer (m): /api/params refused")
        seq = 0
        while seq < 1:
            doc = json.loads(get(base + f"/api/wait?since={seq}")[1])
            if doc.get("error"):
                raise AssertionError(f"viewer (m): {doc['error']}")
            seq = doc["seq"]
        frame_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kb.launches)
        want = counts(half_size=1, develop=1, print_encode=1)  # the simplified preview, no burn
        print(f"viewer (m) frame: launches {launches}, {frame_ms!r} ms from the POST to /api/wait")
        if launches != want:
            raise AssertionError(f"viewer (m): launches {launches}, want {want}")
        for what in ("/api/frame.jpg", "/api/thumb/0"):
            code, body = get(base + what)
            if code != 200 or len(body) < 100 or body[:2] != b"\xff\xd8":
                raise AssertionError(f"viewer (m): {what} gave {code}, {len(body)} bytes")
            print(f"viewer (m) {what}: {len(body)} bytes of JPEG")
        frame = frames[0]
        name = os.path.basename(state.files[0])
        kw = dict(state._render_kwargs(name), max_scale=viewer.PREVIEW_MAX_SCALE)
        ref = run_engine(PlainProcessor(device=device), state.files[0], kw, 1)[0][0][0]
        if ref.shape != frame.shape:
            raise AssertionError(f"viewer (m): frame {frame.shape}, plain engine {ref.shape}")
        worst = int(np.abs(frame.astype(np.int16) - ref.astype(np.int16)).max())
        print(f"viewer (m) on {card}: frame {frame.shape} vs a plain-version engine: max {worst} code")
        if worst > 1:
            raise AssertionError(f"viewer (m): the frame differs from the plain engine by {worst} codes")
    finally:
        httpd.shutdown()
        httpd.server_close()
        state.close()
        viewer._jpeg_bytes = orig_jpeg
    return launches, {"frame_ms": frame_ms}


# ------------------------------------------------------------ mesh (n)

# Launches of one shard's render of camera XYZ at the benchmark config: the
# 45 MP render's kernels but the demosaic. Every shard frame (4896, 3528 and
# 2844 rows at space 2, 4 and 8) is a multiple of 4, so halation stays on
# the /4 mixture tier; the burn's small map (24-43 cells high) is blurred on
# K4 and upsampled in K3 with its shard's row matrix.
SHARD_LAUNCHES = counts(pyramid_down=1, sep_rank=2, sep_rank_narrow=1, pyramid_up_rows=1, halation=1,
                        print_encode=1)
# A shard of a half-size (CLI default) frame: the SVD glow tier and the MTF
# + grain on K2, the development on K16, the burn's blur on K4, K3.
HALF_SHARD_LAUNCHES = counts(sep_rank=2, develop=1, sep_rank_narrow=1, print_encode=1)
HALF_DECODE = counts(half_size=1)  # per image, before it is sharded
SPACES = (2, 4, 8)
SEAM_BAND = 64  # rows gated on each side of a seam


def mesh_xyz(device, seed: int) -> torch.Tensor:
    """A seeded 45 MP camera XYZ frame on the device: the seeded mosaic
    demosaiced (K1), clipped, mixed by the Rec709-to-XYZ matrix."""
    rgb = dm.demosaic_mhc(mosaic_codes(H, W, seed, device), "RGGB", norm=NORM).clamp_(0.0, 1.0)
    m = torch.tensor(ref_data.REC709_TO_XYZ, dtype=torch.float32, device=device)
    return torch.einsum("ij,jhw->ihw", m, rgb).contiguous()


def code_diff(a, b):
    """|a - b| of two uint8 images (tensors or arrays) as int16."""
    if isinstance(a, np.ndarray):
        return np.abs(a.astype(np.int16) - b.astype(np.int16))
    return (a.to(torch.int16) - b.to(torch.int16)).abs()


def seam_gates(label: str, d: torch.Tensor, space: int, halo: int) -> dict:
    """Code differences of a sharded (3, h, w) frame against the unsharded
    one: gated within 1 code on SEAM_BAND rows about each seam and on every
    row more than one halo from the frame's top and bottom; the edge bands
    (the frame's first and last halo rows) are reported, not gated, since
    the frame edges differ by design (raw2film_tpu/parallel/mesh.py:113-118:
    the halo path fills the rows beyond the frame once, the unsharded render
    reflects at every stage)."""
    h = d.shape[-2]
    h_loc = h // space
    rows = d.amax(dim=(0, 2)).cpu().numpy()
    seams = [int(rows[max(s * h_loc - SEAM_BAND, 0) : s * h_loc + SEAM_BAND].max()) for s in range(1, space)]
    interior = int(rows[halo : h - halo].max()) if h > 2 * halo else 0
    edge = torch.cat([d[:, :halo], d[:, h - halo :]], dim=1)
    res = {
        "seam_max": seams, "interior_max": interior, "edge_max": int(edge.max()),
        "edge_equal_share": float((edge == 0).to(torch.float64).mean()),
        "equal_share": float((d == 0).to(torch.float64).mean()),
    }
    print(f"{label} vs unsharded: max code {seams} on +-{SEAM_BAND} rows about each seam, {interior} more "
          f"than one halo ({halo} rows) from the edges; edge bands (not gated) max {res['edge_max']}, "
          f"{res['edge_equal_share']!r} equal; all rows {res['equal_share']!r} equal")
    if max(seams + [interior]) > 1:
        raise AssertionError(f"{label}: {max(seams + [interior])} codes from the unsharded render")
    return res


def checked_launches(label: str, fn, want: dict):
    torch.cuda.synchronize()
    kb.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(kb.launches)
    print(f"{label}: launches {launches}")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    return out, launches


def mesh_phase(device, bundle, cfg, paths: list, card: str) -> tuple[dict, dict]:
    """(n): the halo space path and the batch axis on virtual meshes of
    cuda:0 at 45 MP (space 2, 4 and 8, the last multi-hop; batch 2), each
    render with exact launch counts, within 1 code of the same sharded
    render on the plain versions and held to the unsharded render at the
    seams and interior (seam_gates); a profiled space-2 render copying
    nothing host-to-device; ms per frame and peak memory at each space
    count beside the unsharded frame; process_batch over a 2 x 2 mesh on
    the two DNGs; two processes in a gloo group, both on cuda:0, equal to
    one process."""
    from raw2film_tpu_torch.parallel.mesh import halo_rows, make_mesh, sharded_batch_render, space_halo_rows

    total = counts()

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    xyz = mesh_xyz(device, SEED + 10)
    frame = xyz[None]
    halo = space_halo_rows(cfg, H, W)
    single, launches = checked_launches("mesh (n) unsharded render", lambda: render_chain(xyz, bundle, cfg, SEED),
                                        SHARD_LAUNCHES)
    add(launches)
    ms_single = cuda_ms(lambda: render_chain(xyz, bundle, cfg, SEED), 5)
    torch.cuda.reset_peak_memory_stats()
    render_chain(xyz, bundle, cfg, SEED)
    peak_single = torch.cuda.max_memory_allocated()
    result = {"halo": halo, "unsharded": {"ms": statistics.median(ms_single), "all_ms": ms_single,
                                           "peak_bytes": peak_single}}
    print(f"mesh (n) unsharded 45 MP render from XYZ on {card}: median {statistics.median(ms_single)!r} ms, "
          f"all {ms_single!r}; peak {peak_single} bytes; halo {halo} rows")
    render2 = None
    for space in SPACES:
        label = f"mesh (n) space {space}"
        render = sharded_batch_render(make_mesh(devices=[device] * space, batch=1, space=space), cfg)
        out, launches = checked_launches(label, lambda: render(frame, bundle, [SEED]),
                                         {k: space * v for k, v in SHARD_LAUNCHES.items()})
        add(launches)
        ref = plain(render, frame, bundle, [SEED])
        worst = int(code_diff(out, ref).max())
        print(f"{label} vs the plain versions on the card: max {worst} code")
        gates = seam_gates(label, code_diff(out[0], single), space, halo)
        if worst > 1:
            raise AssertionError(f"{label}: {worst} codes from the plain versions")
        del out, ref
        ms = cuda_ms(lambda: render(frame, bundle, [SEED]), 5)
        torch.cuda.reset_peak_memory_stats()
        render(frame, bundle, [SEED])
        peak = torch.cuda.max_memory_allocated()
        shard_rows = H // space + 2 * halo
        print(f"{label} on {card}: median {statistics.median(ms)!r} ms per 45 MP frame ({space} shards of "
              f"{shard_rows} rows), unsharded {statistics.median(ms_single)!r} ms; all {ms!r}; peak {peak} bytes")
        result[f"space{space}"] = {"ms": statistics.median(ms), "all_ms": ms, "peak_bytes": peak,
                                   "shard_rows": shard_rows, "max_code_vs_plain": worst, **gates}
        if space == 2:
            render2 = render
    by_kernel = profile(lambda: render2(frame, bundle, [SEED]), "mesh (n) space-2 render", n=2)
    result["space2"]["device_ms"] = sum(by_kernel.values())
    rows = halo_rows(H, H // 2 - halo, H + halo, device)  # the bottom shard's rows at space 2
    result["space2"]["gather_ms"] = statistics.median(cuda_ms(lambda: xyz.index_select(1, rows), 5))
    print(f"mesh (n) space 2: one shard's row gather {result['space2']['gather_ms']!r} ms")
    torch.cuda.empty_cache()

    # the batch axis: two images on two (virtual) devices
    xyz2 = torch.stack([xyz, mesh_xyz(device, SEED + 11)])
    render = sharded_batch_render(make_mesh(devices=[device] * 2), cfg)
    out, launches = checked_launches("mesh (n) batch 2", lambda: render(xyz2, bundle, [SEED, SEED + 1]),
                                     {k: 2 * v for k, v in SHARD_LAUNCHES.items()})
    add(launches)
    ref = plain(render, xyz2, bundle, [SEED, SEED + 1])
    worst = int(code_diff(out, ref).max())
    each = [int(code_diff(out[i], render_chain(xyz2[i], bundle, cfg, SEED + i)).max()) for i in range(2)]
    print(f"mesh (n) batch 2: max {worst} code from the plain versions; {each} codes from each unsharded render")
    if worst > 1 or max(each) > 1:
        raise AssertionError(f"mesh (n) batch 2: {worst} codes from plain, {each} from unsharded")
    ms = cuda_ms(lambda: render(xyz2, bundle, [SEED, SEED + 1]), 3)
    result["batch2"] = {"ms_per_frame": statistics.median(ms) / 2, "all_ms": ms, "max_code_vs_plain": worst,
                        "max_code_vs_unsharded": each}
    print(f"mesh (n) batch 2 on {card}: median {statistics.median(ms) / 2!r} ms per frame")
    del xyz2, out, ref, single, render, render2
    torch.cuda.empty_cache()

    # process_batch over a 2 x 2 mesh on the two DNGs, at the CLI defaults
    mesh22 = make_mesh(devices=[device] * 4, space=2)
    proc = Processor(device=device)
    outs, launches = checked_launches(
        "mesh (n) process_batch 2 x 2", lambda: proc.process_batch(paths, mesh=mesh22, **SETTINGS),
        {k: len(paths) * HALF_DECODE[k] + 4 * v for k, v in HALF_SHARD_LAUNCHES.items()},
    )
    add(launches)
    refs = plain(Processor(device=device).process_batch, paths, mesh=mesh22, **SETTINGS)
    flat = proc.process_batch(paths, **SETTINGS)
    neg, prt = tproc._resolve_stock(STOCKS["negative_film"]), tproc._resolve_stock(STOCKS["print_film"])
    merged = dict(tproc._MERGED_DEFAULTS, grain=2, sharpness=True, highlight_burn=0.3)
    cfg_half = build_render_config(neg, prt, "print", (W // 2) / 36.0, merged)
    halo_half = space_halo_rows(cfg_half, H // 2, W // 2)
    pb = []
    for i, (o, r, f) in enumerate(zip(outs, refs, flat)):
        worst = int(code_diff(o, r).max())
        print(f"mesh (n) process_batch image {i}: {o.shape}, max {worst} code from the plain versions")
        if o.shape != HALF or worst > 1:
            raise AssertionError(f"mesh (n) process_batch image {i}: {o.shape}, {worst} codes from plain")
        d = torch.as_tensor(code_diff(o, f).transpose(2, 0, 1))
        pb.append(seam_gates(f"mesh (n) process_batch image {i}", d, 2, halo_half))
    result["process_batch"] = {"halo": halo_half, "images": pb}

    result["gloo"] = gloo_phase(device, bundle, cfg, card)
    return total, result


def gloo_phase(device, bundle, cfg, card: str) -> dict:
    """Two processes of this script (--gloo-worker) in a gloo group on a
    free localhost port, both on cuda:0, each rendering its image of a
    global batch of two through distributed_batch_render: each output's
    SHA-256 equal to this process's render of the same image."""
    import hashlib
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-worker", str(pid), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = (time.perf_counter() - t0) * 1e3
    got = []
    for pid, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"gloo worker {pid}: exit code {p.returncode}\n{log[-3000:]}")
        got.append(json.loads([line for line in log.splitlines() if line.startswith('{"pid"')][-1]))
    want = [hashlib.sha256(render_chain(mesh_xyz(device, SEED + 20 + pid), bundle, cfg, SEED + pid)
                           .cpu().numpy().tobytes()).hexdigest() for pid in (0, 1)]
    print(f"mesh (n) gloo on {card}: two processes in {wall!r} ms (start-up included); workers {got}")
    if [g["sha256"] for g in got] != want:
        raise AssertionError(f"mesh (n) gloo: the processes' outputs differ from one process's: {got} vs {want}")
    return {"wall_ms": wall, "workers": got}


def gloo_worker(pid: int, port: str) -> int:
    """One process of gloo_phase: join the group, render image ``pid`` of
    the global batch over a one-device mesh, print its SHA-256."""
    import hashlib

    import torch.distributed as dist

    from raw2film_tpu_torch.parallel.distributed import distributed_batch_render, init_process
    from raw2film_tpu_torch.parallel.mesh import make_mesh

    device = require_cuda()
    disable_tf32(verbose=False)
    bundle, cfg = load_film_bundle(h=H, w=W, device=device, halation=True, grain=2, sharpness=True,
                                   highlight_burn=0.3)
    xyz = mesh_xyz(device, SEED + 20 + pid)[None]
    init_process(f"127.0.0.1:{port}", 2, pid)
    try:
        kb.reset_launches()
        out = distributed_batch_render(make_mesh(devices=[device]), cfg, xyz, bundle, [SEED + pid])
        launches = {k: v for k, v in kb.launches.items() if v}
    finally:
        dist.destroy_process_group()
    print(json.dumps({"pid": pid, "shape": list(out.shape), "launches": launches,
                      "sha256": hashlib.sha256(out[0].tobytes()).hexdigest()}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    device = require_cuda()
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )
    disable_tf32()

    t0 = time.perf_counter()
    kb.lib()
    print(f"kernel build + load: {time.perf_counter() - t0!r} s ({kb.library_path()})")
    for line in kb.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    grain_registers()

    params = dict(h=H, w=W, device=device, grain=2, sharpness=True, highlight_burn=0.3)
    bundle, cfg = load_film_bundle(halation=True, **params)
    bundle_off, cfg_off = load_film_bundle(halation=False, **params)
    print("checks on", card)
    results = {
        "demosaic": check_demosaic(device, (H, W)),
        "sep_rank": check_sep_rank(device, (H, W), cfg),
        "print_encode": check_print_encode(device, (H, W), bundle, cfg),
        "sep_rank_narrow": check_sep_rank_narrow(device),
    }
    results["conv_w"], results["conv_h"] = check_conv1d(device, (H, W), cfg)
    results["grain_field"] = check_grain_field(device, (H, W), cfg)
    results["pyramid_down"], results["pyramid_up_rows"] = check_pyramid(device, (H, W))
    results["halation"] = check_halation(device, bundle, cfg)
    results["half_size"] = check_half_size(device, (H, W))
    results["exposure_sample"] = check_exposure_sample(device, (H, W))
    results["pyramid_up"] = check_upsample(device, (H, W))
    results["grain_apply"], results["grain_apply_bw"] = check_grain_apply(device, (H, W), cfg)
    results["develop"] = check_develop(device, (H, W), bundle_off)
    torch.cuda.empty_cache()

    codes = mosaic_codes(H, W, SEED, device)
    launches, timing, render = main_path(
        device, codes, bundle, cfg, card, LAUNCHES_ON, "halation-on main path"
    )
    by_kernel = profile(render, "halation-on main path")
    del render
    # K1's and K12's device ms in the render (their checks above time them
    # with CUDA events only)
    for name, kernel in (("demosaic", "demosaic_kernel"), ("pyramid_up_rows", "upsample_rows_kernel")):
        results[name]["device_ms_in_render"] = sum(t for key, t in by_kernel.items() if kernel in key)
    torch.cuda.empty_cache()
    launches_off, timing_off, _ = main_path(
        device, codes, bundle_off, cfg_off, card, LAUNCHES_OFF, "halation-off path"
    )
    del codes
    torch.cuda.empty_cache()

    total = {k: launches[k] + launches_off[k] for k in KERNELS}

    def add(phase_launches):
        for k, v in phase_launches.items():
            total[k] += v

    previews = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.dng")
        t0 = time.perf_counter()
        write_dng(path, device)
        print(f"wrote {os.path.getsize(path)} bytes of DNG in {time.perf_counter() - t0!r} s")
        for name in PHASES:
            add(processor_phase(device, path, name))
            torch.cuda.empty_cache()
        for name in PREVIEWS:
            phase_launches, previews[name] = preview_phase(device, path, name, card)
            add(phase_launches)
            torch.cuda.empty_cache()
        process_timing = time_processor(device, path, card)
        phase_launches, icc_timing = icc_phase(device, path, tmp, card)
        add(phase_launches)
        torch.cuda.empty_cache()
        roll = os.path.join(tmp, "roll")
        paths = write_roll(device, roll)
        phase_launches, cli_timing = cli_phase(device, roll, paths, os.path.join(tmp, "export"), card)
        add(phase_launches)
        phase_launches, viewer_timing = viewer_phase(device, roll, card)
        add(phase_launches)
        torch.cuda.empty_cache()
        phase_launches, mesh_timing = mesh_phase(device, bundle, cfg, paths, card)
        add(phase_launches)
        torch.cuda.empty_cache()
    phase_launches, sep_conv_timing = sep_conv_phase(device, cfg, card)
    add(phase_launches)
    download_timing = download_phase(device, card)
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was launched no time on the main paths")
    for name, r in results.items():
        print(f"kernel {name} on {card}: {r['ms']!r} ms vs plain {r['plain_ms']!r} ms, "
              f"bound {r['bound_ms']!r} ms ({r['bound_by']}), library {r['library_ms']!r} ms")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": total[name],
            **results[name],
        }
        for name, (_, source, replaces) in KERNELS.items()
    ]
    print(json.dumps({
        "kernels": kernels, "main_path": timing, "halation_off": timing_off,
        "process": process_timing, "preview": previews, "sep_conv_rank": sep_conv_timing,
        "icc": icc_timing, "cli": cli_timing, "viewer": viewer_timing, "mesh": mesh_timing, "download": download_timing, "card": card,
    }))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-worker"]:
        sys.exit(gloo_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
