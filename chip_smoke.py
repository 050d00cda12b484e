"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), torch and CUDA
   versions and the TF32 flags; exits non-zero without a CUDA device;
2. builds the hand-written kernels from ``raw2film_tpu_torch/csrc``;
3. checks each kernel against its plain PyTorch version on the card, at
   small ragged shapes and at the shapes of the 45 MP main path;
4. renders a seeded 5472x8208 uint16 RGGB mosaic through
   ``render_chain_from_mosaic`` (Kodak Portra 400 printed on Fuji Crystal
   Archive Maxima, halation on, grain 2, MTF, burn 0.3), checks how often
   every kernel of the path launched in that render, and holds the output
   to the same render with the plain versions on the card (within 1 uint8
   code); then the same with halation off;
5. writes the same mosaic as an uncompressed 5472x8208 DNG to a temporary
   directory and renders it with ``Processor(device="cuda").process()`` in
   six phases, each with its launch counts checked exactly and its output
   held to a plain-version Processor within 1 code: (a) the CLI defaults
   (half-size decode K11, the SVD halation tier on K2, K2 MTF + grain, K3),
   (b) full res (the fused path), (c) sharpness off (grain on K8), (d) grain
   1 (K9), (e) halation size 3.0 at full res (the /4 and /8 pyramid levels,
   K13 twice), (f) full res on a 36 x 23.9 frame, whose H is not a multiple
   of 4 (the bilinear resize, neither K13 nor K14);
6. times the renders, (a) and (b) end to end and stage by stage, and each
   kernel against its plain version with CUDA events, profiles the
   halation-on render's device time by kernel, and prints one JSON line of
   per-kernel results;
7. prints {"ok": true, "device": {...}} as its last line.

Any failed check ends the script with a traceback and a non-zero exit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from raw2film_tpu_torch import Processor, load_film_bundle, render_chain, render_chain_from_mosaic
from raw2film_tpu_torch._reference import data as ref_data
from raw2film_tpu_torch._reference import dng, geometry
from raw2film_tpu_torch.device import disable_tf32, require_cuda
from raw2film_tpu_torch.io import raw as traw
from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import burn as burn_ops
from raw2film_tpu_torch.ops import demosaic as dm
from raw2film_tpu_torch.ops import grain as grain_ops
from raw2film_tpu_torch.ops import halation as hal_ops
from raw2film_tpu_torch.ops import mtf as mtf_ops
from raw2film_tpu_torch.ops import print_encode as pe
from raw2film_tpu_torch.ops import pyramid
from raw2film_tpu_torch.ops import sep_rank
from raw2film_tpu_torch.pipeline import processor as tproc
from raw2film_tpu_torch.pipeline.render import build_render_config

H, W = 5472, 8208
SEED = 20261016
# max abs error of a kernel against its plain version: float32 images, and
# uint8 codes for the print tail. Its float output is held to 1e-4 (0.03 of
# a code): steep transfer curves near black (Gamma 2.2/2.4, no linear toe)
# amplify the last-ulp differences of exp2f and FMA contraction.
# The pyramid resamples sum or lerp a few float32 values (a few ulp of
# values below 4); halation is held to 1e-5 on exposure and 2e-5 on density
# (the develop epilogue's log2/exp2 chain); the half-size decode selects and
# averages two values, bit for bit; the grain applies as K2's epilogue.
TOL = {
    "demosaic": 2e-6, "sep_rank": 1e-5, "print_encode": 1.0, "print_encode_float": 1e-4,
    "pyramid_down": 1e-6, "pyramid_up_rows": 2e-6, "halation": 1e-5, "halation_density": 2e-5,
    "half_size": 0.0, "pyramid_up": 2e-6, "grain_apply": 1e-5, "grain_apply_bw": 1e-5,
}
KERNELS = {
    "demosaic": ("raw2film_tpu_torch/csrc/demosaic.cu", "raw2film_tpu/ops/pallas_demosaic.py:191"),
    "half_size": ("raw2film_tpu_torch/csrc/demosaic.cu", "raw2film_tpu/ops/pallas_pyramid.py:205"),
    "pyramid_down": ("raw2film_tpu_torch/csrc/pyramid.cu", "raw2film_tpu/ops/pallas_pyramid.py:65"),
    "sep_rank": ("raw2film_tpu_torch/csrc/sep_rank_grain.cu", "raw2film_tpu/ops/pallas_conv2.py:576"),
    "pyramid_up_rows": ("raw2film_tpu_torch/csrc/pyramid.cu", "raw2film_tpu/ops/pallas_pyramid.py:277"),
    "pyramid_up": ("raw2film_tpu_torch/csrc/pyramid.cu", "raw2film_tpu/ops/pallas_pyramid.py:374"),
    "halation": ("raw2film_tpu_torch/csrc/halation.cu", "raw2film_tpu/ops/pallas_halation.py:239"),
    "grain_apply": ("raw2film_tpu_torch/csrc/grain.cu", "raw2film_tpu/ops/pallas_grain.py:306"),
    "grain_apply_bw": ("raw2film_tpu_torch/csrc/grain.cu", "raw2film_tpu/ops/pallas_grain.py:405"),
    "print_encode": ("raw2film_tpu_torch/csrc/print_encode.cu", "raw2film_tpu/ops/pallas_print.py:164"),
}


def counts(**nonzero) -> dict:
    """A full launch-count dict: the given kernels, every other one 0."""
    return {k: nonzero.get(k, 0) for k in kb.launches}


# Launches of each kernel in one 45 MP render: with halation, K2 runs twice
# (the /4 small blur and the MTF + grain).
LAUNCHES_ON = counts(demosaic=1, pyramid_down=1, sep_rank=2, pyramid_up_rows=1, halation=1, print_encode=1)
LAUNCHES_OFF = counts(demosaic=1, sep_rank=1, print_encode=1)
# Processor.process() of the DNG: (overrides of the benchmark settings,
# launches per render, output shape).
HALF = (H // 2, W // 2, 3)
PHASES = {
    "a": ({}, counts(half_size=1, sep_rank=2, print_encode=1), HALF),
    "b": (dict(half_size=False, max_scale=None), LAUNCHES_ON, (H, W, 3)),
    "c": (dict(sharpness=False), counts(half_size=1, sep_rank=1, grain_apply=1, print_encode=1), HALF),
    "d": (dict(grain=1), counts(half_size=1, sep_rank=2, grain_apply_bw=1, print_encode=1), HALF),
    "e": (
        dict(half_size=False, max_scale=None, halation_size=3.0),
        counts(demosaic=1, pyramid_down=2, sep_rank=4, pyramid_up=2, print_encode=1),
        (H, W, 3),
    ),
    "f": (
        dict(half_size=False, max_scale=None, frame_height=23.9),
        counts(demosaic=1, pyramid_down=1, sep_rank=3, print_encode=1),
        (5449, 8207, 3),
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


def check_demosaic(device, full_hw) -> dict:
    g = torch.Generator(device=device).manual_seed(1)
    mat = np.array([[0.9, 0.2, -0.1], [0.1, 1.1, -0.2], [-0.05, 0.15, 0.95]], np.float32)
    for pattern in dm.PATTERNS:
        codes = mosaic_codes(37, 53, 2, device)
        expect("demosaic", max_err(dm.demosaic_exposure(codes, pattern, mat, NORM),
                                   plain(dm.demosaic_exposure, codes, pattern, mat, NORM)),
               TOL["demosaic"], f"u16+norm+mat 37x53 {pattern}")
        f = torch.rand((37, 53), generator=g, device=device)
        expect("demosaic", max_err(dm.demosaic_mhc(f, pattern), plain(dm.demosaic_mhc, f, pattern)),
               TOL["demosaic"], f"f32 37x53 {pattern}")
    codes = mosaic_codes(*full_hw, 3, device)
    got = dm.demosaic_exposure(codes, "RGGB", mat, NORM)
    err = max_err(got, plain(dm.demosaic_exposure, codes, "RGGB", mat, NORM))
    expect("demosaic", err, TOL["demosaic"], f"u16+norm+mat {full_hw[0]}x{full_hw[1]}")
    ms = cuda_ms(lambda: dm.demosaic_exposure(codes, "RGGB", mat, NORM), 20)
    plain_ms = cuda_ms(lambda: plain(dm.demosaic_exposure, codes, "RGGB", mat, NORM), 5)
    return {"max_abs_err": err, "ms": statistics.median(ms), "plain_ms": statistics.median(plain_ms)}


def check_sep_rank(device, full_hw, cfg) -> dict:
    u3, v3 = mtf_ops.mtf_taps(cfg.mtf_key, cfg.scale)
    gtaps = grain_ops.grain_corr_taps(
        grain_ops.correlation_sigma_px(cfg.scale, cfg.grain_size_mm, cfg.grain_sigma)
    )
    print(f"  sep_rank taps {u3.shape}, grain taps {len(gtaps)}")
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=device)
    seed = (0xDEADBEEF, (-7) & 0xFFFFFFFF)
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
    sm_ms = cuda_ms(lambda: sep_rank.fused_sep_rank(sm, su, sv), 20)
    print(f"  sep_rank /4 small blur {tuple(sm.shape)}: {statistics.median(sm_ms)!r} ms")
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
    ms = cuda_ms(lambda: sep_rank.fused_sep_rank(d, u3, v3, grain), 10)
    plain_ms = cuda_ms(lambda: plain(sep_rank.fused_sep_rank, d, u3, v3, grain), 3)
    return {"max_abs_err": err, "ms": statistics.median(ms), "plain_ms": statistics.median(plain_ms)}


def check_print_encode(device, full_hw, bundle, cfg) -> dict:
    pvec = pe.pack_print_vec(bundle)
    g = torch.Generator(device=device).manual_seed(5)
    d = torch.rand((3, 37, 300), generator=g, device=device) * 3.5
    for mode in ("print", "inversion"):
        for gamma in ("sRGB", "Rec709", "Gamma 2.2", "ARRI LogC3", "Linear"):
            for quantize in (True, False):
                args = (d, pvec, mode, mode == "print", gamma != "sRGB", gamma, quantize)
                tol = TOL["print_encode"] if quantize else TOL["print_encode_float"]
                expect("print_encode", max_err(pe.print_encode(*args), plain(pe.print_encode, *args)),
                       tol, f"{mode} {gamma} quantize={quantize} 3x37x300")
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
    ms = cuda_ms(lambda: pe.print_encode(*args), 20)
    plain_ms = cuda_ms(lambda: plain(pe.print_encode, *args), 5)
    return {"max_abs_err": err, "ms": statistics.median(ms), "plain_ms": statistics.median(plain_ms)}


def check_pyramid(device, full_hw) -> tuple[dict, dict]:
    g = torch.Generator(device=device).manual_seed(7)
    for shape, f in (((3, 37, 53), 3), ((3, 38, 55), 4), ((2, 9, 9), 4), ((1, 40, 64), 1)):
        x = torch.rand(shape, generator=g, device=device) * 3.0
        expect("pyramid_down", max_err(pyramid.box_downsample_pyramid(x, f),
                                       plain(pyramid.box_downsample_pyramid, x, f)),
               TOL["pyramid_down"], f"f={f} {shape}")
    for shape, f, oh in (((3, 11, 29), 4, 41), ((3, 11, 29), 4, None), ((2, 7, 30), 3, 20)):
        x = torch.rand(shape, generator=g, device=device) * 3.0
        expect("pyramid_up_rows", max_err(pyramid.bilinear_upsample_rows(x, f, oh),
                                          plain(pyramid.bilinear_upsample_rows, x, f, oh)),
               TOL["pyramid_up_rows"], f"f={f} oh={oh} {shape}")
    h, w = full_hw
    x = torch.rand((3, h, w), generator=g, device=device) * 3.0
    err = max_err(pyramid.box_downsample_pyramid(x, 4), plain(pyramid.box_downsample_pyramid, x, 4))
    expect("pyramid_down", err, TOL["pyramid_down"], f"f=4 3x{h}x{w}")
    down = {
        "max_abs_err": err,
        "ms": statistics.median(cuda_ms(lambda: pyramid.box_downsample_pyramid(x, 4), 20)),
        "plain_ms": statistics.median(cuda_ms(lambda: plain(pyramid.box_downsample_pyramid, x, 4), 5)),
    }
    del x
    s = torch.rand((3, h // 4, w // 4), generator=g, device=device) * 3.0
    err = max_err(pyramid.bilinear_upsample_rows(s, 4, h), plain(pyramid.bilinear_upsample_rows, s, 4, h))
    expect("pyramid_up_rows", err, TOL["pyramid_up_rows"], f"f=4 {tuple(s.shape)} -> {h} rows")
    up = {
        "max_abs_err": err,
        "ms": statistics.median(cuda_ms(lambda: pyramid.bilinear_upsample_rows(s, 4, h), 20)),
        "plain_ms": statistics.median(cuda_ms(lambda: plain(pyramid.bilinear_upsample_rows, s, 4, h), 5)),
    }
    return down, up


def halation_inputs(hw, size, g, device):
    """Exposure, ranks and a row-upsampled pyramid blur at frame size hw."""
    us, vs, _ = hal_ops._full_res_ranks(size)
    img = torch.rand((3, *hw), generator=g, device=device) * 2.0
    rows_up = torch.rand((3, hw[0], -(-hw[1] // 4)), generator=g, device=device) * 0.5
    return img, us, vs, rows_up


def check_halation(device, bundle, cfg) -> dict:
    g = torch.Generator(device=device).manual_seed(8)
    colour, bw = hal_ops.colour_factors(bundle, False), hal_ops.colour_factors(bundle, True)
    devvec = hal_ops.develop_vector(bundle)
    size = cfg.scale / 4.0 * cfg.halation_size
    img, us, vs, rows_up = halation_inputs((44, 72), size, g, device)
    print(f"  halation ranks {len(us)} x {len(us[0])} taps (size {size!r})")
    for fname, fac in (("colour", colour), ("bw", bw)):
        for dv in (None, devvec):
            args = (img, us, vs, rows_up, fac, dv)
            tol = TOL["halation"] if dv is None else TOL["halation_density"]
            expect("halation", max_err(hal_ops.halation_mega(*args), plain(hal_ops.halation_mega, *args)),
                   tol, f"{fname} develop={dv is not None} 3x44x72")
    img, us, vs, rows_up = halation_inputs((37, 70), size, g, device)  # W not a multiple of 4
    args = (img, us, vs, rows_up, colour, devvec)
    expect("halation", max_err(hal_ops.halation_mega(*args), plain(hal_ops.halation_mega, *args)),
           TOL["halation_density"], "colour develop=True 3x37x70")
    result = None
    for hw in ((H, W), (H24, W24)):
        size_hw = max(hw) / 36.0 / 4.0 * cfg.halation_size
        img, us, vs, rows_up = halation_inputs(hw, size_hw, g, device)
        for dv in (None, devvec):
            args = (img, us, vs, rows_up, colour, dv)
            tol = TOL["halation"] if dv is None else TOL["halation_density"]
            err = max_err(hal_ops.halation_mega(*args), plain(hal_ops.halation_mega, *args))
            expect("halation", err, tol, f"{len(us)}x{len(us[0])} taps develop={dv is not None} 3x{hw[0]}x{hw[1]}")
        ms = statistics.median(cuda_ms(lambda: hal_ops.halation_mega(*args), 10))
        plain_ms = statistics.median(cuda_ms(lambda: plain(hal_ops.halation_mega, *args), 3))
        print(f"  halation {hw[0]}x{hw[1]} ({len(us[0])} taps, develop): {ms!r} ms vs plain {plain_ms!r} ms")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del img, rows_up, args
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
    ms = cuda_ms(lambda: dm.half_size_decode(codes, "RGGB", NORM), 20)
    plain_ms = cuda_ms(lambda: plain(dm.half_size_decode, codes, "RGGB", NORM), 5)
    return {"max_abs_err": err, "ms": statistics.median(ms), "plain_ms": statistics.median(plain_ms)}


def check_upsample(device, full_hw) -> dict:
    """Small ragged crops, then the /4 and /8 levels of the 45 MP frame back
    to full size (phase e's shapes); the /8 level is the one reported."""
    g = torch.Generator(device=device).manual_seed(10)
    for shape, f, out_hw in (((3, 11, 29), 4, (41, 115)), ((2, 7, 9), 8, (50, 70)), ((1, 5, 6), 3, None)):
        x = torch.rand(shape, generator=g, device=device) * 3.0
        expect("pyramid_up", max_err(pyramid.bilinear_upsample(x, f, out_hw),
                                     plain(pyramid.bilinear_upsample, x, f, out_hw)),
               TOL["pyramid_up"], f"f={f} {shape} -> {out_hw}")
    result = None
    for f in (4, 8):
        s_ = torch.rand((3, full_hw[0] // f, full_hw[1] // f), generator=g, device=device)
        err = max_err(pyramid.bilinear_upsample(s_, f, full_hw), plain(pyramid.bilinear_upsample, s_, f, full_hw))
        expect("pyramid_up", err, TOL["pyramid_up"], f"f={f} {tuple(s_.shape)} -> {full_hw}")
        ms = statistics.median(cuda_ms(lambda: pyramid.bilinear_upsample(s_, f, full_hw), 20))
        plain_ms = statistics.median(cuda_ms(lambda: plain(pyramid.bilinear_upsample, s_, f, full_hw), 5))
        print(f"  pyramid_up f={f} {tuple(s_.shape)} -> {full_hw}: {ms!r} ms vs plain {plain_ms!r} ms")
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return result


def check_grain_apply(device, full_hw, cfg) -> tuple[dict, dict]:
    """Small ragged frames with 3 and 13 taps, the half-size frame with its
    white-noise grain (phases c and d), then the 45 MP frame with its 3 taps."""
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=device)
    seed = (0xDEADBEEF, (-7) & 0xFFFFFFFF)
    g = torch.Generator(device=device).manual_seed(11)
    sigma = grain_ops.correlation_sigma_px(cfg.scale, cfg.grain_size_mm, cfg.grain_sigma)
    half_sigma = grain_ops.correlation_sigma_px(cfg.scale / 2, cfg.grain_size_mm, cfg.grain_sigma)
    out = {}
    for bw, name in ((False, "grain_apply"), (True, "grain_apply_bw")):
        for shape, sg in (((3, 45, 71), sigma), ((3, 45, 71), 2.3), ((3, full_hw[0] // 2, full_hw[1] // 2), half_sigma)):
            d = torch.rand(shape, generator=g, device=device) * 3.0
            args = (d, seed, sg, prm, bw)
            expect(name, max_err(grain_ops.grain_apply(*args), plain(grain_ops.grain_apply, *args)),
                   TOL[name], f"{len(grain_ops.grain_corr_taps(sg))} taps {shape}")
        d = torch.rand((3, *full_hw), generator=g, device=device) * 3.0
        args = (d, seed, sigma, prm, bw)
        err = max_err(grain_ops.grain_apply(*args), plain(grain_ops.grain_apply, *args))
        expect(name, err, TOL[name], f"{len(grain_ops.grain_corr_taps(sigma))} taps 3x{full_hw[0]}x{full_hw[1]}")
        ms = statistics.median(cuda_ms(lambda: grain_ops.grain_apply(*args), 20))
        plain_ms = statistics.median(cuda_ms(lambda: plain(grain_ops.grain_apply, *args), 3))
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del d, args
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


def profile(render, label: str, n: int = 3) -> None:
    """Device time by kernel over n renders, and the device's idle share
    (torch.profiler; informational, no check depends on it)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    render()
    torch.cuda.synchronize()
    try:
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
    except Exception as exc:  # the profiler is optional instrumentation
        print(f"{label} profile: unavailable ({exc!r})")
        return
    total = sum(t for t, _, _ in rows)
    if total <= 0:
        print(f"{label} profile: the profiler saw no device time")
        return
    print(
        f"{label} profile over {n} renders: device {total / n / 1e3!r} ms/render, wall "
        f"{wall_us / n / 1e3!r} ms/render under the profiler, device idle share "
        f"{1.0 - total / wall_us!r}"
    )
    for t, key, count in sorted(rows, reverse=True)[:14]:
        print(f"  {t / n / 1e3:9.4f} ms/render  x{count // n:<3d} {key[:90]}")


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
    """(a) and (b) end to end (host clock around process(), which ends with
    the download of the uint8 image), then stage by stage: the host read of
    the DNG, (a) upload + device decode, the exposure fetch and the geometry
    round trip through the host, (b) the host exposure estimate and crop,
    and the render with CUDA events around its device part."""
    proc = Processor(device=device)
    result = {}
    for name in ("a", "b"):
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
        add("b", "host_exposure_and_crop", t)
        mosaic, norm, pattern, cam, gain, crop = fast
        dev, host = timed_render(lambda: render_chain_from_mosaic(
            mosaic, cam, bundle, cfg_b, SEED, pattern, gain, crop, norm, device=device))
        add("b", "upload_and_render_device", dev)
        add("b", "render_and_download", host)
        del xyz, staged
    for name in ("a", "b"):
        med = {k: statistics.median(v) for k, v in stages[name].items()}
        print(f"process ({name}) stages on {card}, median of 3 (ms): {med!r}")
        result[name]["stages_ms"] = med
    return result


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

    params = dict(h=H, w=W, device=device, grain=2, sharpness=True, highlight_burn=0.3)
    bundle, cfg = load_film_bundle(halation=True, **params)
    bundle_off, cfg_off = load_film_bundle(halation=False, **params)
    print("checks on", card)
    results = {
        "demosaic": check_demosaic(device, (H, W)),
        "sep_rank": check_sep_rank(device, (H, W), cfg),
        "print_encode": check_print_encode(device, (H, W), bundle, cfg),
    }
    results["pyramid_down"], results["pyramid_up_rows"] = check_pyramid(device, (H, W))
    results["halation"] = check_halation(device, bundle, cfg)
    results["half_size"] = check_half_size(device, (H, W))
    results["pyramid_up"] = check_upsample(device, (H, W))
    results["grain_apply"], results["grain_apply_bw"] = check_grain_apply(device, (H, W), cfg)
    torch.cuda.empty_cache()

    codes = mosaic_codes(H, W, SEED, device)
    launches, timing, render = main_path(
        device, codes, bundle, cfg, card, LAUNCHES_ON, "halation-on main path"
    )
    profile(render, "halation-on main path")
    del render
    torch.cuda.empty_cache()
    launches_off, timing_off, _ = main_path(
        device, codes, bundle_off, cfg_off, card, LAUNCHES_OFF, "halation-off path"
    )
    del codes
    torch.cuda.empty_cache()

    total = {k: launches[k] + launches_off[k] for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.dng")
        t0 = time.perf_counter()
        write_dng(path, device)
        print(f"wrote {os.path.getsize(path)} bytes of DNG in {time.perf_counter() - t0!r} s")
        for name in PHASES:
            for k, v in processor_phase(device, path, name).items():
                total[k] += v
            torch.cuda.empty_cache()
        process_timing = time_processor(device, path, card)
    for name, n in total.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was launched no time on the main paths")
    for name, r in results.items():
        print(f"kernel {name} on {card}: {r['ms']!r} ms vs plain {r['plain_ms']!r} ms")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": total[name],
            **results[name],
        }
        for name in KERNELS
    ]
    print(json.dumps({
        "kernels": kernels, "main_path": timing, "halation_off": timing_off,
        "process": process_timing, "card": card,
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
    sys.exit(main())
