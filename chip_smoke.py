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
5. times both renders and each kernel against its plain version with CUDA
   events, profiles the halation-on render's device time by kernel, and
   prints one JSON line of per-kernel results;
6. prints {"ok": true, "device": {...}} as its last line.

Any failed check ends the script with a traceback and a non-zero exit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from raw2film_tpu_torch import load_film_bundle, render_chain_from_mosaic
from raw2film_tpu_torch._reference import data as ref_data
from raw2film_tpu_torch.device import disable_tf32, require_cuda
from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import burn as burn_ops
from raw2film_tpu_torch.ops import demosaic as dm
from raw2film_tpu_torch.ops import grain as grain_ops
from raw2film_tpu_torch.ops import halation as hal_ops
from raw2film_tpu_torch.ops import mtf as mtf_ops
from raw2film_tpu_torch.ops import print_encode as pe
from raw2film_tpu_torch.ops import pyramid
from raw2film_tpu_torch.ops import sep_rank

H, W = 5472, 8208
SEED = 20261016
# max abs error of a kernel against its plain version: float32 images, and
# uint8 codes for the print tail. Its float output is held to 1e-4 (0.03 of
# a code): steep transfer curves near black (Gamma 2.2/2.4, no linear toe)
# amplify the last-ulp differences of exp2f and FMA contraction.
# The pyramid resamples sum or lerp a few float32 values (a few ulp of
# values below 4); halation is held to 1e-5 on exposure and 2e-5 on density
# (the develop epilogue's log2/exp2 chain).
TOL = {
    "demosaic": 2e-6, "sep_rank": 1e-5, "print_encode": 1.0, "print_encode_float": 1e-4,
    "pyramid_down": 1e-6, "pyramid_up_rows": 2e-6, "halation": 1e-5, "halation_density": 2e-5,
}
KERNELS = {
    "demosaic": ("raw2film_tpu_torch/csrc/demosaic.cu", "raw2film_tpu/ops/pallas_demosaic.py:191"),
    "pyramid_down": ("raw2film_tpu_torch/csrc/pyramid.cu", "raw2film_tpu/ops/pallas_pyramid.py:65"),
    "sep_rank": ("raw2film_tpu_torch/csrc/sep_rank_grain.cu", "raw2film_tpu/ops/pallas_conv2.py:576"),
    "pyramid_up_rows": ("raw2film_tpu_torch/csrc/pyramid.cu", "raw2film_tpu/ops/pallas_pyramid.py:277"),
    "halation": ("raw2film_tpu_torch/csrc/halation.cu", "raw2film_tpu/ops/pallas_halation.py:239"),
    "print_encode": ("raw2film_tpu_torch/csrc/print_encode.cu", "raw2film_tpu/ops/pallas_print.py:164"),
}
# Launches of each kernel in one 45 MP render: with halation, K2 runs twice
# (the /4 small blur and the MTF + grain).
LAUNCHES_ON = {
    "demosaic": 1, "pyramid_down": 1, "sep_rank": 2, "pyramid_up_rows": 1,
    "halation": 1, "print_encode": 1,
}
LAUNCHES_OFF = {
    "demosaic": 1, "pyramid_down": 0, "sep_rank": 1, "pyramid_up_rows": 0,
    "halation": 0, "print_encode": 1,
}
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
    torch.cuda.empty_cache()

    codes = mosaic_codes(H, W, SEED, device)
    launches, timing, render = main_path(
        device, codes, bundle, cfg, card, LAUNCHES_ON, "halation-on main path"
    )
    profile(render, "halation-on main path")
    del render
    torch.cuda.empty_cache()
    _, timing_off, _ = main_path(
        device, codes, bundle_off, cfg_off, card, LAUNCHES_OFF, "halation-off path"
    )
    for name, r in results.items():
        print(f"kernel {name} on {card}: {r['ms']!r} ms vs plain {r['plain_ms']!r} ms")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": launches[name],
            **results[name],
        }
        for name in KERNELS
    ]
    print(json.dumps({
        "kernels": kernels, "main_path": timing, "halation_off": timing_off, "card": card,
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
