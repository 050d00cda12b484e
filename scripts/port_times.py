"""Times of the port's main-path kernels and renders on one NVIDIA GPU, for
the checkout it is run from, so that two checkouts compare in one call:

    cd <checkout> && python3 <path to>/scripts/port_times.py [label]

Imports ``raw2film_tpu_torch`` from the current directory (not from the
script's own checkout), builds its kernels, and prints the card's name and
power limit, then one JSON line:

- K2's MTF + grain launch (45 MP, 3 x 4 ranks x 23 taps, 3 grain taps) and
  its /4 small blur (3 x 1368 x 2052, ranks of 15 and 27 taps); K3 with and
  without the burn; K14 (4 ranks x 27 taps, the development); K10 at f = 4;
  K12 (the /4 level back to 5472 rows); K1 (the 45 MP uint16 mosaic with the
  normalize and a matrix); K8 and K7 at the 45 MP frame (3 grain taps) and
  the half-size frame (2736 x 4104, 1 tap), K9 at 45 MP, K5 and K6 (45 MP,
  the MTF's first 23-tap row, and 1 tap), ``sep_conv_rank`` (the MTF's 4
  ranks of one channel: 8 K5/K6 launches and 3 adds) and K11 (the 45 MP
  mosaic to the half-size frame); each held to
  its plain version first, then timed (CUDA events, median of 20 calls) and
  profiled (device time per launch, host-to-device and device-to-host
  copies); K2's, K7's, K8's and K9's outputs also by a digest of their
  bytes, so that two checkouts show whether they are bit-equal;
- K4 on the preview's MTF stack (3 x 540 x 360) and its grouped F.conv2d,
  in turns (one call per event pair);
- the 45 MP render with halation on and off: held to the plain versions
  (max code difference), median and best of 10 after 2 warm-ups (CUDA
  events), device ms per render (and the ten costliest kernels) and the
  copies each way per render under torch.profiler, peak device memory;
- process() of a seeded 45 MP DNG at the CLI default (a) and at full
  resolution (b): host clock, median of 5 after one warm-up.

Run parent, change, change, parent in one call to compare two checkouts.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

H, W = 5472, 8208
SEED = 20261016
NORM = (512.0, 1.0 / 15000.0)
SETTINGS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima", grain=2,
                sharpness=True, highlight_burn=0.3, seed=SEED)


def cuda_ms(fn, iters: int, warmup: int = 1) -> list[float]:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def profiled(fn, n: int, kernel: str | None = None) -> dict:
    """Device ms per call (of the kernels whose name holds ``kernel``, or
    of all) and host-to-device copies per call, over n calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            rows.append((e.key, e.count, e.self_cuda_time_total if t is None else t))
    mine = [(k, c, t) for k, c, t in rows if kernel is None or kernel in k]
    top = sorted(rows, key=lambda r: -r[2])[:10]
    return {
        "device_ms": sum(t for _, _, t in mine) / 1e3 / n,
        "h2d_per_call": sum(c for k, c, _ in rows if "HtoD" in k) / n,
        "d2h_per_call": sum(c for k, c, _ in rows if "DtoH" in k) / n,
        "top": [[k[:60], c // n, t / 1e3 / n] for k, c, t in top] if kernel is None else None,
    }


def mosaic_codes(h: int, w: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    row = torch.rand((1, w), generator=g, device=device) * 0.8 + 0.05
    col = torch.rand((h, 1), generator=g, device=device) * 0.8 + 0.4
    tex = torch.rand((h, w), generator=g, device=device) * 0.6 + 0.7
    codes = 512.0 + 15000.0 * row * col * tex
    return codes.clamp(0, 65535).to(torch.int32).to(torch.uint16)


def main() -> int:
    if not torch.cuda.is_available():
        print("port_times: no CUDA device", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    import raw2film_tpu_torch
    from raw2film_tpu_torch import Processor, load_film_bundle, render_chain_from_mosaic
    from raw2film_tpu_torch import data as ref_data
    from raw2film_tpu_torch.device import disable_tf32
    from raw2film_tpu_torch.io import dng
    from raw2film_tpu_torch.kernels import build as kb
    from raw2film_tpu_torch.ops import burn as burn_ops
    from raw2film_tpu_torch.ops import demosaic as dm
    from raw2film_tpu_torch.ops import grain as grain_ops
    from raw2film_tpu_torch.ops import halation as hal_ops
    from raw2film_tpu_torch.ops import mtf as mtf_ops
    from raw2film_tpu_torch.ops import print_encode as pe
    from raw2film_tpu_torch.ops import pyramid, sep_conv, sep_rank

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    disable_tf32()
    t0 = time.perf_counter()
    kb.lib()
    out = {"label": label, "package": os.path.dirname(raw2film_tpu_torch.__file__), "card": card,
           "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda", 0)
    params = dict(h=H, w=W, device=dev, grain=2, sharpness=True, highlight_burn=0.3)
    bundle, cfg = load_film_bundle(halation=True, **params)
    bundle_off, cfg_off = load_film_bundle(halation=False, **params)
    g = torch.Generator(device=dev).manual_seed(4)

    def kernel(name, fn, tol, kname, digest=False):
        with kb.plain_reference():
            ref = fn()
        got = fn()
        err = float((got.double() - ref.double()).abs().max())
        if not err <= tol:
            raise AssertionError(f"{name}: error {err} above {tol}")
        del ref
        out[name] = {"max_abs_err": err, "ms": statistics.median(cuda_ms(fn, 20)), **profiled(fn, 5, kname)}
        if digest:
            out[name]["digest"] = hashlib.sha256(got.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
        del got
        print(name, out[name], flush=True)

    u3, v3 = mtf_ops.mtf_taps(cfg.mtf_key, cfg.scale)
    gtaps = grain_ops.grain_corr_taps(grain_ops.correlation_sigma_px(cfg.scale, cfg.grain_size_mm, cfg.grain_sigma))
    grain = ((0xDEADBEEF, 5), torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=dev), gtaps)
    d = torch.rand((3, H, W), generator=g, device=dev) * 3.0
    kernel("k2_mtf_grain", lambda: sep_rank.fused_sep_rank(d, u3, v3, grain), 1e-5, "sep_rank_kernel", True)
    _, _, by_factor = hal_ops._full_res_ranks(cfg.scale / 4.0 * cfg.halation_size)
    su, sv = hal_ops.pyramid_taps(4, by_factor[4])
    sm = torch.rand((3, H // 4, W // 4), generator=g, device=dev)
    kernel("k2_small_blur", lambda: sep_rank.fused_sep_rank(sm, su, sv), 1e-5, "sep_rank_kernel")
    burn = burn_ops.burn_smallmap(d, bundle["d_ref_green"], cfg.burn_scale)
    pvec = bundle["pvec_host"] if "pvec_host" in bundle else pe.pack_print_vec(bundle)  # as the render passes it
    args = (d, pvec, cfg.print_mode, cfg.shadow_comp, cfg.sat_neutral, cfg.gamma_func, True)
    kernel("k3_burn", lambda: pe.print_encode(*args, burn), 1.0, "print_encode_kernel")
    kernel("k3_no_burn", lambda: pe.print_encode(*args), 1.0, "print_encode_kernel")
    us, vs, _ = hal_ops._full_res_ranks(cfg.scale / 4.0 * cfg.halation_size)
    rows_up = torch.rand((3, H, W // 4), generator=g, device=dev) * 0.5
    hargs = (d, us, vs, rows_up, hal_ops.colour_factors(bundle, False), hal_ops.develop_vector(bundle))
    kernel("k14", lambda: hal_ops.halation_mega(*hargs), 2e-5, "halation_kernel")
    kernel("k10_f4", lambda: pyramid.box_downsample_pyramid(d, 4), 1e-6, "box_downsample")
    kernel("k12", lambda: pyramid.bilinear_upsample_rows(sm, 4, H), 2e-6, "upsample_rows_kernel")
    del d, sm, rows_up, hargs, burn
    codes = mosaic_codes(H, W, SEED, dev)
    mat = np.array([[0.9, 0.2, -0.1], [0.1, 1.1, -0.2], [-0.05, 0.15, 0.95]], np.float32)
    kernel("k1", lambda: dm.demosaic_exposure(codes, "RGGB", mat, NORM), 2e-6, "demosaic_kernel")
    del codes

    gg = torch.Generator(device=dev).manual_seed(21)
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=dev)
    gseed = (0xDEADBEEF, (-7) & 0xFFFFFFFF)
    for frame, hw, scale in (("45mp", (H, W), cfg.scale), ("half", (H // 2, W // 2), cfg.scale / 2)):
        sigma = grain_ops.correlation_sigma_px(scale, cfg.grain_size_mm, cfg.grain_sigma)
        gd = torch.rand((3, *hw), generator=gg, device=dev) * 3.0
        kernel(f"k8_{frame}", lambda: grain_ops.grain_apply(gd, gseed, sigma, prm), 1e-5, "grain_", True)
        kernel(f"k7_{frame}", lambda: grain_ops.grain_field(gseed, hw, sigma, device=dev), 1e-5, "grain_", True)
        out[f"k8_{frame}"]["taps"] = out[f"k7_{frame}"]["taps"] = len(grain_ops.grain_corr_taps(sigma))
        if frame == "45mp":
            kernel("k9", lambda: grain_ops.grain_apply(gd, gseed, sigma, prm, True), 1e-5, "grain_apply_bw", True)
        del gd

    taps23 = np.asarray(v3[0, 0], np.float32)  # the MTF's first 23-tap row
    x = torch.rand((3, H, W), generator=g, device=dev)
    for name, fn in (("k5", sep_conv.conv_w), ("k6", sep_conv.conv_h)):
        kernel(name, lambda fn=fn: fn(x, taps23), 0.0, f"{fn.__name__}_kernel", True)
        kernel(f"{name}_1tap", lambda fn=fn: fn(x, np.ones(1, np.float32)), 0.0, f"{fn.__name__}_kernel")
    uj, vj = (np.asarray(t[0]) for t in (u3, v3))
    kernel("sep_conv_rank", lambda: sep_conv.sep_conv_rank(x, uj, vj), 1e-5, "conv_")
    half = mosaic_codes(H, W, SEED, dev)
    kernel("k11", lambda: dm.half_size_decode(half, "RGGB", NORM), 0.0, "half_size")
    del x, half

    _, cfg15 = load_film_bundle(h=540, w=360, device=dev, grain=2, sharpness=True)
    p3, q3 = mtf_ops.mtf_taps(cfg15.mtf_key, cfg15.scale)
    x = torch.rand((3, 540, 360), generator=g, device=dev) * 3.0
    k2d = np.einsum("crk,crl->ckl", np.asarray(p3, np.float64), np.asarray(q3, np.float64)).astype(np.float32)
    xp = F.pad(x[None], (k2d.shape[2] // 2,) * 2 + (k2d.shape[1] // 2,) * 2, mode="reflect")
    wt = torch.as_tensor(k2d[:, None], device=dev)
    fns = {"kernel": lambda: sep_rank.fused_sep_rank(x, p3, q3), "conv2d": lambda: F.conv2d(xp, wt, groups=3)}
    turns = {k: [] for k in fns}
    for _ in range(100):
        for k, fn in fns.items():
            fn()
            turns[k].append(cuda_ms(fn, 1, warmup=0)[0])
    out["k4_in_turns"] = {k: statistics.median(v) for k, v in turns.items()}
    print("k4_in_turns", out["k4_in_turns"], flush=True)

    codes = mosaic_codes(H, W, SEED, dev)
    cam = ref_data.REC709_TO_XYZ
    for name, (b, c) in {"render_on": (bundle, cfg), "render_off": (bundle_off, cfg_off)}.items():
        def render(b=b, c=c):
            return render_chain_from_mosaic(codes, cam, b, c, SEED, norm=NORM, device=dev)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = render()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        with kb.plain_reference():
            ref = render()
        worst = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        del got, ref
        ms = cuda_ms(render, 10, warmup=2)
        out[name] = {"ms": statistics.median(ms), "best_ms": min(ms), "all_ms": ms, "peak_bytes": peak,
                     "max_code_diff": worst, **profiled(render, 3)}
        print(name, out[name], flush=True)
        if worst > 1:
            raise AssertionError(f"{name} differs from the plain path by {worst} codes")
    del codes

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.dng")
        dng.write_dng(path, mosaic_codes(H, W, SEED, dev).cpu().numpy(), black_level=512, white_level=24000)
        proc = Processor(device=dev)
        for name, kw in {"process_a": {}, "process_b": dict(half_size=False, max_scale=None)}.items():
            kw = dict(SETTINGS, **kw)
            proc.process(path, cache=False, **kw)
            wall = []
            for _ in range(5):
                t0 = time.perf_counter()
                proc.process(path, cache=False, **kw)
                wall.append((time.perf_counter() - t0) * 1e3)
            out[name] = {"ms": statistics.median(wall), "all_ms": wall}
            print(name, out[name], flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
