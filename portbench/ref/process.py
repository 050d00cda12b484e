"""The plain reference of what ``Processor.process`` and ``PreviewEngine``
derive around the render: the film parameters from a configuration's
settings, the render's look, the grain key, the host exposure estimate, the
aspect crop, and the preview's staged decode, resampling and histogram.

Each is written for this benchmark from the program's host code as it stood
when the benchmark was added; none imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.ref.film import chain as fchain
from portbench.ref.film import loader

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ------------------------------------------------------------ film and look


def film_params(settings: dict, device) -> dict:
    """The film parameters a render reads, from the stocks and settings
    (the program builds the same from the same settings in
    ``Processor.load_film_bundle``)."""
    stocks = loader.load_film_stocks()
    neg = stocks[settings["negative_film"]]
    prt = stocks[settings["print_film"]] if settings.get("print_film") else None
    m = settings
    neg_p = fchain.build_negative_params(
        neg, exp_kelvin=m["exp_kelvin"], tint=m["tint"], exp_comp=m["exp_comp"],
        push_pull=m["push_pull"], color_masking=m["color_masking"],
    )
    inversion = bool(m.get("inversion", False)) or (prt is None and neg.film_type == "negative")
    prt_p = fchain.build_print_params(
        neg, prt, red_light=m["red_light"], green_light=m["green_light"], blue_light=m["blue_light"],
        projector_kelvin=m["projector_kelvin"], shadow_comp=m["shadow_comp"],
        inversion_gamma=m["inversion_gamma"], idealized_curve=m["idealized_curve"],
        inversion=inversion, white_balance=m["white_balance"], neg_params=neg_p,
    )
    out_p = fchain.build_output_params(
        neg, prt, prt_p, neg_p, projector_kelvin=m["projector_kelvin"], sat_adjust=m["sat_adjust"],
        gamma_func=m["gamma_func"], white_clip=m["white_clip"],
    )
    gm = neg.grain
    d_min, *_ = neg.curve.params()
    lo, hi = float(np.min(d_min)), float(np.max(neg.curve.d_max))
    if hi < lo:
        lo, hi = hi, lo
    d_ref = neg.d_ref
    f32 = lambda a: np.array(a, np.float32)  # noqa: E731
    parts = [prt_p.a, prt_p.log_e0, *prt_p.curve, prt_p.d_offset, prt_p.v, prt_p.shadow_comp,
             prt_p.shadow_ref, prt_p.vd_offset, out_p.to_display, out_p.white_gain, m["sat_adjust"],
             m["highlight_burn"]]
    pvec = np.concatenate([f32(p).reshape(-1) for p in parts])
    if pvec.shape != (61,):
        raise ValueError(f"print vector of {pvec.shape}, want (61,)")

    def dev(a):
        return torch.as_tensor(f32(a), device=device)

    return {
        "m_in": dev(neg_p.m_in),
        "flare": dev(neg_p.flare),
        "neg_curve": tuple(dev(c) for c in neg_p.curve),
        "mask": dev(neg_p.mask),
        "d_min": dev(neg_p.d_min),
        "pvec": pvec,
        "hal_intensity": dev(m["halation_intensity"]),
        "hal_green": dev(m["halation_green_factor"]),
        "d_ref_green": dev(float(d_ref[1] if len(d_ref) > 1 else d_ref[0])),
        "grain_rms": dev(gm.rms if gm else 0.0),
        "grain_shape": dev((gm.peak_density, gm.width, gm.floor, lo, hi) if gm else (1.0, 1.2, 0.15, 0.0, 4.0)),
        "print_mode": prt_p.mode,
        "neg": neg,
        "prt": prt,
    }


def look(settings: dict, film: dict, scale: float) -> dict:
    """The render's static choices (the program's ``build_render_config``)."""
    neg, prt = film["neg"], film["prt"]
    m = settings
    if not (neg.is_bw or float(m["color_masking"]) == 1.0):
        raise ValueError("the reference renders identity masking only")
    mtf_on = bool(m["sharpness"]) and neg.mtf is not None
    grain = int(m["grain"]) if neg.rms_density is not None else 0
    return {
        "scale": float(scale),
        "halation": bool(m["halation"]),
        "halation_size": float(m["halation_size"]),
        "sharpness": mtf_on,
        "mtf": neg.mtf,
        "mtf_signed": bool(m.get("mtf_fidelity", False)),
        "grain": grain,
        "grain_size_mm": float(m["grain_size"]) / 1000.0,
        "grain_sigma": float(m["grain_sigma"]),
        "highlight_burn": bool(m["highlight_burn"]) and (prt is not None or neg.density_measure in ("status_m", "bw")),
        "burn_scale": float(m["burn_scale"]),
        "print_mode": film["print_mode"],
        "shadow_comp": bool(m["shadow_comp"]),
        "sat_neutral": float(m["sat_adjust"]) == 1.0,
        "gamma_func": str(m["gamma_func"]),
    }


# ------------------------------------------------------------ grain key


def _threefry2x32(key, x0: int, x1: int):
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def process_grain_seed(seed: int, index: int = 0) -> int:
    """The uint32 grain seed ``process(seed=...)`` renders image ``index``
    with: JAX's fold_in(PRNGKey(seed), index), its two words xor-ed."""
    k = _threefry2x32((0, int(seed) & _M32), 0, int(index) & _M32)
    return k[0] ^ k[1]


# ------------------------------------------------------------ exposure


def exposure_stops(lum: np.ndarray, meta: dict, ref_exposure: float = 0.18) -> float:
    """Stops to mid-grey: the power mean of the green plane it is given, with
    the exponent sqrt(N^2 / ISO / t) + 1 from the EXIF."""
    factor = math.sqrt(meta["f_number"] ** 2 / meta["iso"] / meta["exposure_time"]) + 1.0
    lum = np.maximum(lum, 1e-9)
    avg = float(np.mean(lum ** (1.0 / factor)) ** factor)
    return math.log2(ref_exposure / max(avg, 1e-9))


def fused_gain(mosaic: np.ndarray, pattern: str, cam: np.ndarray, black: float, inv_range: float,
               meta: dict) -> np.float32:
    """The fused path's exposure gain: the estimate over the green plane,
    every second row and column, of the host half-size decode in XYZ."""
    if pattern != "RGGB":
        raise ValueError("the reference decodes RGGB only")
    h2, w2 = mosaic.shape[0] // 2, mosaic.shape[1] // 2
    m = mosaic[: h2 * 2, : w2 * 2]

    def cell(y, x):
        return np.clip((m[y::2, x::2].astype(np.float32) - black) * inv_range, 0.0, 1.0)

    r, g1, g2, b = cell(0, 0), cell(0, 1), cell(1, 0), cell(1, 1)
    g = np.mean([g1, g2], axis=0)
    rgb = np.stack([r, g, b])
    xyz = np.einsum("ij,jhw->ihw", cam, rgb).astype(np.float32)
    return np.float32(2.0 ** exposure_stops(xyz[1, ::2, ::2], meta))


def _aspect_window(h: int, w: int, aspect: float):
    x, y = h, w
    if x > y:
        if x > aspect * y:
            return slice(math.ceil(x / 2 - y * aspect / 2), math.ceil(x / 2 + y * aspect / 2)), slice(0, y)
        return slice(0, x), slice(math.ceil(y / 2 - x / aspect / 2), math.ceil(y / 2 + x / aspect / 2))
    if y > aspect * x:
        return slice(0, x), slice(math.ceil(y / 2 - x * aspect / 2), math.ceil(y / 2 + x * aspect / 2))
    return slice(math.ceil(x / 2 - y / aspect / 2), math.ceil(x / 2 + y / aspect / 2)), slice(0, y)


def aspect_crop(h: int, w: int, aspect: float):
    """The window the frame's aspect keeps (applied twice, as the program's
    geometry does): (rows, cols)."""
    r1, c1 = _aspect_window(h, w, aspect)
    r2, c2 = _aspect_window(r1.stop - r1.start, c1.stop - c1.start, aspect)
    return (slice(r1.start + r2.start, r1.start + r2.stop), slice(c1.start + c2.start, c1.start + c2.stop))
