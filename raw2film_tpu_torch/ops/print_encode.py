"""The chain's tail in one pass: [burn] -> print -> encode -> [uint8].

The counterpart of ``raw2film_tpu/ops/pallas_print.py``. On a CUDA tensor
:func:`print_encode` launches kernel K3 (``csrc/print_encode.cu``); on a CPU
tensor it runs :func:`print_encode_plain`. All continuously varying film
parameters travel in one float32[61] vector, in the JAX package's layout:

    [0:9]   A            print density -> log-exposure matrix, row-major
    [9:12]  log_e0       per-channel print exposure anchor
    [12:30] print H&D    d_min, gamma, x_toe, x_sh, w_toe, w_sh (3 each)
    [30:33] d_offset     inversion/direct density offset
    [33:42] V            view matrix, row-major
    [42]    shadow_comp  [43] shadow_ref
    [44:47] vd_offset
    [47:56] to_display   row-major
    [56:59] white_gain
    [59]    sat
    [60]    highlight_burn strength (used only with the burn prologue)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import fastmath as fm
from raw2film_tpu_torch.utils import trace

PVEC_LEN = 61
# The bundle entries the vector is packed from (pack_print_vec).
PVEC_KEYS = ("a", "log_e0", "prt_curve", "d_offset", "v", "shadow_comp", "shadow_ref", "vd_offset",
             "to_display", "white_gain", "sat", "highlight_burn")
# Transfer-function codes of csrc/common.cuh (enum Gamma).
GAMMA_CODES = {
    "Linear": 0, "sRGB": 1, "Display P3": 1, "Rec709": 2,
    "Gamma 2.2": 3, "Gamma 2.4": 4, "ARRI LogC3": 5,
}
MODES = {"print": 0, "inversion": 1, "direct": 1}


def pack_print_vec(bundle: dict) -> torch.Tensor:
    """Flatten the tail's bundle entries into the 61-float layout."""

    def flat(v, n):
        return torch.as_tensor(v).reshape(n).to(torch.float32)

    parts = [flat(bundle["a"], 9), flat(bundle["log_e0"], 3)]
    parts += [flat(c, 3) for c in bundle["prt_curve"]]
    parts += [
        flat(bundle["d_offset"], 3),
        flat(bundle["v"], 9),
        flat(bundle["shadow_comp"], 1),
        flat(bundle["shadow_ref"], 1),
        flat(bundle["vd_offset"], 3),
        flat(bundle["to_display"], 9),
        flat(bundle["white_gain"], 3),
        flat(bundle["sat"], 1),
        flat(bundle["highlight_burn"], 1),
    ]
    return torch.cat(parts)


def print_encode_plain(d, pvec, mode, shadow, sat_neutral, gamma, quantize=True, burn=None):
    """Plain version of K3: (3, H, W) density -> (3, H, W) uint8 (or the
    encoded float32 image when ``quantize`` is False)."""
    P = pvec
    dp = (d[0], d[1], d[2])
    if burn is not None:
        small, rowmat, colmat = burn
        up = torch.matmul(torch.matmul(rowmat, small), colmat)
        dp = tuple(torch.clamp(q - P[60] * up, min=0.0) for q in dp)
    if mode == "print":
        d_pp = []
        for c in range(3):
            log_e = P[9 + c] - (P[3 * c] * dp[0] + P[3 * c + 1] * dp[1] + P[3 * c + 2] * dp[2])
            d_pp.append(
                P[12 + c]
                + P[15 + c]
                * (
                    fm.softplus(log_e - P[18 + c], P[24 + c])
                    - fm.softplus(log_e - P[21 + c], P[27 + c])
                )
            )
    else:
        d_pp = [dp[c] - P[30 + c] for c in range(3)]
    vd = [P[33 + 3 * c] * d_pp[0] + P[34 + 3 * c] * d_pp[1] + P[35 + 3 * c] * d_pp[2] for c in range(3)]
    if shadow:
        vd = [q - P[42] * fm.softplus(q - P[43], 0.35) for q in vd]
    lin = [fm.pow10(-(vd[c] + P[44 + c])) for c in range(3)]
    rgb = [
        (P[47 + 3 * c] * lin[0] + P[48 + 3 * c] * lin[1] + P[49 + 3 * c] * lin[2]) * P[56 + c]
        for c in range(3)
    ]
    if not sat_neutral:
        luma = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
        rgb = [luma + P[59] * (q - luma) for q in rgb]
    out = torch.stack([fm.encode(q, gamma) for q in rgb])
    if not quantize:
        return out
    return torch.round(out * 255.0).to(torch.uint8)


def vector_path(w: int, *ptrs) -> bool:
    """Whether K3 takes 16-byte density loads and 4-byte code stores: W a
    multiple of 4 and every buffer (density, output, colmat or None)
    16-byte aligned."""
    return w % 4 == 0 and all(p is None or p % 16 == 0 for p in ptrs)


def print_encode(d, pvec, mode, shadow, sat_neutral, gamma, quantize=True, burn=None):
    """K3 wrapper. d (3, H, W) float32; pvec float32[61], a host array (the
    bundle's ``pvec_host``) or a tensor, passed to the kernel by value;
    burn = (small (hs, ws), rowmat (H, hs), colmat (ws, W)) or None."""
    if gamma not in GAMMA_CODES:
        raise ValueError(f"unknown gamma_func {gamma!r}")
    if mode not in MODES:
        raise ValueError(f"unknown print mode {mode!r}")
    if not kb.use_kernel(d):
        if not isinstance(pvec, torch.Tensor):
            pvec = trace.to_device(np.array(pvec, np.float32), d.device)
        return print_encode_plain(d, pvec, mode, shadow, sat_neutral, gamma, quantize, burn)
    if d.dim() != 3 or d.shape[0] != 3:
        raise ValueError(f"density: want (3, H, W), got {tuple(d.shape)}")
    _, h, w = d.shape
    kb.require(d, "density", torch.float32)
    if tuple(pvec.shape) != (PVEC_LEN,):
        raise ValueError(f"pvec: shape {tuple(pvec.shape)}, want ({PVEC_LEN},)")
    # by value: a host array is read as it is; a device tensor's copy to the
    # host waits for the work queued before it (the density)
    if isinstance(pvec, torch.Tensor):
        pvec = trace.to_host(pvec.detach()).to(torch.float32).numpy()
    pv = (ctypes.c_float * PVEC_LEN)(*np.asarray(pvec, np.float32).tolist())
    hs = ws = 0
    ptrs = (None, None, None)
    if burn is not None:
        small, rowmat, colmat = (t.contiguous() for t in burn)
        hs, ws = small.shape
        kb.require(small, "burn small", torch.float32, (hs, ws))
        kb.require(rowmat, "burn rowmat", torch.float32, (h, hs))
        kb.require(colmat, "burn colmat", torch.float32, (ws, w))
        ptrs = (small.data_ptr(), rowmat.data_ptr(), colmat.data_ptr())
    out = torch.empty(
        (3, h, w), dtype=torch.uint8 if quantize else torch.float32, device=d.device
    )
    vec = vector_path(w, d.data_ptr(), out.data_ptr(), ptrs[2])
    err = kb.lib().r2f_print_encode(
        d.data_ptr(), ctypes.cast(pv, ctypes.c_void_p), *ptrs, hs, ws, out.data_ptr(), h, w,
        MODES[mode], int(bool(shadow)), int(bool(sat_neutral)), GAMMA_CODES[gamma],
        int(bool(quantize)), int(burn is not None), int(vec), kb.stream_ptr(d),
    )
    kb.check(err, "r2f_print_encode")
    trace.count("launch.print_encode")
    return out
