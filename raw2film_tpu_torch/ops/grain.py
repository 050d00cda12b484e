"""Film grain: positionally stateless hash noise, its correlation, and the
density-dependent amplitude.

The counterpart of the grain parts of ``raw2film_tpu/ops/grain.py`` and
``raw2film_tpu/ops/pallas_grain.py``. The noise at image position (x, y) of
channel c is a pure function of (x, y + row_off, c * 0x9E3779B9 + seed)
through PCG-3D and a popcount binomial, so any tiling reproduces the same
field, and the kernel's epilogue (``csrc/sep_rank_grain.cu``) matches
:func:`grain_field_hash` here.

The grain seed is an explicit uint32 integer; a JAX ``noise_key`` maps to
``seed = key[0] ^ key[1]``.

The plain hash runs in int64 with every result masked to 32 bits, and the
32x32-bit products are split into 16-bit halves so that no product relies
on signed-overflow wrap.
"""

from __future__ import annotations

import numpy as np
import torch

from raw2film_tpu_torch.ops import fastmath as fm
from raw2film_tpu_torch.ops.conv import gaussian_kernel1d

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def correlation_sigma_px(scale: float, grain_size_mm: float, grain_sigma: float) -> float:
    return grain_size_mm * scale * grain_sigma


def grain_corr_taps(sigma_px: float) -> tuple:
    """L2-normalised correlation taps (the separable pass applied twice
    keeps the field at unit variance); sigma_px < 0.3 gives white noise."""
    if sigma_px >= 0.3:
        k = gaussian_kernel1d(sigma_px, truncate=2.5).astype(np.float64)
        k = k / np.linalg.norm(k)
    else:
        k = np.ones(1, np.float64)
    return tuple(float(t) for t in k)


def seed2(seed: int, row_off: int = 0) -> tuple[int, int]:
    """The (seed, global row offset) uint32 pair every grain form takes; a
    negative offset wraps mod 2^32."""
    return int(seed) & M32, int(row_off) & M32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for 32-bit values held in int64."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & M32


def pcg3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """PCG-3D (Jarzynski & Olano) on uint32 values held in int64; returns
    the two words the grain normals use."""
    v0 = (_mul32(x, 1664525) + 1013904223) & M32
    v1 = (_mul32(y, 1664525) + 1013904223) & M32
    v2 = (_mul32(z, 1664525) + 1013904223) & M32
    v0 = (v0 + _mul32(v1, v2)) & M32
    v1 = (v1 + _mul32(v2, v0)) & M32
    v2 = (v2 + _mul32(v0, v1)) & M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v0 = (v0 + _mul32(v1, v2)) & M32
    v1 = (v1 + _mul32(v2, v0)) & M32
    return v0, v1


def _popcount(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def hash_words(h: int, w: int, x0: int, y0: int, ch: int, seed: int,
               row_off: int = 0, device=None):
    """The two PCG-3D words at positions (x0 + j, y0 + i) of an (h, w) grid
    of channel ``ch``, as int64 tensors holding uint32 values."""
    seed, row_off = seed2(seed, row_off)
    yy = torch.arange(y0, y0 + h, device=device, dtype=torch.int64)
    xx = torch.arange(x0, x0 + w, device=device, dtype=torch.int64)
    y = ((yy + row_off) & M32)[:, None].expand(h, w)
    x = (xx & M32)[None, :].expand(h, w)
    z = (ch * GOLDEN + seed) & M32
    return pcg3d(x, y, torch.full((h, w), z, device=device, dtype=torch.int64))


def grain_noise(h: int, w: int, x0: int, y0: int, ch: int, seed: int,
                row_off: int = 0, device=None) -> torch.Tensor:
    """Binomial unit normals (popcount(a) + popcount(b) - 32) / 4."""
    a, b = hash_words(h, w, x0, y0, ch, seed, row_off, device)
    s = _popcount(a) + _popcount(b)
    return (s.to(torch.float32) - 32.0) * 0.25


def grain_field_hash(seed: int, hw: tuple, taps, row_off: int = 0,
                     device=None) -> torch.Tensor:
    """(3, H, W) correlated unit-variance field, the plain counterpart of
    ``raw2film_tpu/ops/pallas_grain.py::grain_field_hash``.

    The window of output (y, x) starts at (y, x): it is not centred. One
    channel at a time, which bounds the int64 temporaries."""
    h, w = hw
    taps = [float(np.float32(t)) for t in taps]
    n = len(taps)
    out = []
    for ch in range(3):
        noise = grain_noise(h + n - 1, w + n - 1, 0, 0, ch, seed, row_off, device)
        col = None
        for q in range(n):
            term = taps[q] * noise[q : q + h, :]
            col = term if col is None else col + term
        field = None
        for q in range(n):
            term = taps[q] * col[:, q : q + w]
            field = term if field is None else field + term
        out.append(field)
    return torch.stack(out)


def grain_params(grain_rms, grain_shape, scale: float) -> torch.Tensor:
    """The six-float amplitude vector [rms_eff, floor, peak_half, inv_width,
    lo, inv_rng] the kernel epilogue takes (render.py:284-301 of the JAX
    package), on the device of the bundle entries."""
    peak, width, floor, d_lo, d_hi = (grain_shape[i] for i in range(5))
    rng = torch.clamp(d_hi - d_lo, min=1e-3)
    pixel_um = 1000.0 / scale
    rms_eff = (grain_rms / 1000.0) * (48.0 / pixel_um)
    return torch.stack(
        [
            torch.as_tensor(p, dtype=torch.float32).reshape(())
            for p in (rms_eff, floor, peak / rng * 0.5, 1.0 / (width * 0.35), d_lo, 1.0 / rng)
        ]
    )


def grain_amplitude(d: torch.Tensor, prm: torch.Tensor) -> torch.Tensor:
    """rms_eff * (floor + (1 - floor) * exp(-0.5 ((t - peak_half - 1/4) *
    inv_width)^2)), t = (d - lo) * inv_rng."""
    rms_eff, floor, peak_half, inv_width, lo, inv_rng = (prm[i] for i in range(6))
    t = (d - lo) * inv_rng
    e = (t - peak_half - 0.25) * inv_width
    shape = floor + (1.0 - floor) * fm.expe(-0.5 * (e * e))
    return rms_eff * shape
