"""Film grain: positionally stateless hash noise, its correlation, the
density-dependent amplitude, the grain field alone, and the grain apply
without the MTF.

The counterpart of the grain parts of ``raw2film_tpu/ops/grain.py`` and
``raw2film_tpu/ops/pallas_grain.py``. The noise at image position (x, y) of
channel c is a pure function of (x, y + row_off, c * 0x9E3779B9 + seed)
through PCG-3D and a popcount binomial, so any tiling reproduces the same
field, and the kernels' grain code (``csrc/grain.cuh``, in K2's epilogue and
in K8 and K9) matches :func:`grain_field_hash` here.

:func:`grain_field` is K7 (the field alone, ``grain_field_pallas``), reached
through :func:`generate_grain_field` and :func:`apply_grain` and by the render
for grain modes other than 1 and 2. :func:`grain_apply` is K8 (colour grain,
``grain_apply_pallas``) and, with ``bw=True``, K9 (one field shared by the
channels and the channel-mean amplitude, ``grain_apply_bw_pallas``). On a
CUDA device they launch ``csrc/grain.cu``, on the CPU they run
:func:`grain_field_hash` and :func:`grain_apply_plain`. K7 and K8 take one
of three kernels by the tap count (:func:`grain_path`: white noise, a
count compiled in, or the general one) and, on the first two, 16-byte loads
and stores where :func:`vec_path` allows.

The grain seed is an explicit uint32 integer; a JAX ``noise_key`` maps to
``seed = key[0] ^ key[1]``.

The plain hash runs in int64 with every result masked to 32 bits, and the
32x32-bit products are split into 16-bit halves so that no product relies
on signed-overflow wrap.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raw2film_tpu_torch.device import require_cuda
from raw2film_tpu_torch.film.grain import ISO_APERTURE_UM
from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import fastmath as fm
from raw2film_tpu_torch.ops.conv import gaussian_kernel1d
from raw2film_tpu_torch.utils import trace

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
MAX_TAPS = 31  # the kernels' limit on correlation taps (csrc/grain.cuh)
# Tap counts K7 and K8 have a kernel for, with the count compiled in
# (csrc/grain.cu, "COMPILED_TAPS"); 1 tap is white noise.
COMPILED_TAPS = (3, 5)
THIRD = float(np.float32(1.0 / 3.0))


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
                     device=None, channels: int = 3) -> torch.Tensor:
    """(channels, H, W) correlated unit-variance field, the plain
    counterpart of ``raw2film_tpu/ops/pallas_grain.py::grain_field_hash``
    (channel c salted with c * 0x9E3779B9; the black-and-white grain uses
    channel 0 alone).

    The window of output (y, x) starts at (y, x): it is not centred. One
    channel at a time, which bounds the int64 temporaries."""
    h, w = hw
    taps = [float(np.float32(t)) for t in taps]
    n = len(taps)
    out = []
    for ch in range(channels):
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


def grain_shape(d: torch.Tensor, prm: torch.Tensor) -> torch.Tensor:
    """floor + (1 - floor) * exp(-0.5 ((t - peak_half - 1/4) * inv_width)^2),
    t = (d - lo) * inv_rng: the amplitude without rms_eff."""
    _, floor, peak_half, inv_width, lo, inv_rng = (prm[i] for i in range(6))
    t = (d - lo) * inv_rng
    e = (t - peak_half - 0.25) * inv_width
    return floor + (1.0 - floor) * fm.expe(-0.5 * (e * e))


def grain_amplitude(d: torch.Tensor, prm: torch.Tensor) -> torch.Tensor:
    """rms_eff * grain_shape(d)."""
    return prm[0] * grain_shape(d, prm)


def grain_path(n: int) -> str:
    """The K7 / K8 kernel for n correlation taps, as ``csrc/grain.cu``
    chooses it: "white" (1 tap, elementwise), "taps" (a count in
    COMPILED_TAPS: register runs), else "general"."""
    if n == 1:
        return "white"
    return "taps" if n in COMPILED_TAPS else "general"


def vec_path(w: int, *ptrs) -> bool:
    """Whether K7 / K8 take their 16-byte loads and stores: W a multiple of
    4 and every buffer 16-byte aligned (the general path ignores it)."""
    return w % 4 == 0 and all(p % 16 == 0 for p in ptrs)


# ------------------------------------------------------------ K8, K9


def grain_apply_plain(d: torch.Tensor, seed: tuple[int, int], taps, prm: torch.Tensor,
                      bw: bool = False) -> torch.Tensor:
    """Plain version of K8 (``bw=False``) and K9 (``bw=True``)."""
    s, row_off = seed
    if not bw:
        field = grain_field_hash(s, d.shape[-2:], taps, row_off, d.device)
        return torch.clamp(d + grain_amplitude(d, prm) * field, min=0.0)
    field = grain_field_hash(s, d.shape[-2:], taps, row_off, d.device, channels=1)[0]
    amp = prm[0] * THIRD * (grain_shape(d[0], prm) + grain_shape(d[1], prm) + grain_shape(d[2], prm))
    return torch.clamp(d + amp * field, min=0.0)


def grain_apply(d: torch.Tensor, seed: tuple[int, int], sigma_px: float, prm: torch.Tensor,
                bw: bool = False) -> torch.Tensor:
    """K8 / K9 wrapper: max(d + amp(d) * field, 0) on a (C, H, W) float32
    density image (K9: C = 3). ``seed`` is the (seed, row_off) pair of
    :func:`seed2`; ``prm`` the six amplitude floats of :func:`grain_params`."""
    taps = grain_corr_taps(float(sigma_px))
    if len(taps) > MAX_TAPS:
        raise ValueError(f"grain: {len(taps)} taps, the kernels take {MAX_TAPS}")
    if bw and d.shape[0] != 3:
        raise ValueError(f"black-and-white grain: want 3 channels, got {tuple(d.shape)}")
    if not kb.use_kernel(d):
        return grain_apply_plain(d, seed, taps, prm, bw)
    kb.require(d, "density", torch.float32)
    if d.dim() != 3:
        raise ValueError(f"density: want (C, H, W), got {tuple(d.shape)}")
    prm = trace.to_device(prm, d.device, torch.float32).contiguous()
    kb.require(prm, "grain prm", torch.float32, (6,))
    c, h, w = d.shape
    s, row_off = seed2(*seed)
    out = torch.empty_like(d)
    ctaps = (ctypes.c_float * len(taps))(*taps)
    vec = not bw and vec_path(w, d.data_ptr(), out.data_ptr())
    err = kb.lib().r2f_grain_apply(
        d.data_ptr(), out.data_ptr(), c, h, w, int(bw), s, row_off, prm.data_ptr(),
        ctypes.cast(ctaps, ctypes.c_void_p), len(taps), int(vec), kb.stream_ptr(d),
    )
    kb.check(err, "r2f_grain_apply")
    trace.count("launch.grain_apply_bw" if bw else "launch.grain_apply")
    return out


# ------------------------------------------------------------ K7


def grain_field(seed: tuple[int, int], hw: tuple[int, int], sigma_px: float, bw: bool = False,
                device=None) -> torch.Tensor:
    """K7 wrapper: the (3, H, W) correlated unit-variance field on
    ``device`` (by default the first CUDA device). ``seed`` is the (seed,
    row_off) pair of :func:`seed2`; ``bw``: one field (channel 0's)
    broadcast to the three channels, as a view."""
    taps = grain_corr_taps(float(sigma_px))
    if len(taps) > MAX_TAPS:
        raise ValueError(f"grain: {len(taps)} taps, the kernels take {MAX_TAPS}")
    h, w = (int(v) for v in hw)
    c = 1 if bw else 3
    s, row_off = seed2(*seed)
    device = torch.device(device) if device is not None else require_cuda()
    if not kb.use_kernel_on(device):
        field = grain_field_hash(s, (h, w), taps, row_off, device, channels=c)
    else:
        field = torch.empty((c, h, w), dtype=torch.float32, device=device)
        ctaps = (ctypes.c_float * len(taps))(*taps)
        err = kb.lib().r2f_grain_field(
            field.data_ptr(), c, h, w, s, row_off, ctypes.cast(ctaps, ctypes.c_void_p),
            len(taps), int(vec_path(w, field.data_ptr())), kb.stream_ptr(field),
        )
        kb.check(err, "r2f_grain_field")
        trace.count("launch.grain_field")
    return field.expand(3, h, w) if bw else field


def generate_grain_field(key, hw: tuple[int, int], scale: float, grain_size_mm: float = 0.006,
                         grain_sigma: float = 0.4, bw: bool = False, row_offset: int = 0,
                         device=None) -> torch.Tensor:
    """Unit-variance correlated grain field, planar (3, H, W): the
    counterpart of ``raw2film_tpu/ops/grain.py::generate_grain_field``.
    ``key`` is a (uint32, uint32) pair (a JAX key's two words, whose XOR
    seeds the hash); the field comes from K7 on a CUDA ``device``."""
    sigma_px = correlation_sigma_px(scale, grain_size_mm, grain_sigma)
    seed = (int(key[0]) ^ int(key[1])) & M32
    return grain_field(seed2(seed, row_offset), hw, sigma_px, bw=bw, device=device)


def grain_amplitude_device(density: torch.Tensor, rms: float, d_lo: float, d_hi: float,
                           scale: float, peak_density: float, width: float, floor: float,
                           bw_grain: bool = False) -> torch.Tensor:
    """The stock's grain amplitude at each density, scaled to the pixel
    (``GrainModel.amplitude`` times the pixel rms scale); ``bw_grain``: the
    channel mean, broadcast."""
    rng = max(float(d_hi - d_lo), 1e-3)
    t = (density - d_lo) / rng
    e = (t - peak_density / rng * 0.5 - 0.25) / (width * 0.35)
    shape = floor + (1 - floor) * fm.expe(-0.5 * (e * e))
    pixel_um = 1000.0 / scale
    amp = (rms / 1000.0) * shape * (ISO_APERTURE_UM / pixel_um)
    if bw_grain:
        amp = amp.mean(dim=0, keepdim=True).expand_as(amp)
    return amp


def apply_grain(density: torch.Tensor, key, stock, scale: float, grain_size_mm: float = 0.006,
                grain_sigma: float = 0.4, bw_grain: bool = False) -> torch.Tensor:
    """density (3, H, W) + amplitude(density) * field, clipped at 0 (the
    counterpart of ``raw2film_tpu/ops/grain.py::apply_grain``); the field
    comes from K7 on the density's device."""
    gm = stock.grain
    if gm is None:
        return density
    d_min, *_ = stock.curve.params()
    lo = float(np.min(d_min))
    hi = float(np.max(stock.curve.d_max))
    if hi < lo:
        lo, hi = hi, lo
    field = generate_grain_field(key, tuple(density.shape[-2:]), scale, grain_size_mm, grain_sigma,
                                 bw=bw_grain, device=density.device)
    amp = grain_amplitude_device(density, gm.rms, lo, hi, scale, gm.peak_density, gm.width,
                                 gm.floor, bw_grain=bw_grain)
    return torch.clamp(density + amp * field, min=0.0)
