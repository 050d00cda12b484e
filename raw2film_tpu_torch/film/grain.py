"""Grain science: correlation kernel, amplitude curve, host field generator.

Capability parity with the reference's ``spectral_film_lut.grain_generation``
(``generate_grain``, ``grain_kernel``) and ``FilmSpectral.grain_transform`` /
``get_grain_curve`` (reference call sites: src/raw2film/effects.py:220-236,
src/raw2film/gpu_processor.py:905-935).

Model
-----
* The grain *field* is unit-variance Gaussian noise low-pass filtered by a
  Gaussian correlation kernel whose spatial extent is the physical grain-clump
  size (``grain_size_mm`` at ``scale`` px/mm, shape factor ``grain_sigma``).
  The kernel is normalized by its L2 norm so the filtered field keeps unit
  variance — amplitude is then fully owned by the grain curve.
* The *amplitude* per pixel follows RMS granularity science: the stock's
  ``rms`` (sigma x1000 through the ISO 48-micron aperture at D=1) scaled by
  sqrt(aperture-area / pixel-area), shaped over density by
  :class:`raw2film_tpu_torch.film.stock.GrainModel`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from raw2film_tpu_torch.config import DEFAULT_DTYPE

ISO_APERTURE_UM = 48.0


def grain_kernel(
    pixel_size_mm: float, grain_size_mm: float = 0.006, grain_sigma: float = 0.4
) -> np.ndarray | None:
    """Gaussian correlation kernel, or None when grain is sub-pixel
    (reference returns None then and the GPU path substitutes a 1x1 identity,
    src/raw2film/gpu_processor.py:927-932)."""
    sigma_px = grain_size_mm / pixel_size_mm * grain_sigma
    if sigma_px < 0.3:
        return None
    radius = max(1, int(np.ceil(2.5 * sigma_px)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k1 = np.exp(-0.5 * (x / sigma_px) ** 2)
    k = np.outer(k1, k1)
    k /= np.linalg.norm(k)  # unit L2: preserves noise variance
    return k.astype(DEFAULT_DTYPE)


def pixel_rms_scale(scale_px_per_mm: float) -> float:
    """sqrt(area) scaling from the ISO measuring aperture to one pixel."""
    pixel_um = 1000.0 / scale_px_per_mm
    return ISO_APERTURE_UM / pixel_um


def grain_amplitude(stock, density: np.ndarray, scale: float, bw_grain: bool = False):
    """Per-pixel grain sigma in density units. ``density`` shape (3,H,W) or
    any broadcastable array. The reference's ``grain_transform``
    (src/raw2film/effects.py:233)."""
    gm = stock.grain
    if gm is None:
        return np.zeros_like(density)
    d_min, *_ = stock.curve.params()
    lo = float(np.min(d_min))
    hi = float(np.max(stock.curve.d_max))
    if hi < lo:  # reversal stocks store the high end in d_min
        lo, hi = hi, lo
    amp = gm.amplitude(density, lo, hi) * pixel_rms_scale(scale)
    if bw_grain and density.ndim == 3 and density.shape[0] == 3:
        amp = np.broadcast_to(amp.mean(axis=0, keepdims=True), amp.shape)
    return amp.astype(DEFAULT_DTYPE)


def get_grain_curve(stock, scale: float, adx: bool = False, bw_grain: bool = False):
    """Tabulated amplitude vs density, reference (4, N) layout
    (reference: src/raw2film/gpu_processor.py:913 get_grain_curve)."""
    n = 256
    d = np.linspace(0.0, 4.0, n)
    out = np.empty((4, n), np.float32)
    out[0] = d
    amp = grain_amplitude(stock, d, scale, bw_grain=False)
    for c in range(3):
        out[1 + c] = amp
    return out


@lru_cache(maxsize=8)
def _cached_noise(shape: tuple, seed: int, channels: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((channels,) + shape).astype(DEFAULT_DTYPE)


def generate_grain(
    shape: tuple,
    scale: float,
    grain_size_mm: float = 0.006,
    bw: bool = False,
    cached: bool = True,
    grain_sigma: float = 0.4,
    seed: int = 0,
) -> np.ndarray:
    """Host (oracle) correlated unit-variance grain field, planar (3,H,W).

    Unlike the reference GPU path (fresh random seed per render,
    src/raw2film/gpu_processor.py:586-591), this is deterministic per seed.
    """
    from scipy.signal import fftconvolve

    hw = tuple(shape[-2:]) if len(shape) >= 2 else tuple(shape)
    channels = 1 if bw else 3
    noise = _cached_noise(hw, seed, channels) if cached else (
        np.random.default_rng(seed).standard_normal((channels,) + hw).astype(DEFAULT_DTYPE)
    )
    k = grain_kernel(1.0 / scale, grain_size_mm, grain_sigma)
    if k is not None:
        noise = np.stack(
            [fftconvolve(noise[c], k, mode="same") for c in range(channels)]
        ).astype(DEFAULT_DTYPE)
    if bw:
        noise = np.broadcast_to(noise, (3,) + hw)
    return noise
