"""Tabulated-LUT builders: the reference's LUT API surface.

The TPU hot path evaluates the chain in closed form
(:mod:`raw2film_tpu_torch.film.chain`), but the framework also exposes the
reference's LUT-centric API for interop (`.cube` export, ICC post-bake,
third-party LUT application, the generic device LUT ops):

* :func:`get_input_lut`   — 2D chromaticity LUT, (N, N, 3)
  (reference: ``FilmSpectral.get_input_lut``, src/raw2film/cpu_processor.py:160)
* :func:`get_density_curve` — (4, N) H&D curve table
  (reference: src/raw2film/cpu_processor.py:182)
* :func:`create_lut`      — 3D print LUT over density/4, (N, N, N, 3)
  (reference: ``spectral_film_lut.utils.create_lut``,
  src/raw2film/cpu_processor.py:232-253, domain evidence
  cpu_processor.py:405 scale=0.25)
* :func:`log_clip`, :func:`multi_channel_interp` — host helpers matching the
  reference semantics (src/raw2film/cpu_processor.py:378-380).
"""

from __future__ import annotations

import numpy as np

from raw2film_tpu_torch.config import (
    DEFAULT_DTYPE,
    INPUT_LUT_SIZE,
    LINEAR_SCALING,
    LOG10_EPS,
    PRINT_LUT_SIZE,
)
from raw2film_tpu_torch.film import chain
from raw2film_tpu_torch.film.sensitometry import tabulate_curve
from raw2film_tpu_torch.film.stock import FilmStock


def get_input_lut(
    stock: FilmStock,
    exp_kelvin: float = 6500.0,
    tint: float = 0.0,
    exp_comp: float = 0.0,
    size: int = INPUT_LUT_SIZE,
) -> np.ndarray:
    """(size, size, 3) chromaticity LUT: entry [i, j] is the layer exposure of
    a unit-sum XYZ with x = i/(size-1), y = j/(size-1). Applied with the
    energy-preserving barycentric scheme of reference shaders/lut_2d.wgsl:39-101
    (multiply by S = X+Y+Z after lookup)."""
    p = chain.build_negative_params(stock, exp_kelvin, tint, exp_comp)
    g = np.linspace(0.0, 1.0, size)
    x, y = np.meshgrid(g, g, indexing="ij")
    z = 1.0 - x - y
    xyz = np.stack([x, y, z])  # (3, size, size); z<0 in the invalid corner
    e = np.einsum("ij,jhw->ihw", p.m_in, xyz)
    return np.maximum(e, 0.0).transpose(1, 2, 0).astype(DEFAULT_DTYPE)


def get_density_curve(
    stock: FilmStock, push_pull: float = 0.0, color_masking: float | None = None
) -> np.ndarray:
    """(4, N) H&D table: row 0 = log-exposure grid, rows 1-3 per-channel
    density. Masking's gamma trim is folded in; its cross-channel coupling
    lives in the 3D stage (a 1D per-channel table cannot express coupling —
    same structural split as the reference, which passes ``color_masking`` to
    both get_density_curve and create_lut)."""
    gamma_scale = None
    if color_masking is not None and not stock.is_bw:
        gamma_scale = 1.0 + 0.10 * (float(color_masking) - 1.0)
    return tabulate_curve(stock.curve, push_pull, gamma_scale)


def create_lut(
    negative_film: FilmStock,
    print_film: FilmStock | None = None,
    mode: str = "print",
    input_colorspace=None,
    adx_coding: bool = False,
    cube: bool = False,
    red_light: float = 0.0,
    green_light: float = 0.0,
    blue_light: float = 0.0,
    projector_kelvin: float = 6500.0,
    shadow_comp: float = 0.0,
    sat_adjust: float = 1.0,
    gamma_func: str = "sRGB",
    inversion_gamma: float = 4.0,
    idealized_curve: bool = False,
    inversion: bool = False,
    white_balance: bool = False,
    white_clip: bool = False,
    linear_scaling: float = LINEAR_SCALING,
    color_masking: float | None = None,
    size: int = PRINT_LUT_SIZE,
) -> np.ndarray:
    """(size, size, size, 3) output LUT: grid point (r, g, b) holds the
    encoded display RGB for negative density (r, g, b) * linear_scaling.
    Matches the reference's create_lut call signature
    (src/raw2film/cpu_processor.py:232-253)."""
    neg_p = chain.build_negative_params(
        negative_film, color_masking=color_masking
    )
    prt_p = chain.build_print_params(
        negative_film,
        print_film,
        red_light=red_light,
        green_light=green_light,
        blue_light=blue_light,
        projector_kelvin=projector_kelvin,
        shadow_comp=shadow_comp,
        inversion_gamma=inversion_gamma,
        idealized_curve=idealized_curve,
        inversion=inversion,
        white_balance=white_balance,
        neg_params=neg_p,
    )
    out_p = chain.build_output_params(
        negative_film,
        print_film,
        prt_p,
        neg_p,
        projector_kelvin=projector_kelvin,
        sat_adjust=sat_adjust,
        gamma_func=gamma_func,
        white_clip=white_clip,
    )
    g = np.linspace(0.0, float(linear_scaling), size)
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")
    dens = np.stack([r, gg, b]).reshape(3, size, size * size)
    lin = chain.print_to_linear_xyz(dens, prt_p)
    rgb = chain.encode_output(lin, out_p)
    return rgb.reshape(3, size, size, size).transpose(1, 2, 3, 0).astype(DEFAULT_DTYPE)


def log_clip(image: np.ndarray) -> np.ndarray:
    """In-place linear -> log10 with clipping (reference:
    src/raw2film/cpu_processor.py:378; floor matches shaders/lut_1d.wgsl)."""
    np.log10(np.maximum(image, LOG10_EPS, out=image), out=image)
    return image


def multi_channel_interp(image: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Per-channel 1D interpolation of a (4, N) curve table over a planar
    (3, H, W) or channel-last (H, W, 3) image (reference:
    src/raw2film/cpu_processor.py:380)."""
    x = lut[0]
    planar = image.shape[0] == 3 and image.ndim == 3 and image.shape[-1] != 3
    out = np.empty_like(image)
    for c in range(3):
        src = image[c] if planar else image[..., c]
        res = np.interp(src, x, lut[1 + c])
        if planar:
            out[c] = res
        else:
            out[..., c] = res
    return out
