"""Halation: the red-dominant glow around highlights.

The counterpart of ``raw2film_tpu/ops/halation.py`` in its TPU form:
``out = (img + f_c * blur(img)) / (1 + f_c)``, with ``blur`` the exponential
halation kernel of size ``scale / 4 * halation_size`` px. By size:

- ``size <= 12``: the dense kernel, as its SVD ranks through kernel K2
  (a 1 x 1 kernel as a plain product);
- ``12 < size <= 40``: the kernel's SVD ranks (tol 1e-4, rank <= 8) on K2;
- above 40, the mixture tier. Where H and W are multiples of 4 and the
  pyramid has the /4 level alone (every size up to about 163 px), it runs
  whole in :func:`halation_combined_fused`: K10 (/4 box downsample) -> K2
  (the pyramid Gaussians on the small image) -> K12 (x4 row upsample) ->
  K14 (:func:`halation_mega`: the full-res ranks, the x4 column lerp, the
  combine and, for identity masking, the development to density).
  Elsewhere :func:`halation_combined_fused` returns None, as the JAX one
  does, and :func:`halation_blur` builds the glow: the full-res ranks on
  K2, then per pyramid factor f K10 and K2 on the /f level and the
  upsample to (H, W), which is K13 (``bilinear_upsample_pallas``) where H
  and W are multiples of f and otherwise the bilinear resize XLA runs on
  the TPU (``ops/resize.py``).

The host-side kernel construction is a numpy copy of the JAX package's
(that module imports JAX), pinned bit-exact to it by the tests.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from raw2film_tpu_torch.config import LOG10_EPS
from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.kernels import cache
from raw2film_tpu_torch.ops import conv as convops
from raw2film_tpu_torch.ops import fastmath as fm
from raw2film_tpu_torch.ops import pyramid, resize, sep_rank
from raw2film_tpu_torch.utils import trace

PYR_F = 4  # the pyramid factor K14 serves
DEVELOP_LEN = 19  # [flare, dmin*3, gamma*3, x_toe*3, x_shoulder*3, w_toe*3, w_shoulder*3]

# ------------------------------------------------------------ host side


def exponential_blur_kernel(size: float) -> np.ndarray:
    """The exact halation kernel: (1/d^2) * max((r - d)/r, 0), centre weight
    1, normalized."""
    radius = size / 2.0
    n = 2 * int(np.floor(np.ceil(size) / 2)) + 1
    center = np.ceil(n / 2.0)
    ii = np.arange(1, n + 1, dtype=np.float64)
    di = (ii - center) ** 2
    dist = di[:, None] + di[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.where(
            dist == 0.0,
            1.0,
            (1.0 / dist) * np.maximum((radius - np.sqrt(dist)) / radius, 0.0),
        )
    return k / k.sum()


INNER_RADIUS = 5  # dense correction window half-size (11x11)


@lru_cache(maxsize=32)
def fit_gaussian_mixture(size: float, n_terms: int = 5):
    """The exact kernel as an 11 x 11 dense correction plus a least-squares
    sum of isotropic Gaussians fitted to its tail. Returns (sigmas, weights,
    inner (11, 11) float32, residual L1 outside the core)."""
    k = exponential_blur_kernel(size)
    n = k.shape[0]
    c = n // 2
    yy, xx = np.mgrid[0:n, 0:n]
    r2 = (yy - c) ** 2.0 + (xx - c) ** 2.0
    radius = max(size / 2.0, 1.0)
    sigmas = np.geomspace(max(1.2, radius / 30.0), radius / 1.7, n_terms)
    basis = np.stack(
        [np.exp(-0.5 * r2 / s**2) / (2 * np.pi * s**2) for s in sigmas], axis=-1
    )
    a = basis.reshape(-1, n_terms)
    outer = (r2 > INNER_RADIUS**2).ravel()
    w, *_ = np.linalg.lstsq(a[outer], k.ravel()[outer], rcond=None)
    w = np.maximum(w, 0.0)
    recon = (a @ w).reshape(n, n)
    resid_outer = float(np.abs(recon - k)[r2 > INNER_RADIUS**2].sum())
    inner = np.zeros((2 * INNER_RADIUS + 1,) * 2, np.float64)
    lo_src = max(c - INNER_RADIUS, 0)
    hi_src = min(c + INNER_RADIUS + 1, n)
    lo_dst = lo_src - (c - INNER_RADIUS)
    patch = (k - recon)[lo_src:hi_src, lo_src:hi_src]
    inner[lo_dst : lo_dst + patch.shape[0], lo_dst : lo_dst + patch.shape[1]] = patch
    return (
        tuple(float(s) for s in sigmas),
        tuple(float(x) for x in w),
        inner.astype(np.float32),
        resid_outer,
    )


PYRAMID_SIGMA = 8.0  # sigmas above this run on a decimated level


@lru_cache(maxsize=32)
def _full_res_ranks(size: float):
    """The full-res part of the mixture tier (the inner correction and the
    sub-pyramid Gaussians combined into one 2-D kernel, SVD-factored) and
    the pyramid (sigma, weight) terms grouped by decimation factor.
    Returns (us, vs, by_factor), us/vs tuples of 1-D tap tuples."""
    sigmas, weights, inner, _ = fit_gaussian_mixture(size)
    full, by_factor = [], {}
    for s, w in zip(sigmas, weights):
        if w <= 1e-6:
            continue
        if s <= PYRAMID_SIGMA:
            full.append((s, w))
        else:
            by_factor.setdefault(4 if s <= 48.0 else 8, []).append((s, w))
    rad = INNER_RADIUS
    for s, _ in full:
        rad = max(rad, int(3.0 * s + 0.5))
    n = 2 * rad + 1
    comb = np.zeros((n, n), np.float64)
    ir = inner.shape[0] // 2
    comb[rad - ir : rad + ir + 1, rad - ir : rad + ir + 1] += inner
    for s, w in full:
        g = convops.gaussian_kernel1d(s, truncate=3.0).astype(np.float64)
        r1 = len(g) // 2
        comb[rad - r1 : rad + r1 + 1, rad - r1 : rad + r1 + 1] += w * np.outer(g, g)
    u, v = convops.svd_separable(comb, tol=3e-3, max_rank=5)
    us = tuple(tuple(float(t) for t in r_) for r_ in u)
    vs = tuple(tuple(float(t) for t in r_) for r_ in v)
    return us, vs, by_factor


def pyramid_taps(f: int, terms):
    """Column and row rank lists of the pyramid Gaussians on the /f level
    (ragged: one rank per term, each its own length)."""
    su = [w * convops.gaussian_kernel1d(s / f, truncate=3.0) for s, w in terms]
    sv = [convops.gaussian_kernel1d(s / f, truncate=3.0) for s, _ in terms]
    return su, sv


# ------------------------------------------------------------ K14


def _lerp_cols(rows_up: torch.Tensor, w: int) -> torch.Tensor:
    """x4 half-pixel lerp of the column axis with edge clamp, to width w."""
    i0, i1, w0, w1 = (
        trace.to_device(a, rows_up.device, copy=True)
        for a in pyramid.lerp_taps(rows_up.shape[-1], PYR_F, w)
    )
    return rows_up.index_select(-1, i0) * w0 + rows_up.index_select(-1, i1) * w1


def colour_factors(bundle: dict, bw: bool) -> torch.Tensor:
    """(3,) per-channel glow factors from the bundle: intensity * [1,
    green, 0], or intensity * green on every channel for black and white."""
    g = bundle["hal_green"]
    rgb = torch.stack([g, g, g] if bw else [torch.ones_like(g), g, torch.zeros_like(g)])
    return bundle["hal_intensity"] * rgb


def develop_vector(bundle: dict) -> torch.Tensor:
    """The negative's H&D curve as K14's 19-float develop vector."""
    return torch.cat([bundle["flare"].reshape(1)] + [c.reshape(3) for c in bundle["neg_curve"]])


def develop_density(x: torch.Tensor, develop: torch.Tensor) -> torch.Tensor:
    """Per-channel H&D development of (C, H, W) exposure from the 19-float
    vector, as K14's epilogue does (identity masking)."""
    dv = develop.reshape(DEVELOP_LEN)
    out = []
    for c in range(x.shape[0]):
        flare, dmin, gam, x_t, x_s, w_t, w_s = dv[0], *(dv[1 + 3 * i + c] for i in range(6))
        lx = fm.log10(torch.clamp(x[c] + flare, min=LOG10_EPS))
        out.append(dmin + gam * (fm.softplus(lx - x_t, w_t) - fm.softplus(lx - x_s, w_s)))
    return torch.stack(out)


def halation_mega_plain(img, u, v, rows_up, factors, develop=None) -> torch.Tensor:
    """Plain version of K14: the full-res ranks, plus the x4 column lerp of
    ``rows_up``, combined as (img + f_c * blur) * (1 / (1 + f_c)), then
    optionally developed to density."""
    blur = sep_rank.fused_sep_rank_plain(img, u, v) + _lerp_cols(rows_up, img.shape[-1])
    f = factors.reshape(-1, 1, 1)
    out = (img + f * blur) * (1.0 / (1.0 + f))
    return out if develop is None else develop_density(out, develop)


K_MIN, K_MAX = 25, 49  # r2f::hal::K_MIN, K_MAX: the kernels' tap lengths (odd)
MAX_TAPS = 512  # r2f::hal::MAX_TAPS: floats of taps passed by value


class Stack(ctypes.Structure):
    """``r2f::hal::Stack`` (csrc/halation.cu): the image shape, W4 =
    ceil(W / 4), and R shared ranks of K column taps then K row taps."""

    _fields_ = [
        ("C", ctypes.c_int),
        ("H", ctypes.c_int),
        ("W", ctypes.c_int),
        ("W4", ctypes.c_int),
        ("R", ctypes.c_int),
        ("K", ctypes.c_int),
        ("taps", ctypes.c_float * MAX_TAPS),
    ]


@dataclass(frozen=True)
class Packed:
    """A K14 stack as the kernel reads it: ``taps`` (R, 2K) float32, each
    rank's column taps then its row taps, both zero-padded symmetrically to
    K; ``args`` the by-value struct and ``args_ptr`` its address."""

    taps: np.ndarray
    args: Stack
    args_ptr: int


def pack(u, v, c: int, h: int, w: int) -> Packed:
    """K14's launch struct for shared ranks (u, v) on a (c, h, w) image,
    kept by the taps' contents and the shape. Both tap lengths are padded
    to the kernels' K: the longer of the two, at least :data:`K_MIN`; a
    zero tap adds an exact 0, so the result is unchanged."""
    key = ("halation", cache.content_key(u), cache.content_key(v), c, h, w)
    return cache.host(key, lambda: _pack(u, v, c, h, w))


def _pack(u, v, c: int, h: int, w: int) -> Packed:
    u2, v2 = sep_rank.stack_taps(u, v)
    if u2.shape[0] != 1:
        raise ValueError("halation ranks: want shared (R, k) taps")
    k = max(u2.shape[2], v2.shape[2], K_MIN)
    if k > K_MAX:
        raise ValueError(f"halation ranks of {k} taps, the kernel takes at most {K_MAX}")
    r = u2.shape[1]
    u2, v2 = (np.pad(t[0], ((0, 0), ((k - t.shape[2]) // 2,) * 2)) for t in (u2, v2))
    taps = np.ascontiguousarray(np.concatenate([u2, v2], axis=1), np.float32)
    if taps.size > MAX_TAPS:
        raise ValueError(f"halation ranks: {r} x 2 x {k} taps, the kernel takes {MAX_TAPS}")
    taps.setflags(write=False)
    args = Stack(C=c, H=h, W=w, W4=-(-w // PYR_F), R=r, K=k)
    ctypes.memmove(args.taps, taps.ctypes.data, taps.nbytes)
    return Packed(taps, args, ctypes.addressof(args))


def halation_mega(img, u, v, rows_up, factors, develop=None) -> torch.Tensor:
    """K14 wrapper. img (C, H, W) float32 exposure; u, v shared rank lists
    (numpy (R, k) or lists of 1-D taps, packed by :func:`pack`); rows_up
    (C, H, ceil(W/4)) the row-upsampled pyramid blur; factors float32 (C,)
    and develop float32 (19,) tensors on img's device. Returns the combined
    exposure, or with ``develop`` the density. A launch copies nothing to
    the device. Recorded as the device span ``kernel.halation``."""
    with trace.stage_timer("kernel.halation", device=img):
        c, h, w = img.shape
        w4 = rows_up.shape[-1]
        if tuple(rows_up.shape) != (c, h, w4) or (w4 - 1) * PYR_F >= w or w4 * PYR_F < w:
            raise ValueError(f"rows_up {tuple(rows_up.shape)} does not fit img {(c, h, w)} at x{PYR_F}")
        if not kb.use_kernel(img):
            return halation_mega_plain(img, u, v, rows_up, factors, develop)
        kb.require(img, "img", torch.float32)
        kb.require(rows_up, "rows_up", torch.float32)
        kb.require(factors, "factors", torch.float32, (c,))
        if develop is not None:
            kb.require(develop, "develop", torch.float32, (DEVELOP_LEN,))
        p = pack(u, v, c, h, w)
        out = torch.empty_like(img)
        err = kb.lib().r2f_halation(
            img.data_ptr(), rows_up.data_ptr(), out.data_ptr(), p.args_ptr, factors.data_ptr(),
            develop.data_ptr() if develop is not None else None, kb.stream_ptr(img),
        )
        kb.check(err, "r2f_halation")
        trace.count("launch.halation")
        return out


# ------------------------------------------------------------ the stage


def halation_combined_fused(img, scale: float, halation_size: float, factors, develop=None):
    """The mixture tier whole: K10 -> K2 -> K12 -> K14. Returns None where
    the JAX one does (size <= 40, H or W not a multiple of 4, a pyramid
    level other than /4): the caller then runs :func:`halation_blur` and
    the combine."""
    size = scale / 4.0 * halation_size
    if size <= 40.0:
        return None
    h, w = img.shape[-2:]
    if h % PYR_F or w % PYR_F:
        return None
    us, vs, by_factor = _full_res_ranks(size)
    if list(by_factor) != [PYR_F]:
        return None
    small = pyramid.box_downsample_pyramid(img, PYR_F)
    small_blur = sep_rank.fused_sep_rank(small, *pyramid_taps(PYR_F, by_factor[PYR_F]))
    rows_up = pyramid.bilinear_upsample_rows(small_blur, PYR_F, oh=h)
    return halation_mega(img, us, vs, rows_up, factors, develop)


def pyramid_upsample(small: torch.Tensor, f: int, out_hw: tuple[int, int]) -> torch.Tensor:
    """The /f level's blur back to (H, W): K13 where H and W are multiples
    of f (the shapes ``bilinear_upsample_pallas`` serves), else the
    half-pixel bilinear resize, scale H / (H // f), of ``jax.image.resize``
    (its fallback on the TPU)."""
    hs, ws = small.shape[-2:]
    if out_hw[0] <= hs * f and out_hw[1] <= ws * f:
        return pyramid.bilinear_upsample(small, f, out_hw)
    return resize.resize(small, out_hw, "linear")


def halation_blur(img, scale: float, halation_size: float) -> torch.Tensor:
    """The glow term alone: the dense or SVD tiers, or the mixture tier's
    full-res ranks plus its upsampled pyramid levels."""
    size = scale / 4.0 * halation_size
    if size <= 12.0:
        k = exponential_blur_kernel(size).astype(np.float32)
        if min(k.shape) >= 3:
            return sep_rank.fused_sep_rank(img, *convops.svd_separable(k, tol=1e-4, max_rank=6))
        return img * float(k[0, 0])  # size <= 1: the kernel is 1 x 1
    if size <= 40.0:
        u, v = convops.svd_separable(
            exponential_blur_kernel(size).astype(np.float32), tol=1e-4, max_rank=8
        )
        return sep_rank.fused_sep_rank(img, u, v)
    us, vs, by_factor = _full_res_ranks(size)
    blur = sep_rank.fused_sep_rank(img, us, vs)
    for f, terms in by_factor.items():
        small = pyramid.box_downsample_pyramid(img, f)
        small_blur = sep_rank.fused_sep_rank(small, *pyramid_taps(f, terms))
        blur = blur + pyramid_upsample(small_blur, f, tuple(img.shape[-2:]))
    return blur


def halation_with_factors(img, scale: float, halation_size: float, factors) -> torch.Tensor:
    """Halation with per-channel colour factors held as a tensor of 3, so
    slider values never rebuild anything; only (scale, halation_size) shape
    the kernels."""
    factors = trace.to_device(factors, img.device, torch.float32).reshape(-1)
    combined = halation_combined_fused(img, scale, halation_size, factors)
    if combined is not None:
        return combined
    blur = halation_blur(img, scale, halation_size)
    f = factors.reshape(-1, 1, 1)
    return (img + f * blur) / (1.0 + f)
