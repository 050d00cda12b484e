"""Pyramid resampling of the halation glow: the /f box downsample (K10), the
row-only half-pixel bilinear upsample (K12) and the 2-D one (K13).

The counterpart of ``raw2film_tpu/ops/pallas_pyramid.py``:

- :func:`box_downsample_pyramid` replaces ``box_downsample_pallas`` (K10):
  (C, H, W) -> (C, H//f, W//f) block mean for any integer f, the remainder
  cropped; each output sums its f x f block rows first, then columns (the
  order of ``Dh @ x @ Dw``), then scales by float32(1 / f**2);
- :func:`bilinear_upsample_rows` replaces ``bilinear_upsample_rows_pallas``
  (K12): x f half-pixel lerp of the row axis only, edge clamp, cropped to
  ``oh`` rows; the columns are untouched;
- :func:`bilinear_upsample` replaces ``bilinear_upsample_pallas`` (K13):
  x f half-pixel lerp of both axes, edge clamp, cropped to ``out_hw``.

On a CUDA tensor each launches its kernel (``csrc/pyramid.cu``); on a CPU
tensor it runs its plain version.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops.conv import _lerp_matrix_full
from raw2film_tpu_torch.utils import trace


@lru_cache(maxsize=32)
def lerp_taps(n_in: int, f: int, n_out: int):
    """Half-pixel x f lerp with edge clamp as two taps per output:
    (i0, i1) int64 and (w0, w1) float32 numpy arrays of length ``n_out``,
    out[o] = w0[o] * x[i0[o]] + w1[o] * x[i1[o]]. Where the clamp folds both
    taps onto one sample, w0 holds their float32 sum and w1 is 0, as in the
    rows of ``_lerp_matrix_full(n_in, f)`` and in the edge-chunk matrices of
    the TPU halation kernel (cached, read-only)."""
    o = np.arange(n_out, dtype=np.float64)
    rel = (o + 0.5) / f - 0.5
    base = np.floor(rel)
    frac = rel - base
    i0 = np.clip(base, 0, n_in - 1).astype(np.int64)
    i1 = np.clip(base + 1, 0, n_in - 1).astype(np.int64)
    w0 = (1.0 - frac).astype(np.float32)
    w1 = frac.astype(np.float32)
    same = i0 == i1
    w0[same] = w0[same] + w1[same]
    w1[same] = 0.0
    for a in (i0, i1, w0, w1):
        a.setflags(write=False)
    return i0, i1, w0, w1


# ------------------------------------------------------------------ K10


def box_downsample_plain(img: torch.Tensor, f: int) -> torch.Tensor:
    """Plain version of K10: reshape to (C, h2, f, w2, f), sum the row
    axis, then the column axis, then scale."""
    c, h, w = img.shape
    f = int(f)
    h2, w2 = h // f, w // f
    x = img[:, : h2 * f, : w2 * f].reshape(c, h2, f, w2, f)
    return x.sum(dim=2).sum(dim=-1) * float(np.float32(1.0 / (f * f)))


def box_vec_path(f: int, w: int, data_ptr: int) -> bool:
    """Whether K10 takes its 16-byte path (f = 4 or 8, W a multiple of 4,
    the input 16-byte aligned); otherwise its one-thread-per-output kernel."""
    return f in (4, 8) and w % 4 == 0 and data_ptr % 16 == 0


def box_downsample_pyramid(img: torch.Tensor, f: int) -> torch.Tensor:
    """K10 wrapper: (C, H, W) float32 -> (C, H//f, W//f) block mean. The
    kernel's path follows :func:`box_vec_path`."""
    f = int(f)
    if f < 1:
        raise ValueError(f"box downsample: factor {f}")
    if not kb.use_kernel(img):
        return box_downsample_plain(img, f)
    kb.require(img, "img", torch.float32)
    if img.dim() != 3:
        raise ValueError(f"img: want (C, H, W), got {tuple(img.shape)}")
    c, h, w = img.shape
    h2, w2 = h // f, w // f
    if h2 == 0 or w2 == 0:
        raise ValueError(f"box downsample: {h}x{w} is smaller than the factor {f}")
    out = torch.empty((c, h2, w2), dtype=torch.float32, device=img.device)
    ptr = img.data_ptr()
    err = kb.lib().r2f_box_downsample(
        ptr, out.data_ptr(), c, h, w, f, float(np.float32(1.0 / (f * f))),
        int(box_vec_path(f, w, ptr)), kb.stream_ptr(img),
    )
    kb.check(err, "r2f_box_downsample")
    trace.count("launch.pyramid_down")
    return out


# ------------------------------------------------------------------ K12


def bilinear_upsample_rows_plain(img: torch.Tensor, f: int, oh: int | None = None) -> torch.Tensor:
    """Plain version of K12: the row lerp as one float32 matmul with
    ``_lerp_matrix_full(h, f)[:oh]`` (TF32 must be off, see
    ``device.disable_tf32``)."""
    hs = img.shape[-2]
    oh = hs * int(f) if oh is None else int(oh)
    uh = trace.to_device(_lerp_matrix_full(hs, int(f))[:oh], img.device, copy=True)
    return torch.matmul(uh, img)


def rows_vec_path(w: int, *ptrs: int) -> bool:
    """Whether K12 takes its 16-byte path (w a multiple of 4, the input and
    output 16-byte aligned); otherwise scalar loads and stores."""
    return w % 4 == 0 and all(p % 16 == 0 for p in ptrs)


def bilinear_upsample_rows(img: torch.Tensor, f: int, oh: int | None = None) -> torch.Tensor:
    """K12 wrapper: (C, h, w) float32 -> (C, oh, w), oh <= h * f. The
    kernel takes the phase table of f by value (:func:`phases`, f <= 64)
    and its path follows :func:`rows_vec_path`."""
    f = int(f)
    if f < 1:
        raise ValueError(f"row upsample: factor {f}")
    hs = img.shape[-2]
    oh = hs * f if oh is None else int(oh)
    if not 0 < oh <= hs * f:
        raise ValueError(f"row upsample: oh {oh} outside (0, {hs * f}]")
    if not kb.use_kernel(img):
        return bilinear_upsample_rows_plain(img, f, oh)
    kb.require(img, "img", torch.float32)
    if img.dim() != 3:
        raise ValueError(f"img: want (C, h, w), got {tuple(img.shape)}")
    c, _, w = img.shape
    table = phases(f)
    out = torch.empty((c, oh, w), dtype=torch.float32, device=img.device)
    src, dst = img.data_ptr(), out.data_ptr()
    err = kb.lib().r2f_upsample_rows(
        src, dst, c, hs, w, oh, ctypes.byref(table), int(rows_vec_path(w, src, dst)), kb.stream_ptr(img)
    )
    kb.check(err, "r2f_upsample_rows")
    trace.count("launch.pyramid_up_rows")
    return out


# ------------------------------------------------------------------ K13


def bilinear_upsample_plain(img: torch.Tensor, f: int, out_hw: tuple[int, int]) -> torch.Tensor:
    """Plain version of K13: ``_lerp_matrix_full(h, f)[:oh] @ img @
    _lerp_matrix_full(w, f)[:ow].T`` in float32 (TF32 must be off)."""
    oh, ow = out_hw
    rows = bilinear_upsample_rows_plain(img, f, oh)
    uw = trace.to_device(_lerp_matrix_full(img.shape[-1], int(f))[:ow].T, img.device, copy=True)
    return torch.matmul(rows, uw)


UP_MAX_F = 64  # csrc/pyramid.cu UP_MAX_F


class Phases(ctypes.Structure):
    """``r2f::Phases`` (csrc/pyramid.cu): output o = q f + m of a x f lerp
    reads input q + base[m] with weight w0[m] and q + base[m] + 1 with
    w1[m], before the edge clamp."""

    _fields_ = [
        ("f", ctypes.c_int),
        ("base", ctypes.c_int * UP_MAX_F),
        ("w0", ctypes.c_float * UP_MAX_F),
        ("w1", ctypes.c_float * UP_MAX_F),
    ]


@lru_cache(maxsize=16)
def phases(f: int) -> Phases:
    """K12's and K13's phase table for factor f: the weights of :func:`lerp_taps`,
    taken in float64 per phase and rounded to float32 (cached, read-only
    by convention: the kernel gets a copy at each launch)."""
    if not 1 <= f <= UP_MAX_F:
        raise ValueError(f"upsample: factor {f}, the kernel takes 1 to {UP_MAX_F}")
    rel = (np.arange(f, dtype=np.float64) + 0.5) / f - 0.5
    base = np.floor(rel)
    frac = rel - base
    p = Phases(f=f)
    p.base[:f] = base.astype(np.int32).tolist()
    p.w0[:f] = (1.0 - frac).astype(np.float32).tolist()
    p.w1[:f] = frac.astype(np.float32).tolist()
    return p


def bilinear_upsample(img: torch.Tensor, f: int, out_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """K13 wrapper: (C, h, w) float32 -> (C, oh, ow), oh <= h * f and
    ow <= w * f (default: the whole x f image)."""
    f = int(f)
    if f < 1:
        raise ValueError(f"upsample: factor {f}")
    if img.dim() != 3:
        raise ValueError(f"img: want (C, h, w), got {tuple(img.shape)}")
    c, hs, ws = img.shape
    oh, ow = (hs * f, ws * f) if out_hw is None else (int(out_hw[0]), int(out_hw[1]))
    if not (0 < oh <= hs * f and 0 < ow <= ws * f):
        raise ValueError(f"upsample: out {(oh, ow)} outside {(hs * f, ws * f)} at x{f}")
    if not kb.use_kernel(img):
        return bilinear_upsample_plain(img, f, (oh, ow))
    kb.require(img, "img", torch.float32)
    table = phases(f)
    out = torch.empty((c, oh, ow), dtype=torch.float32, device=img.device)
    err = kb.lib().r2f_upsample(
        img.data_ptr(), out.data_ptr(), c, hs, ws, oh, ow, ctypes.byref(table), kb.stream_ptr(img)
    )
    kb.check(err, "r2f_upsample")
    trace.count("launch.pyramid_up")
    return out
