"""Convolution and resampling helpers for planar (C, H, W) float32 images.

The counterpart of ``raw2film_tpu/ops/conv.py``: the host-side kernel
builders are numpy copies of the JAX package's (that module imports JAX, so
the port cannot import them), and the device functions are plain PyTorch,
as they are XLA on the TPU. The one exception is :func:`separable_conv` with
two 1-D kernels, which on the TPU is the Pallas kernel K2 (conv.py:150-153 of
the JAX package) and on a CUDA tensor here the port's K2 kernel
(``ops/sep_rank.py``) with one shared rank.

Border convention: reflect-101 (numpy's and ``jnp.pad``'s "reflect").
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from raw2film_tpu_torch.kernels import cache
from raw2film_tpu_torch.utils import trace

# ------------------------------------------------------------ host builders


def svd_separable(kernel: np.ndarray, tol: float = 1e-4, max_rank: int = 6):
    """Factor a 2-D kernel into separable rank-1 terms by SVD.

    Returns (U, V): U (r, kh) column kernels, V (r, kw) row kernels with
    kernel ~= sum_r outer(U[r], V[r]); the rank keeps singular values above
    ``tol`` of the leading one, at most ``max_rank``."""
    u, s, vt = np.linalg.svd(np.asarray(kernel, np.float64))
    keep = max(1, int(np.sum(s > tol * s[0])))
    keep = min(keep, max_rank)
    scale = np.sqrt(s[:keep])
    return (
        (u[:, :keep] * scale).T.astype(np.float32),
        (vt[:keep] * scale[:, None]).astype(np.float32),
    )


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy-compatible 1-D Gaussian (radius = int(truncate*sigma+0.5))."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=32)
def _mean_matrix(n2: int, f: int) -> np.ndarray:
    """(n2, n2*f) block-mean bands (cached, read-only)."""
    m = np.zeros((n2, n2 * f), np.float32)
    for i in range(n2):
        m[i, i * f : (i + 1) * f] = 1.0 / f
    m.setflags(write=False)
    return m


@lru_cache(maxsize=32)
def _lerp_matrix_full(n_in: int, f: int) -> np.ndarray:
    """(n_in*f, n_in) half-pixel bilinear weights with edge clamp (cached,
    read-only)."""
    m = np.zeros((n_in * f, n_in), np.float32)
    for o in range(n_in * f):
        rel = (o + 0.5) / f - 0.5
        base = int(np.floor(rel))
        frac = rel - base
        i0 = min(max(base, 0), n_in - 1)
        i1 = min(max(base + 1, 0), n_in - 1)
        m[o, i0] += 1.0 - frac
        m[o, i1] += frac
    m.setflags(write=False)
    return m


# ------------------------------------------------------------ borders


def reflect_index(n: int, lo: int, hi: int, device=None) -> torch.Tensor:
    """Source indices of positions lo..hi-1 of a length-n axis extended by
    reflect-101, repeating the reflection for pads longer than the axis
    (numpy's behaviour)."""
    i = torch.arange(lo, hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def pad_reflect(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-101 pad of the last two axes by (ph, pw) on each side."""
    h, w = img.shape[-2:]
    if ph:
        img = img.index_select(-2, reflect_index(h, -ph, h + ph, img.device))
    if pw:
        img = img.index_select(-1, reflect_index(w, -pw, w + pw, img.device))
    return img


def pad_edge(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Edge-replicate (or crop) the last two axes to ``out_hw``."""
    h, w = img.shape[-2:]
    oh, ow = out_hw
    if oh != h:
        img = img.index_select(
            -2, torch.arange(oh, device=img.device).clamp(max=h - 1)
        )
    if ow != w:
        img = img.index_select(
            -1, torch.arange(ow, device=img.device).clamp(max=w - 1)
        )
    return img


# ------------------------------------------------------------ plain convs


def conv1d_axis(img: torch.Tensor, k, axis: int) -> torch.Tensor:
    """Shift-and-add 1-D correlation along H (axis=-2) or W (axis=-1).

    ``k``: (taps,) shared, or (C, taps) per channel, as numpy. Terms are
    summed in tap order, as in the JAX form."""
    k = np.asarray(k, np.float32)
    per_channel = k.ndim == 2
    taps = k.shape[-1]
    r = taps // 2
    h, w = img.shape[-2:]
    p = pad_reflect(img, r, 0) if axis == -2 else pad_reflect(img, 0, r)
    out = None
    for i in range(taps):
        if per_channel:
            coef = trace.to_device(k[:, i], img.device, copy=True).reshape(-1, 1, 1)
        else:
            if k[i] == 0.0:
                continue
            coef = float(k[i])
        src = p[..., i : i + h, :] if axis == -2 else p[..., :, i : i + w]
        term = coef * src
        out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(img)


def separable_conv(img: torch.Tensor, kv, kh) -> torch.Tensor:
    """1-D kernel ``kv`` down the columns, then ``kh`` along the rows:
    (taps,) shared or (C, taps) per channel. Two shared kernels are one rank
    of ``sep_rank.fused_sep_rank`` (the K2 kernel on a CUDA tensor)."""
    kv, kh = np.asarray(kv, np.float32), np.asarray(kh, np.float32)
    if kv.ndim == 1 and kh.ndim == 1:
        from raw2film_tpu_torch.ops import sep_rank  # imports this module

        return sep_rank.fused_sep_rank(img.contiguous(), kv[None], kh[None])
    return conv1d_axis(conv1d_axis(img, kv, -2), kh, -1)


def gaussian_blur(img: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur with a host-built kernel."""
    k = gaussian_kernel1d(sigma, truncate)
    return separable_conv(img, k, k)


# ------------------------------------------------------------ resampling


def box_downsample(img: torch.Tensor, f: int) -> torch.Tensor:
    """(C, H, W) -> (C, H//f, W//f) block mean as Dh @ x @ Dw, two float32
    matmuls (the counterpart of ``box_downsample_mxu``; TF32 must be off,
    see ``device.disable_tf32``), the matrices kept on the device
    (``kernels/cache.py``)."""
    c, h, w = img.shape
    f = int(f)
    h2, w2 = h // f, w // f
    x = img[:, : h2 * f, : w2 * f]
    dh = cache.on_device(("mean", h2, f), lambda: _mean_matrix(h2, f), img.device)
    dw = cache.on_device(("mean_t", w2, f), lambda: _mean_matrix(w2, f).T, img.device)
    return torch.matmul(torch.matmul(dh, x), dw)


def bilinear_upsample(img: torch.Tensor, f: int) -> torch.Tensor:
    """(C, h, w) -> (C, h*f, w*f) half-pixel bilinear with edge clamp, as
    Uh @ x @ Uw (the weights of ``jax.image.resize(..., "linear")``), the
    matrices kept on the device (``kernels/cache.py``)."""
    c, h, w = img.shape
    f = int(f)
    uh = cache.on_device(("lerp", h, f), lambda: _lerp_matrix_full(h, f), img.device)
    uw = cache.on_device(("lerp_t", w, f), lambda: _lerp_matrix_full(w, f).T, img.device)
    return torch.matmul(torch.matmul(uh, img), uw)


def zoom_upsample(img: torch.Tensor, factor: int, out_hw: tuple[int, int]) -> torch.Tensor:
    """Integer-factor bilinear upsample, then edge pad or crop to
    ``out_hw`` (counterpart of ``raw2film_tpu/ops/conv.py::zoom_upsample``)."""
    return pad_edge(bilinear_upsample(img, int(factor)), out_hw)
