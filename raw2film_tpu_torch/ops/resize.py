"""Resampling as ``jax.image.resize`` does it: resolution scaling and the
halation glow's bilinear resize.

The counterpart of ``raw2film_tpu/ops/resize.py`` and of the
``jax.image.resize`` calls the JAX package leaves to XLA on the TPU. The
weights are built on the host as ``jax.image.scale_and_translate`` builds
them (jax/_src/image/scale.py, ``compute_weight_mat``): sample positions
``(o + 0.5) / scale - 0.5``, the kernel widened by ``1 / scale`` when
shrinking with antialiasing, each output's weights renormalized to sum 1
(which is the edge clamp of a bilinear upsample), and outputs whose sample
lies outside the input zeroed. They are applied as float32 matmuls, one per
resized axis (TF32 must be off, see ``device.disable_tf32``), each matrix
uploaded once per device and kept there (``kernels/cache.py``). No hand
kernel: on the TPU these are XLA too.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from raw2film_tpu_torch.kernels import cache
from raw2film_tpu_torch.ops import pyramid

F32 = np.float32
_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(F32(0.0), F32(1.0) - np.abs(x))


def _lanczos5(x: np.ndarray) -> np.ndarray:
    radius = F32(5.0)
    pi = F32(np.pi)
    y = radius * np.sin(pi * x) * np.sin(pi * x / radius)
    safe = np.where(x != 0, F32(np.pi**2) * (x * x), F32(1.0))
    out = np.where(x > F32(1e-3), y / safe, F32(1.0))
    return np.where(x > radius, F32(0.0), out).astype(F32)


KERNELS = {"linear": _triangle, "lanczos5": _lanczos5}


@lru_cache(maxsize=32)
def weight_matrix(n_in: int, n_out: int, method: str, antialias: bool = True) -> np.ndarray:
    """(n_in, n_out) float32 resampling weights of one axis (cached,
    read-only)."""
    kernel = KERNELS[method]
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = F32(max(inv_scale, 1.0)) if antialias else F32(1.0)
    sample = (np.arange(n_out, dtype=F32) + F32(0.5)) * F32(inv_scale) - F32(0.0) - F32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=F32)[:, None]) / kernel_scale
    w = kernel(x).astype(F32)
    total = w.sum(axis=0, keepdims=True, dtype=F32)
    w = np.where(
        np.abs(total) > F32(1000.0 * _EPS32), w / np.where(total != 0, total, F32(1.0)), F32(0.0)
    )
    inside = (sample >= F32(-0.5)) & (sample <= F32(n_in - 0.5))
    w = np.where(inside[None, :], w, F32(0.0)).astype(F32)
    w.setflags(write=False)
    return w


def resize(img: torch.Tensor, out_hw: tuple[int, int], method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """(C, H, W) float32 -> (C, oh, ow), as ``jax.image.resize(img, (C, oh,
    ow), method, antialias)``; an axis whose size is unchanged is left as it
    is."""
    h, w = img.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])

    def weights(n_in: int, n_out: int) -> torch.Tensor:
        key = ("resize", n_in, n_out, method, antialias)
        return cache.on_device(key, lambda: weight_matrix(n_in, n_out, method, antialias), img.device)

    out = img
    if oh != h:
        out = torch.matmul(weights(h, oh).T, out)  # a transposed view: the GEMM a host transpose gets
    if ow != w:
        out = torch.matmul(out, weights(w, ow))
    return out


def resolution_scaling(img: torch.Tensor, resolution: tuple[int, int]) -> torch.Tensor:
    """(C, H, W) -> scaled to fit ``resolution`` (H, W), aspect kept: the
    box mean (K10) for an integer shrink, the antialiased linear resize for
    a fractional one, Lanczos-5 to enlarge."""
    c, h, w = img.shape
    factor = min(resolution[0] / h, resolution[1] / w)
    if abs(factor - 1.0) < 1e-9:
        return img
    out_hw = (round(h * factor), round(w * factor))
    if factor < 1.0:
        inv = 1.0 / factor
        if abs(inv - round(inv)) < 1e-9 and h % round(inv) == 0 and w % round(inv) == 0:
            return pyramid.box_downsample_pyramid(img.contiguous(), round(inv))
        return resize(img, out_hw, "linear", antialias=True)
    return resize(img, out_hw, "lanczos5")
