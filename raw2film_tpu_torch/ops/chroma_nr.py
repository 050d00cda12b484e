"""Chroma noise reduction: blur the chromaticity, keep the luminance.

The counterpart of ``raw2film_tpu/ops/chroma_nr.py``: XYZ -> xyY, a
separable Gaussian on x and y only (size 2 nr + 1, sigma 0.3 ((size - 1) / 2
- 1) + 0.8, OpenCV's automatic sigma), back to XYZ. The blur goes through
:func:`raw2film_tpu_torch.ops.conv.separable_conv`, which on a CUDA tensor is
the K2 kernel with one shared rank, as on the TPU (conv.py:150-153 of the
JAX package); on frames at most 512 px wide that launch is counted as K4.
"""

from __future__ import annotations

import numpy as np
import torch

from raw2film_tpu_torch.ops import conv as convops

EPS = 1e-8


def xyz_to_xyy(img: torch.Tensor) -> torch.Tensor:
    x, y, z = img[0], img[1], img[2]
    s = x + y + z
    inv = torch.where(s > EPS, 1.0 / torch.clamp(s, min=EPS), 0.0)
    return torch.stack([x * inv, y * inv, y])


def xyy_to_xyz(img: torch.Tensor) -> torch.Tensor:
    cx, cy, yy = img[0], img[1], img[2]
    safe = cy > EPS
    inv = torch.where(safe, yy / torch.clamp(cy, min=EPS), 0.0)
    x = cx * inv
    z = (1.0 - cx - cy) * inv
    return torch.stack([torch.where(safe, x, 0.0), torch.where(safe, yy, 0.0), torch.where(safe, z, 0.0)])


def cv_gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    """OpenCV's ``getGaussianKernel(size, sigma)`` in float32."""
    k = size // 2
    x = np.arange(size, dtype=np.float64) - k
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def chroma_nr(img: torch.Tensor, size: int) -> torch.Tensor:
    """Chroma NR of strength ``size`` (0: none) on camera XYZ (3, H, W)."""
    if size <= 0:
        return img
    ksize = int(size) * 2 + 1
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    k = cv_gaussian_kernel1d(ksize, sigma)
    xyy = xyz_to_xyy(img)
    chroma = convops.separable_conv(xyy[:2].contiguous(), k, k)
    return xyy_to_xyz(torch.cat([chroma, xyy[2:]], dim=0))
