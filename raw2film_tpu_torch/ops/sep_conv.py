"""1-D row and column correlations and their separable compositions.

The counterpart of ``raw2film_tpu/ops/pallas_conv2.py``'s :func:`conv_w`
(K5), :func:`conv_h` (K6), :func:`sep_conv` and :func:`sep_conv_rank`: one
odd-length tap vector shared by every channel of a (C, H, W) float32 image,
reflect-101 borders, a single tap reading no neighbour. On a CUDA tensor
``conv_w`` and ``conv_h`` launch ``csrc/conv1d.cu``; on a CPU tensor they run
``ops/conv.py::conv1d_axis``, their plain version.

No code path of the JAX package reaches these kernels (only its tests do):
the render's convolutions go through ``fused_sep_rank`` (K2, K4). They are
ported so that every TPU kernel has a counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops.conv import conv1d_axis

_AXIS = {"conv_w": (0, -1), "conv_h": (1, -2)}


def _taps(taps) -> np.ndarray:
    t = np.asarray(taps, np.float32).ravel()
    if t.size % 2 == 0:
        raise ValueError(f"taps: want an odd count, got {t.size}")
    return t


def _conv1d(img: torch.Tensor, taps, name: str) -> torch.Tensor:
    axis_code, axis = _AXIS[name]
    t = _taps(taps)
    if not kb.use_kernel(img):
        return conv1d_axis(img, t, axis)
    kb.require(img, "img", torch.float32)
    if img.dim() != 3:
        raise ValueError(f"img: want (C, H, W), got {tuple(img.shape)}")
    c, h, w = img.shape
    dev_taps = torch.tensor(t, device=img.device)
    out = torch.empty_like(img)
    err = kb.lib().r2f_conv1d(
        img.data_ptr(), out.data_ptr(), c, h, w, dev_taps.data_ptr(), t.size, axis_code,
        kb.stream_ptr(img),
    )
    kb.check(err, "r2f_conv1d")
    kb.launches[name] += 1
    return out


def conv_w(img: torch.Tensor, taps) -> torch.Tensor:
    """K5: the correlation along W (each row)."""
    return _conv1d(img, taps, "conv_w")


def conv_h(img: torch.Tensor, taps) -> torch.Tensor:
    """K6: the correlation along H (each column)."""
    return _conv1d(img, taps, "conv_h")


def sep_conv(img: torch.Tensor, kv, kh) -> torch.Tensor:
    """The column kernel ``kv`` (K6), then the row kernel ``kh`` (K5)."""
    return conv_w(conv_h(img, kv), kh)


def sep_conv_rank(img: torch.Tensor, u, v) -> torch.Tensor:
    """The sum over ranks of ``sep_conv(img, u[r], v[r])``."""
    out = None
    for kv, kh in zip(u, v):
        term = sep_conv(img, kv, kh)
        out = term if out is None else out + term
    return out
