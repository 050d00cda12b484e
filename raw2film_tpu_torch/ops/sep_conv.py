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

The taps reach the kernel by value: :func:`pack` lays a vector out as the
``r2f::conv1d::Taps`` struct of ``csrc/conv1d.cu`` once per distinct vector
and axis, kept by content (``kernels/cache.py``), and a launch passes a
pointer to it, so no launch copies anything to the device. A vector packed
above :data:`MAX_TAPS` floats goes to a device buffer uploaded once, kept
there the same way.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.kernels import cache
from raw2film_tpu_torch.ops.conv import conv1d_axis
from raw2film_tpu_torch.utils import trace

MAX_TAPS = 256  # r2f::conv1d::MAX_TAPS: floats of taps passed by value
K5_ALIGN = 4  # K5's window starts on a 16-byte quad of the row ...
K5_GROUP = 8  # ... and runs its taps in groups of 8

_AXIS = {"conv_w": (0, -1), "conv_h": (1, -2)}


class Taps(ctypes.Structure):
    """``r2f::conv1d::Taps`` (csrc/conv1d.cu): output i reads t[q] times
    input i + off + q for q < n."""

    _fields_ = [("off", ctypes.c_int), ("n", ctypes.c_int), ("t", ctypes.c_float * MAX_TAPS)]


@dataclass(frozen=True)
class Packed:
    """A tap vector as a kernel reads it: ``taps`` the n packed taps,
    ``off`` the window offset of the first, ``args`` the by-value struct
    (its taps filled only when ``by_value``), ``args_ptr`` its address and
    ``key`` the key of its device buffer."""

    taps: np.ndarray
    off: int
    args: Taps
    args_ptr: int
    by_value: bool
    key: tuple


def _taps(taps) -> np.ndarray:
    t = np.asarray(taps, np.float32).ravel()
    if t.size % 2 == 0:
        raise ValueError(f"taps: want an odd count, got {t.size}")
    return t


def packed_taps(t: np.ndarray, axis_code: int) -> tuple[np.ndarray, int]:
    """(taps, off): the span of the nonzero taps of ``t`` and its window
    offset from the output (the first kept tap's index - r); no taps and
    offset 0 when all are zero. For K5 (axis 0) the offset moves down to a
    multiple of :data:`K5_ALIGN` with leading zeros and the count rises to a
    multiple of :data:`K5_GROUP` with trailing ones. Zero taps are skipped
    by the kernels, so the packing leaves the sum and its order unchanged."""
    live = np.flatnonzero(t)
    if live.size == 0:
        return np.zeros(0, np.float32), 0
    lo, hi = int(live[0]), int(live[-1])
    kept, off = t[lo: hi + 1], lo - t.size // 2
    if axis_code == 0:
        lead = off % K5_ALIGN
        n = lead + kept.size
        kept = np.pad(kept, (lead, -n % K5_GROUP))
        off -= lead
    return np.ascontiguousarray(kept, np.float32), off


def pack(t: np.ndarray, axis_code: int) -> Packed:
    """The kernel's form of the tap vector ``t`` along ``axis_code`` (0:
    K5, 1: K6), kept by the taps' contents."""
    key = ("conv1d", axis_code, cache.content_key(t))
    return cache.host(key, lambda: _pack(t, axis_code, key))


def _pack(t: np.ndarray, axis_code: int, key) -> Packed:
    taps, off = packed_taps(t, axis_code)
    taps.setflags(write=False)
    args = Taps(off=off, n=taps.size)
    by_value = taps.size <= MAX_TAPS
    if by_value:
        ctypes.memmove(args.t, taps.ctypes.data, taps.nbytes)
    return Packed(taps, off, args, ctypes.addressof(args), by_value, key)


def vec_path(w: int, *ptrs: int) -> bool:
    """Whether K5 / K6 take their 16-byte path: W a multiple of 4 and every
    buffer 16-byte aligned; otherwise scalar loads and stores."""
    return w % 4 == 0 and all(p % 16 == 0 for p in ptrs)


def _conv1d(img: torch.Tensor, taps, name: str) -> torch.Tensor:
    axis_code, axis = _AXIS[name]
    t = _taps(taps)
    if not kb.use_kernel(img):
        return conv1d_axis(img, t, axis)
    kb.require(img, "img", torch.float32)
    if img.dim() != 3:
        raise ValueError(f"img: want (C, H, W), got {tuple(img.shape)}")
    c, h, w = img.shape
    p = pack(t, axis_code)
    buf = None if p.by_value else cache.on_device(p.key, lambda: p.taps, img.device).data_ptr()
    out = torch.empty_like(img)
    err = kb.lib().r2f_conv1d(
        img.data_ptr(), out.data_ptr(), c, h, w, p.args_ptr, buf, axis_code,
        int(vec_path(w, img.data_ptr(), out.data_ptr())), kb.stream_ptr(img),
    )
    kb.check(err, "r2f_conv1d")
    trace.count("launch." + name)
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
