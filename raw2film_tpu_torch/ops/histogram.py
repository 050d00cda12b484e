"""RGB histogram: counts on the device, the strip rasterized on the host.

The counterpart of ``raw2film_tpu/ops/histogram.py``: 256-bin counts of the
same strided pixels (a stride that bounds the samples to ``MAX_SAMPLES``,
counts rescaled by stride squared), then log1p normalize, a 3-tap smooth and
the RGBA strip through the 2 x 2 x 2 additive mix table (plain numpy, a copy
of the JAX module's, whose module imports JAX). The counting is one
``torch.bincount`` over the three channels' offset codes: counting, not a
Pallas kernel on the TPU either (there it is a one-hot reduction).
"""

from __future__ import annotations

import numpy as np
import torch

from raw2film_tpu_torch.device import require_cuda
from raw2film_tpu_torch.utils import trace

MAX_SAMPLES = 1 << 19


def histogram_counts(img_u8: torch.Tensor) -> torch.Tensor:
    """(3, H, W) uint8 -> (3, 256) float32 counts on the image's device;
    images beyond ``MAX_SAMPLES`` pixels are stride-subsampled and the
    counts rescaled, exact below that."""
    h, w = img_u8.shape[-2:]
    stride = int(np.ceil(np.sqrt(max(h * w / MAX_SAMPLES, 1.0))))
    flat = img_u8[:, ::stride, ::stride].reshape(3, -1).to(torch.int64)
    flat = flat + 256 * torch.arange(3, device=flat.device)[:, None]
    counts = torch.bincount(flat.reshape(-1), minlength=3 * 256).reshape(3, 256)
    return counts.to(torch.float32) * float(stride * stride)


def precompute_mix_table(red=None, green=None, blue=None) -> np.ndarray:
    """(2, 2, 2, 4) uint8 additive-blend table (linear-light mixing)."""
    if red is None:
        red = np.array([235.0, 90.0, 80.0])
        green = np.array([80.0, 200.0, 90.0])
        blue = np.array([95.0, 110.0, 235.0])
    lin = [np.asarray(c, np.float32) / 255.0 for c in (red, green, blue)]
    lin = [c**2.2 for c in lin]
    table = np.zeros((2, 2, 2, 4), np.uint8)
    for r in (0, 1):
        for g in (0, 1):
            for b in (0, 1):
                if not (r or g or b):
                    continue
                mix = np.clip(r * lin[0] + g * lin[1] + b * lin[2], 0, 1)
                table[r, g, b, :3] = np.round(mix ** (1 / 2.2) * 255)
                table[r, g, b, 3] = 255
    peak = (table[1, 1, 1, :3] / 255.0) ** 2.2
    table[1, 1, 1, :3] = int(round(peak.mean() ** (1 / 2.2) * 255))
    return table


MIX_TABLE = precompute_mix_table()


def render_histogram(counts: np.ndarray, height: int = 100, mix_table: np.ndarray = MIX_TABLE) -> np.ndarray:
    """(3, 256) counts -> (height, 256, 4) uint8 strip (host; tiny)."""
    c = np.asarray(counts, np.float32)
    mx = max(float(c.max()), 1.0)
    f = np.log1p(c / mx)
    sm = np.empty_like(f)
    sm[:, 1:-1] = (f[:, :-2] + f[:, 1:-1] + f[:, 2:]) / 3
    sm[:, 0] = (2 * f[:, 0] + f[:, 1]) / 3
    sm[:, -1] = (2 * f[:, -1] + f[:, -2]) / 3
    mx2 = max(float(sm.max()), 1e-9)
    bars = (sm * height / mx2).astype(np.int32)
    rows = np.arange(height)[:, None]
    act = (rows >= (height - bars[:, None, :])).astype(np.int32)
    return mix_table[act[0], act[1], act[2]]


def generate_histogram(img_u8, height: int = 100, device=None) -> np.ndarray:
    """(3, H, W) uint8 image (numpy or tensor) -> the RGBA strip: counts on
    ``device`` (by default a tensor's own device, a numpy image's the first
    CUDA device), the strip on the host."""
    if device is None:
        device = img_u8.device if isinstance(img_u8, torch.Tensor) else require_cuda()
    img = trace.to_device(np.ascontiguousarray(img_u8) if isinstance(img_u8, np.ndarray) else img_u8,
                          device)
    return render_histogram(trace.to_host(histogram_counts(img)).numpy(), height)

