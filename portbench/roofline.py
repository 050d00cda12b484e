"""The H100's peaks and a kernel's least time.

NVIDIA's data sheet for the H100 SXM at 700 W: 3.35 TB/s of HBM and 67
TFLOP/s of float32 outside the tensor cores. A kernel's least time is the
larger of its bytes (each input read once, each output written once) over
the first and its float32 operations (a multiply-add counts 2) over the
second; its roofline share is that over its measured time.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def least_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def true_taps(t: np.ndarray) -> np.ndarray:
    """(R,) the span of each rank's nonzero taps, over every channel of a
    (R, k) or (C, R, k) stack (0 for an all-zero rank)."""
    t = np.asarray(t)
    t = t[None] if t.ndim == 2 else t
    k = t.shape[-1]
    dist = np.abs(np.arange(k) - k // 2)
    live = np.any(t != 0, axis=0)
    return np.array([2 * int(dist[row].max()) + 1 if row.any() else 0 for row in live])


def rank_flops(u, v, h: int, w: int, c: int = 3) -> float:
    """Float32 operations of a sum of separable ranks over c planes of h x w:
    each rank's true column taps and true row taps, a multiply-add each."""
    tu, tv = true_taps(u), true_taps(v)
    live = (tu > 0) & (tv > 0)
    return 2.0 * float(((tu + tv) * live).sum()) * h * w * c


def share_pct(least: float, measured_s: float) -> float | None:
    return 100.0 * least / measured_s if measured_s > 0 else None
