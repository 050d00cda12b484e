"""exp2/log2 forms of the chain's transcendental ops.

The counterpart of ``raw2film_tpu/ops/fastmath.py``: the same expression
forms and the same float32 constants, so the port's elementwise stages track
the JAX package to a few ulps. The CUDA kernels use the same forms
(``csrc/common.cuh``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# Exact doubles rounded once to float32, held as Python floats so that every
# op multiplies by the same float32 value.
LOG2_10 = float(np.float32(np.log2(10.0)))
LOG10_2 = float(np.float32(np.log10(2.0)))
LOG2_E = float(np.float32(np.log2(np.e)))
LN_2 = float(np.float32(np.log(2.0)))


_log2_lock = threading.Lock()
_log2_ready = False


def _log2(x: torch.Tensor) -> torch.Tensor:
    """``torch.log2``. On the CPU it is MKL VML's vmsLog2, which sets up its
    code path at its first call in a process; a first call on a tensor above
    ATen's 2048-element grain runs on several OpenMP threads at once, and
    then whole per-thread chunks have come back with errors of up to 2.4e-5
    (absolute, in log2), about 800 ulp of a log10 near 0 (see
    tests/test_torch_fastmath.py). So the first CPU call of the process is
    made here, on a few elements, which run on this thread alone."""
    global _log2_ready
    if not _log2_ready and x.device.type == "cpu":
        with _log2_lock:
            if not _log2_ready:
                torch.log2(torch.ones(16))
                _log2_ready = True
    return torch.log2(x)


def pow10(x: torch.Tensor) -> torch.Tensor:
    """10**x via exp2."""
    return torch.exp2(x * LOG2_10)


def log10(x: torch.Tensor) -> torch.Tensor:
    """log10(x) via log2."""
    return _log2(x) * LOG10_2


def expe(x: torch.Tensor) -> torch.Tensor:
    """e**x via exp2."""
    return torch.exp2(x * LOG2_E)


def softplus(u: torch.Tensor, w) -> torch.Tensor:
    """w * log(1 + exp(u/w)), overflow-safe, in exp2/log2 form.

    ``w`` is a tensor or a Python float; a float is taken as float32, and
    its reciprocal is the float32 quotient, as in the JAX form."""
    if isinstance(w, float):
        w32 = np.float32(w)
        w, inv = float(w32), float(np.float32(1.0) / w32)
    else:
        inv = 1.0 / w
    t = u * inv
    return w * (
        torch.clamp(t, min=0.0)
        + LN_2 * _log2(1.0 + torch.exp2(-torch.abs(t) * LOG2_E))
    )


def powc(x: torch.Tensor, p: float) -> torch.Tensor:
    """x**p for a constant exponent; x is clamped away from 0."""
    return torch.exp2(_log2(torch.clamp(x, min=1e-30)) * float(np.float32(p)))


_LOGC3 = tuple(
    float(np.float32(v))
    for v in (0.010591, 5.555556, 0.052272, 0.247190, 0.385537, 5.367655, 0.092809)
)


def encode(x: torch.Tensor, key: str) -> torch.Tensor:
    """Display transfer encode; clips to [0, 1] first."""
    x = torch.clamp(x, 0.0, 1.0)
    if key == "Linear":
        return x
    if key in ("sRGB", "Display P3"):
        return torch.where(
            x <= float(np.float32(0.0031308)),
            x * float(np.float32(12.92)),
            float(np.float32(1.055)) * powc(x, 1.0 / 2.4) - float(np.float32(0.055)),
        )
    if key == "Rec709":
        return torch.where(
            x < float(np.float32(0.018)),
            x * 4.5,
            float(np.float32(1.099)) * powc(x, 0.45) - float(np.float32(0.099)),
        )
    if key == "Gamma 2.2":
        return powc(x, 1.0 / 2.2)
    if key == "Gamma 2.4":
        return powc(x, 1.0 / 2.4)
    if key == "ARRI LogC3":
        cut, a, b, c, d, e, f = _LOGC3
        return torch.where(
            x > cut,
            c * LOG10_2 * _log2(a * x + b) + d,
            e * x + f,
        )
    raise ValueError(f"unknown gamma_func {key!r}")
