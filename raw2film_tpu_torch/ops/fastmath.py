"""exp2/log2 forms of the chain's transcendental ops.

The counterpart of ``raw2film_tpu/ops/fastmath.py``: the same expression
forms and the same float32 constants, so the port's elementwise stages track
the JAX package to a few ulps. The CUDA kernels use the same forms
(``csrc/common.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

# Exact doubles rounded once to float32, held as Python floats so that every
# op multiplies by the same float32 value.
LOG2_10 = float(np.float32(np.log2(10.0)))
LOG10_2 = float(np.float32(np.log10(2.0)))
LOG2_E = float(np.float32(np.log2(np.e)))
LN_2 = float(np.float32(np.log(2.0)))


def pow10(x: torch.Tensor) -> torch.Tensor:
    """10**x via exp2."""
    return torch.exp2(x * LOG2_10)


def log10(x: torch.Tensor) -> torch.Tensor:
    """log10(x) via log2."""
    return torch.log2(x) * LOG10_2


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
        + LN_2 * torch.log2(1.0 + torch.exp2(-torch.abs(t) * LOG2_E))
    )


def powc(x: torch.Tensor, p: float) -> torch.Tensor:
    """x**p for a constant exponent; x is clamped away from 0."""
    return torch.exp2(torch.log2(torch.clamp(x, min=1e-30)) * float(np.float32(p)))


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
            c * LOG10_2 * torch.log2(a * x + b) + d,
            e * x + f,
        )
    raise ValueError(f"unknown gamma_func {key!r}")
