"""Output transfer functions (OETFs) usable from NumPy and JAX.

Capability parity with the reference's GAMMA_KEYS output-encoding selector
(reference: src/raw2film/cpu_processor.py:7 imports GAMMA_KEYS; "sRGB" is the
default, src/raw2film/cpu_processor.py:284).
"""

from __future__ import annotations

import numpy as np

GAMMA_KEYS = (
    "sRGB",
    "Rec709",
    "Display P3",
    "Gamma 2.2",
    "Gamma 2.4",
    "Linear",
    "ARRI LogC3",
)


def encode(x, key: str, xp=np):
    """Encode linear light [0,1] with the named transfer function.

    ``xp`` is the array namespace (numpy or jax.numpy) so the identical code
    path serves the host oracle and the jitted device pipeline.
    """
    x = xp.clip(x, 0.0, 1.0)
    if key == "Linear":
        return x
    if key == "sRGB":
        return xp.where(
            x <= 0.0031308, 12.92 * x, 1.055 * xp.power(x, 1.0 / 2.4) - 0.055
        )
    if key == "Rec709":
        return xp.where(x < 0.018, 4.5 * x, 1.099 * xp.power(x, 0.45) - 0.099)
    if key == "Display P3":  # P3 uses the sRGB curve
        return xp.where(
            x <= 0.0031308, 12.92 * x, 1.055 * xp.power(x, 1.0 / 2.4) - 0.055
        )
    if key == "Gamma 2.2":
        return xp.power(x, 1.0 / 2.2)
    if key == "Gamma 2.4":
        return xp.power(x, 1.0 / 2.4)
    if key == "ARRI LogC3":
        cut, a, b, c, d, e, f = (
            0.010591,
            5.555556,
            0.052272,
            0.247190,
            0.385537,
            5.367655,
            0.092809,
        )
        return xp.where(
            x > cut, (c / np.log(10.0)) * xp.log(a * x + b) + d, e * x + f
        )
    raise ValueError(f"unknown gamma_func {key!r}; choose from {GAMMA_KEYS}")


def decode_srgb(x, xp=np):
    x = xp.clip(x, 0.0, 1.0)
    return xp.where(x <= 0.04045, x / 12.92, xp.power((x + 0.055) / 1.055, 2.4))
