"""Analytic sensitometry: the H&D characteristic-curve model.

The reference obtains per-stock density curves from datasheet scans inside
``spectral_film_lut`` (consumed as tabulated (4, N) arrays,
reference: src/raw2film/cpu_processor.py:182, gpu_processor.py:318-328).
We instead model every characteristic curve with a smooth analytic family —
a softplus-bracketed linear section:

    D(x) = Dmin + gamma * [ sp(x - x_toe, w_toe) - sp(x - x_sh, w_sh) ]
    sp(u, w) = w * log(1 + exp(u / w))

where x is log10 relative exposure. Properties:

* slope ``gamma`` over the straight-line portion ``x_toe < x < x_sh``,
* smooth toe of width ``w_toe`` and shoulder of width ``w_sh``,
* ``D -> Dmin`` as x -> -inf, ``D -> Dmin + gamma*(x_sh - x_toe)`` as x -> +inf
  (so ``Dmax = Dmin + gamma * (x_sh - x_toe)``).

Being analytic and elementwise, the same curve evaluates on host (NumPy
oracle) and on TPU (jnp, fused into the pipeline) with zero gathers — XLA
gathers measured at ~20 MP/s on v5e vs ~4 GP/s elementwise, which is why
tabulated-LUT interpolation is not the primary device path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.ref.film.config import (
    DENSITY_CURVE_SIZE,
    LOG_EXPOSURE_MAX,
    LOG_EXPOSURE_MIN,
)

LOG2 = float(np.log10(2.0))


def softplus(u, w):
    """Numerically-stable w*log(1+exp(u/w)); works for numpy and jax arrays."""
    t = u / w
    # log1p(exp(t)) = max(t,0) + log1p(exp(-|t|))
    np_ = np  # host path; jnp arrays also support these ufuncs via __array_ufunc__
    return w * (np_.maximum(t, 0.0) + np_.log1p(np_.exp(-np_.abs(t))))


@dataclass(frozen=True)
class HDCurve:
    """Per-channel H&D curve parameters (arrays of shape (C,))."""

    d_min: tuple[float, ...]
    gamma: tuple[float, ...]
    x_toe: tuple[float, ...]
    x_shoulder: tuple[float, ...]
    w_toe: tuple[float, ...] = (0.35, 0.35, 0.35)
    w_shoulder: tuple[float, ...] = (0.45, 0.45, 0.45)

    @property
    def channels(self) -> int:
        return len(self.d_min)

    def params(self, push_pull: float = 0.0, gamma_scale=None):
        """Resolve parameters to (C,) float arrays, applying push/pull.

        Push processing (positive ``push_pull`` stops) increases development:
        effective speed rises (curve shifts left) and contrast rises ~15% per
        stop; pull is the reverse. Matches the role of the reference's
        ``push_pull`` kwarg (reference: src/raw2film/cpu_processor.py:343).
        """
        d_min = np.asarray(self.d_min, np.float64)
        gamma = np.asarray(self.gamma, np.float64) * (1.15**push_pull)
        if gamma_scale is not None:
            gamma = gamma * np.asarray(gamma_scale, np.float64)
        shift = -push_pull * LOG2
        x_toe = np.asarray(self.x_toe, np.float64) + shift
        x_sh = np.asarray(self.x_shoulder, np.float64) + shift
        # Development pushes shoulder density up slightly as well.
        x_sh = x_sh + 0.06 * push_pull
        w_t = np.asarray(self.w_toe, np.float64)
        w_s = np.asarray(self.w_shoulder, np.float64)
        return d_min, gamma, x_toe, x_sh, w_t, w_s

    def density(self, log_e, push_pull: float = 0.0, gamma_scale=None):
        """Evaluate densities. ``log_e`` shape (..., C) or (C, ...) — the
        channel axis is whichever matches ``channels`` and is broadcast
        against the parameter arrays; callers pass (C,) params pre-shaped."""
        d_min, gamma, x_toe, x_sh, w_t, w_s = self.params(push_pull, gamma_scale)
        return density_from_params(log_e, d_min, gamma, x_toe, x_sh, w_t, w_s)

    @property
    def d_max(self) -> np.ndarray:
        d_min, gamma, x_toe, x_sh, _, _ = self.params()
        return d_min + gamma * (x_sh - x_toe)


def density_from_params(log_e, d_min, gamma, x_toe, x_sh, w_t, w_s):
    """The analytic H&D evaluation; `log_e` broadcasts against (C,) params."""
    return d_min + gamma * (
        softplus(log_e - x_toe, w_t) - softplus(log_e - x_sh, w_s)
    )


def _sigmoid(u):
    return 0.5 * (1.0 + np.tanh(0.5 * u))


def slope_from_params(log_e, d_min, gamma, x_toe, x_sh, w_t, w_s):
    """Analytic dD/dlogE of the H&D model (softplus' = sigmoid)."""
    return gamma * (
        _sigmoid((log_e - x_toe) / w_t) - _sigmoid((log_e - x_sh) / w_s)
    )


def tabulate_curve(
    curve: HDCurve,
    push_pull: float = 0.0,
    gamma_scale=None,
    n: int = DENSITY_CURVE_SIZE,
    x_min: float = LOG_EXPOSURE_MIN,
    x_max: float = LOG_EXPOSURE_MAX,
) -> np.ndarray:
    """Tabulate to the reference's (4, N) layout: row 0 = log-exposure grid,
    rows 1..3 = per-channel density (reference layout evidence:
    src/raw2film/gpu_processor.py:318-328 uploads ``lut[1:].T`` with
    ``xp_min=lut[0,0], xp_max=lut[0,-1]``)."""
    x = np.linspace(x_min, x_max, n)
    d_min, gamma, x_toe, x_sh, w_t, w_s = curve.params(push_pull, gamma_scale)
    c = curve.channels
    out = np.empty((4, n), np.float32)
    out[0] = x
    for i in range(3):
        j = min(i, c - 1)  # BW stocks replicate their single channel
        out[1 + i] = density_from_params(
            x, d_min[j], gamma[j], x_toe[j], x_sh[j], w_t[j], w_s[j]
        )
    return out


def idealized(curve: HDCurve) -> HDCurve:
    """An 'idealized' variant: pure straight-line gamma with hard, narrow toe
    and shoulder (capability parity with the reference's ``idealized_curve``
    flag, reference: src/raw2film/cpu_processor.py:246)."""
    return HDCurve(
        d_min=curve.d_min,
        gamma=curve.gamma,
        x_toe=curve.x_toe,
        x_shoulder=curve.x_shoulder,
        w_toe=tuple(0.05 for _ in curve.w_toe),
        w_shoulder=tuple(0.05 for _ in curve.w_shoulder),
    )
