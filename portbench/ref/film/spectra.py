"""Spectral primitives: wavelength grid, CIE observer, illuminants, CCT.

The CIE 1931 2-degree color matching functions use the multi-lobe Gaussian
analytic fits of Wyman, Sloan & Shirley (JCGT 2013), accurate to ~1% — ample
for calibrating film-stock matrices, and self-consistent across the whole
framework (the device pipeline and the NumPy oracle share every constant).

CCT conversions mirror the reference's helpers (reference:
src/raw2film/color_processing.py:11-53 — McCamy-style CCT estimate and the
Kim/Kang cubic-spline planckian-locus polynomial, both standard published
formulae).
"""

from __future__ import annotations

import numpy as np

from portbench.ref.film.config import DEFAULT_DTYPE

WL_START = 380.0
WL_END = 780.0
WL_STEP = 5.0
WAVELENGTHS = np.arange(WL_START, WL_END + WL_STEP, WL_STEP)
"""Wavelength grid in nm (81 samples)."""


def _g(x: np.ndarray, mu: float, s1: float, s2: float) -> np.ndarray:
    """Piecewise Gaussian with different left/right widths."""
    s = np.where(x < mu, s1, s2)
    t = (x - mu) / s
    return np.exp(-0.5 * t * t)


def cie_xyz_bar(wl: np.ndarray | None = None) -> np.ndarray:
    """CIE 1931 2-deg color matching functions, shape (3, n_wl).

    Wyman-Sloan-Shirley multi-lobe Gaussian fits.
    """
    if wl is None:
        wl = WAVELENGTHS
    x = (
        1.056 * _g(wl, 599.8, 37.9, 31.0)
        + 0.362 * _g(wl, 442.0, 16.0, 26.7)
        - 0.065 * _g(wl, 501.1, 20.4, 26.2)
    )
    y = 0.821 * _g(wl, 568.8, 46.9, 40.5) + 0.286 * _g(wl, 530.9, 16.3, 31.1)
    z = 1.217 * _g(wl, 437.0, 11.8, 36.0) + 0.681 * _g(wl, 459.0, 26.0, 13.8)
    return np.stack([x, y, z]).astype(np.float64)


XYZ_BAR = cie_xyz_bar()


def planck_spd(temp_k: float, wl: np.ndarray | None = None) -> np.ndarray:
    """Blackbody spectral power distribution, normalized to 1.0 at 560 nm."""
    if wl is None:
        wl = WAVELENGTHS
    lam = wl * 1e-9
    c2 = 1.4388e-2  # m*K (second radiation constant)
    spd = lam**-5 / np.expm1(c2 / (lam * temp_k))
    lam0 = 560e-9
    norm = lam0**-5 / np.expm1(c2 / (lam0 * temp_k))
    return spd / norm


def daylight_spd(temp_k: float, wl: np.ndarray | None = None) -> np.ndarray:
    """Approximate daylight SPD.

    Blackbody radiator with a mild short-wavelength lift that nudges the
    chromaticity toward the daylight locus (daylight sits slightly green of
    planckian). Self-consistent approximation: both LUT calibration and the
    oracle use this same function.
    """
    if wl is None:
        wl = WAVELENGTHS
    spd = planck_spd(temp_k, wl)
    # Daylight locus offset: slight enhancement below 500nm relative to planckian.
    lift = 1.0 + 0.08 * np.exp(-0.5 * ((wl - 450.0) / 60.0) ** 2)
    return spd * lift


def illuminant_spd(temp_k: float, wl: np.ndarray | None = None) -> np.ndarray:
    """Scene/projector illuminant: tungsten (planckian) below 4000K, daylight above."""
    if temp_k <= 4000:
        return planck_spd(temp_k, wl)
    return daylight_spd(temp_k, wl)


def spd_to_xyz(spd: np.ndarray, wl: np.ndarray | None = None) -> np.ndarray:
    """Integrate an SPD against the CIE observer. Normalized so Y=1."""
    xyz_bar = XYZ_BAR if wl is None else cie_xyz_bar(wl)
    xyz = xyz_bar @ spd
    return xyz / xyz[1]


def kelvin_to_xyz(cct: float) -> np.ndarray:
    """CCT (kelvin) -> CIE XYZ whitepoint (Y=1), Kim et al. cubic polynomial
    (same published formula the reference uses,
    reference: src/raw2film/color_processing.py:25-53)."""
    cct = float(cct)
    cct2, cct3 = cct**2, cct**3
    if cct <= 4000:
        x = (
            -0.2661239e9 / cct3
            - 0.2343589e6 / cct2
            + 0.8776956e3 / cct
            + 0.179910
        )
    else:
        x = (
            -3.0258469e9 / cct3
            + 2.1070379e6 / cct2
            + 0.2226347e3 / cct
            + 0.24039
        )
    x2, x3 = x**2, x**3
    if cct <= 2222:
        y = -1.1063814 * x3 - 1.34811020 * x2 + 2.18555832 * x - 0.20219683
    elif cct <= 4000:
        y = -0.9549476 * x3 - 1.37418593 * x2 + 2.09137015 * x - 0.16748867
    else:
        y = 3.0817580 * x3 - 5.8733867 * x2 + 3.75112997 * x - 0.37001483
    return np.array([x / y, 1.0, (1 - x - y) / y], dtype=np.float64)


def xyz_to_kelvin(xyz: np.ndarray) -> float:
    """CIE XYZ -> correlated color temperature (McCamy-style exponential fit,
    reference: src/raw2film/color_processing.py:11-22 uses the same family)."""
    s = float(np.sum(xyz))
    x = float(xyz[0]) / s
    y = float(xyz[1]) / s
    n = (x - 0.3366) / (y - 0.1735)
    return float(
        -949.86315
        + 6253.80338 * np.exp(-n / 0.92159)
        + 28.70599 * np.exp(-n / 0.20039)
        + 0.00004 * np.exp(-n / 0.07125)
    )


D65_XYZ = kelvin_to_xyz(6504.0)

# Bradford chromatic adaptation matrix (standard published values).
BRADFORD = np.array(
    [
        [0.8951, 0.2664, -0.1614],
        [-0.7502, 1.7135, 0.0367],
        [0.0389, -0.0685, 1.0296],
    ]
)
BRADFORD_INV = np.linalg.inv(BRADFORD)


def adaptation_matrix(src_white_xyz: np.ndarray, dst_white_xyz: np.ndarray) -> np.ndarray:
    """Bradford chromatic adaptation transform between two whitepoints."""
    src = BRADFORD @ (src_white_xyz / src_white_xyz[1])
    dst = BRADFORD @ (dst_white_xyz / dst_white_xyz[1])
    return (BRADFORD_INV @ np.diag(dst / src) @ BRADFORD).astype(np.float64)


def white_with_tint(kelvin: float, tint: float) -> np.ndarray:
    """Whitepoint for (CCT, tint). Tint shifts the white perpendicular to the
    planckian locus in xy (positive = green), matching the magenta<->green
    convention of the reference's tint slider."""
    xyz = kelvin_to_xyz(kelvin)
    s = np.sum(xyz)
    x, y = xyz[0] / s, xyz[1] / s
    # Local tangent of the locus via finite difference; normal = perpendicular.
    xyz2 = kelvin_to_xyz(kelvin * 1.01)
    s2 = np.sum(xyz2)
    tx, ty = xyz2[0] / s2 - x, xyz2[1] / s2 - y
    norm = np.hypot(tx, ty)
    nx, ny = -ty / norm, tx / norm
    if ny < 0:  # orient so positive tint moves toward green (larger y)
        nx, ny = -nx, -ny
    x += 0.01 * tint * nx
    y += 0.01 * tint * ny
    return np.array([x / y, 1.0, (1 - x - y) / y], dtype=np.float64)


def encode_arri_logc3(x: np.ndarray) -> np.ndarray:
    """ARRI LogC3 EI800 encode (public ARRI formula; reference:
    src/raw2film/color_processing.py:56-68)."""
    cut, a, b, c, d, e, f = (
        0.010591,
        5.555556,
        0.052272,
        0.247190,
        0.385537,
        5.367655,
        0.092809,
    )
    return np.where(
        x > cut, (c / np.log(10.0)) * np.log(a * x + b) + d, e * x + f
    ).astype(DEFAULT_DTYPE)
