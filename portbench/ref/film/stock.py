"""FilmStock: the parametric film-stock model and its spectral calibration.

Capability-equivalent of the reference's ``spectral_film_lut.FilmSpectral``
(attribute surface reconstructed from call sites, see SURVEY.md §2.2;
reference usage: src/raw2film/gui.py:209-259, cpu_processor.py:375-403,
effects.py:174,406).

Science model
-------------
Each stock is defined by small parametric ingredients:

* spectral **sensitivities** of its three (or one) emulsion layers —
  asymmetric Gaussians on the wavelength grid,
* an analytic **H&D curve** per layer (:mod:`portbench.ref.film.sensitometry`),
* **dye absorption spectra** (cyan/magenta/yellow image dyes) — Gaussian
  absorption bands with unwanted-side absorptions,
* grain (rms granularity + shape), MTF (adjacency-boosted low-pass), and
  descriptive metadata.

From these, host-side calibration derives the per-pixel *matrices* that the
TPU pipeline actually runs (no per-pixel spectral integration on device):

* ``exposure_matrix(white)``: camera XYZ -> layer exposures, least-squares
  fitted over a smooth reflectance training set under the scene illuminant,
* ``printing_density_matrix(print_stock)``: negative dye amounts -> effective
  printing densities seen by each print layer,
* ``viewing_density_matrix(projector)``: print dye amounts -> effective
  densities in CIE XYZ bands under the projector illuminant.

Densities are expressed in the stock's densitometry system (``status_m`` for
color negatives, ``bw`` visual for BW) by normalizing each dye to unit
densitometer response in its primary channel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from portbench.ref.film import spectra
from portbench.ref.film.sensitometry import HDCurve
from portbench.ref.film.spectra import WAVELENGTHS

# Densitometer responses (narrowband Gaussians; Status M red/green/blue and
# visual for BW). Self-consistent constants of this framework.
_STATUS_M_PEAKS = (646.0, 535.0, 436.0)  # R, G, B channels
_STATUS_M_WIDTH = 9.0


def _gauss(wl, mu, sigma):
    return np.exp(-0.5 * ((wl - mu) / sigma) ** 2)


def _asym_gauss(wl, mu, s_left, s_right):
    s = np.where(wl < mu, s_left, s_right)
    return np.exp(-0.5 * ((wl - mu) / s) ** 2)


def densitometer_response(system: str) -> np.ndarray:
    """(3, n_wl) densitometer channel responses (R, G, B rows)."""
    wl = WAVELENGTHS
    if system == "bw":  # visual density ~ photopic
        resp = spectra.XYZ_BAR[1][None, :].repeat(3, axis=0)
    else:  # status_m (also used for status_a approximation)
        resp = np.stack([_gauss(wl, p, _STATUS_M_WIDTH) for p in _STATUS_M_PEAKS])
    return resp / resp.sum(axis=1, keepdims=True)


@dataclass(frozen=True)
class DyeSet:
    """Image dye absorption spectra: (peak_nm, width_left, width_right,
    secondary_peak, secondary_amp) per dye, order C, M, Y."""

    peaks: tuple[float, float, float] = (655.0, 545.0, 445.0)
    widths: tuple[float, float, float] = (62.0, 45.0, 40.0)
    # Unwanted short-wavelength side absorptions (fraction of main peak).
    unwanted: tuple[float, float, float] = (0.12, 0.18, 0.04)
    # Unwanted long-wavelength side absorptions (magenta dyes especially
    # absorb into the red band).
    unwanted_red: tuple[float, float, float] = (0.0, 0.22, 0.10)
    # Broadband (spectrally flat) absorption per unit dye: real image dyes
    # absorb across the whole spectrum; without this the broadband CIE viewing
    # integral leaks badly at Dmax (red-cast shadows).
    flat: float = 0.08

    def spectra(self) -> np.ndarray:
        """(3, n_wl) spectral densities, normalized later per densitometer."""
        wl = WAVELENGTHS
        out = []
        for (mu, w, uw, ur) in zip(
            self.peaks, self.widths, self.unwanted, self.unwanted_red
        ):
            main = _asym_gauss(wl, mu, w * 1.15, w * 0.85)
            # Unwanted absorptions sit ~110nm to either side of the peak.
            side = _gauss(wl, mu - 110.0, 45.0) * uw + _gauss(wl, mu + 110.0, 55.0) * ur
            out.append(main + side + self.flat)
        return np.stack(out)


@dataclass(frozen=True)
class Sensitivities:
    """Spectral sensitivities of the emulsion layers (red-, green-,
    blue-sensitive), asymmetric Gaussians."""

    peaks: tuple[float, float, float] = (640.0, 548.0, 465.0)
    widths: tuple[float, float, float] = (35.0, 35.0, 32.0)
    asym: tuple[float, float, float] = (1.0, 1.0, 1.0)

    def spectra(self) -> np.ndarray:
        wl = WAVELENGTHS
        out = []
        for (mu, w, a) in zip(self.peaks, self.widths, self.asym):
            out.append(_asym_gauss(wl, mu, w * a, w / a))
        s = np.stack(out)
        return s / s.max(axis=1, keepdims=True)


@dataclass(frozen=True)
class GrainModel:
    """RMS granularity science. ``rms`` is the classic RMS-granularity value
    (sigma of density x1000 through a 48-micron aperture at D=1)."""

    rms: float = 4.5
    peak_density: float = 1.0
    width: float = 1.2
    floor: float = 0.15

    def amplitude(self, density, d_min, d_max):
        """Grain sigma(D) shape: rises from the toe, peaks mid-curve, falls at
        the shoulder (developed-grain statistics). `density` is an array."""
        np_ = np
        rng = max(float(np.mean(np.asarray(d_max) - np.asarray(d_min))), 1e-3)
        t = (density - d_min) / rng
        shape = self.floor + (1 - self.floor) * np_.exp(
            -0.5 * ((t - self.peak_density / rng * 0.5 - 0.25) / (self.width * 0.35)) ** 2
        )
        return (self.rms / 1000.0) * shape


@dataclass(frozen=True)
class MTFModel:
    """Film MTF: adjacency-effect boost at low frequency, power-law rolloff.

        MTF(f) = (1 + adj * (f/f_adj) * exp(1 - f/f_adj)) / (1 + (f/f50)^p)

    ``f50`` = frequency (lp/mm) of 50% response; ``adj`` > 0 produces the
    characteristic >1.0 acutance bump real films show.
    """

    f50: float = 50.0
    power: float = 1.8
    adj: float = 0.25
    f_adj: float = 12.0

    def response(self, f: np.ndarray) -> np.ndarray:
        f = np.asarray(f, np.float64)
        boost = 1.0 + self.adj * (f / self.f_adj) * np.exp(1.0 - f / self.f_adj)
        return boost / (1.0 + (f / self.f50) ** self.power)

    def tabulate(self) -> tuple[np.ndarray, np.ndarray]:
        """Sample to the reference's (log1p(f), val) tabulated form
        (reference: src/raw2film/effects.py:114-120 interpolates in
        log1p-frequency space)."""
        f = np.geomspace(1.0, 400.0, 48)
        return np.log1p(f), self.response(f)


@dataclass(frozen=True)
class FilmStock:
    """A film stock. Attribute names mirror the reference's FilmSpectral where
    observable (name, year, manufacturer, stage, film_type, medium, iso,
    resolution, rms, rms_density, density_measure, mtf, d_ref, gamma, alias,
    comment, color_checker, color_masking)."""

    name: str
    manufacturer: str = ""
    year: int = 2000
    stage: str = "camera"  # "camera" | "print"
    film_type: str = "negative"  # "negative" | "positive" | "paper"
    medium: str = "film"  # "film" | "paper"
    iso: float = 100.0
    resolution: float = 100.0  # lines/mm (50% MTF-ish)
    density_measure: str = "status_m"  # "status_m" | "bw"
    alias: tuple[str, ...] = ()
    comment: str = ""
    provenance: str = ""
    """Data grounding: which parameters come from published datasheet
    figures (with the measure and source named) and which are class
    estimates (film/loader.py PROVENANCE)."""
    color_masking_strength: float = 0.12
    native_kelvin: float = 5500.0  # illuminant the stock is balanced for

    curve: HDCurve = field(
        default_factory=lambda: HDCurve(
            d_min=(0.20, 0.65, 0.95),
            gamma=(0.62, 0.65, 0.68),
            x_toe=(-2.45, -2.45, -2.45),
            x_shoulder=(0.6, 0.6, 0.6),
        )
    )
    sens: Sensitivities = field(default_factory=Sensitivities)
    dyes: DyeSet = field(default_factory=DyeSet)
    grain: GrainModel | None = field(default_factory=GrainModel)
    mtf_model: MTFModel | None = field(default_factory=MTFModel)

    # ---------------------------------------------------------- derived
    @property
    def channels(self) -> int:
        return self.curve.channels

    @property
    def is_bw(self) -> bool:
        return self.density_measure == "bw"

    @property
    def mtf(self):
        """Tabulated per-channel MTF as list[(logf, vals)] — reference shape
        (reference: src/raw2film/effects.py:174 iterates ``stock.mtf``)."""
        if self.mtf_model is None:
            return None
        tab = self.mtf_model.tabulate()
        return [tab] * 3

    @property
    def rms(self) -> float | None:
        return None if self.grain is None else self.grain.rms

    @property
    def rms_density(self):
        """Truthy grain-science marker (reference gates grain on
        ``stock.rms_density is not None``, src/raw2film/cpu_processor.py:387)."""
        return None if self.grain is None else self.grain.rms / 1000.0

    @property
    def gamma(self) -> float:
        return float(np.mean(self.curve.gamma))

    @property
    def d_ref(self) -> np.ndarray:
        """Mid-grey reference density per channel (used by highlight burn,
        reference: src/raw2film/effects.py:406 and gpu_processor.py:860)."""
        return mid_grey_density(self)

    # ------------------------------------------------- spectral calibration
    def normalized_dye_spectra(self) -> np.ndarray:
        """Dye spectral densities normalized to unit densitometer response in
        each dye's primary channel, so density triplets == dye amounts."""
        eps = self.dyes.spectra()  # (3=CMY, n_wl)
        resp = densitometer_response(self.density_measure)  # (3=RGB, n_wl)
        if self.is_bw:
            # Single neutral (silver) 'dye': flat absorption.
            flat = np.ones((1, len(WAVELENGTHS)))
            return flat
        # Dye j primary channel j (C<->R, M<->G, Y<->B).
        out = []
        for j in range(3):
            d = eps[j]
            # Density of amount a: resp-weighted -log10 of transmittance.
            # Normalize via small-amount linearization then refine.
            a = 1.0
            for _ in range(20):
                t = 10.0 ** (-a * d)
                dens = -np.log10(np.sum(resp[j] * t))
                a *= 1.0 / max(dens, 1e-6)
            out.append(a * d)
        return np.stack(out)

    def layer_sensitivity_spectra(self) -> np.ndarray:
        s = self.sens.spectra()
        if self.is_bw:
            # Panchromatic: sum of the three sensitized bands.
            s = s.sum(axis=0, keepdims=True)
            s = s / s.max()
        return s


# --------------------------------------------------------------------------
# Calibration routines (cached per stock identity).
# --------------------------------------------------------------------------


def _training_reflectances(n: int = 128) -> np.ndarray:
    """Smooth synthetic reflectance set: Gaussian bumps + notches + neutrals."""
    wl = WAVELENGTHS
    refl = [np.full_like(wl, g) for g in (0.03, 0.18, 0.45, 0.9)]
    rng = np.random.default_rng(7)
    for _ in range(n):
        mu = rng.uniform(400, 700)
        sig = rng.uniform(30, 140)
        amp = rng.uniform(0.1, 0.9)
        base = rng.uniform(0.02, 0.3)
        bump = base + amp * np.exp(-0.5 * ((wl - mu) / sig) ** 2)
        refl.append(np.clip(bump, 1e-3, 1.0))
        refl.append(np.clip(1.05 - bump, 1e-3, 1.0))
    return np.stack(refl)


@lru_cache(maxsize=128)
def _exposure_matrix_cached(key, sens_bytes, n_wl, illum_kelvin):
    sens = np.frombuffer(sens_bytes, np.float64).reshape(-1, n_wl)
    illum = spectra.illuminant_spd(illum_kelvin)
    refl = _training_reflectances()
    xyz_bar = spectra.XYZ_BAR
    # Normalize illuminant so that a perfect diffuser has Y = 1.
    k = 1.0 / np.sum(illum * xyz_bar[1])
    xyz = (refl * illum) @ xyz_bar.T * k  # (n, 3)
    # Layer exposures, normalized so the diffuser gets exposure 1 per layer.
    e_norm = np.sum(illum * sens, axis=1)  # (L,)
    expo = (refl * illum) @ sens.T / e_norm  # (n, L)
    # Least-squares XYZ -> exposures (film is non-colorimetric; LSQ fit).
    m, *_ = np.linalg.lstsq(xyz, expo, rcond=None)
    return m.T  # (L, 3)


def exposure_matrix(stock: FilmStock) -> np.ndarray:
    """(L, 3) matrix: scene XYZ (white-adapted to the stock's native
    illuminant, Y of diffuse white = 1) -> relative layer exposures."""
    sens = stock.layer_sensitivity_spectra()
    return _exposure_matrix_cached(
        stock.name, sens.astype(np.float64).tobytes(), sens.shape[1], stock.native_kelvin
    )


@lru_cache(maxsize=128)
def _density_matrix_cached(dye_bytes, resp_bytes, illum_bytes, n_wl):
    dyes = np.frombuffer(dye_bytes, np.float64).reshape(-1, n_wl)
    resp = np.frombuffer(resp_bytes, np.float64).reshape(-1, n_wl)
    illum = np.frombuffer(illum_bytes, np.float64)
    a = np.zeros((resp.shape[0], dyes.shape[0]))
    w = illum[None, :] * resp
    w = w / w.sum(axis=1, keepdims=True)
    for j in range(dyes.shape[0]):
        t = 10.0 ** (-dyes[j])
        a[:, j] = -np.log10(np.clip(w @ t, 1e-12, None))
    return a


def density_matrix(
    dye_spectra: np.ndarray, response: np.ndarray, illum: np.ndarray
) -> np.ndarray:
    """Effective-density matrix A[c, j]: response channel c's density for unit
    amount of dye j under illuminant ``illum`` (the classic printing-density /
    integral-density linearization of spectral transmittance)."""
    return _density_matrix_cached(
        dye_spectra.astype(np.float64).tobytes(),
        response.astype(np.float64).tobytes(),
        illum.astype(np.float64).tobytes(),
        dye_spectra.shape[1],
    )


def printing_density_matrix(neg: FilmStock, prt: FilmStock) -> np.ndarray:
    """(Lp, Dn) matrix: negative dye amounts -> printing densities seen by the
    print stock's layers under a tungsten enlarger (3200K)."""
    sens = prt.layer_sensitivity_spectra()
    illum = spectra.planck_spd(3200.0)
    return density_matrix(neg.normalized_dye_spectra(), sens, illum)


def viewing_density_matrix(stock: FilmStock, projector_kelvin: float) -> np.ndarray:
    """(3, D) matrix: dye amounts -> effective densities in CIE XYZ bands
    under the projection/viewing illuminant."""
    illum = spectra.illuminant_spd(projector_kelvin)
    return density_matrix(stock.normalized_dye_spectra(), spectra.XYZ_BAR, illum)


def mid_grey_density(stock: FilmStock) -> np.ndarray:
    """Density per channel for a mid-grey (0.18) exposure at box speed."""
    x = np.log10(0.18)
    d_min, gamma, x_toe, x_sh, w_t, w_s = stock.curve.params()
    from portbench.ref.film.sensitometry import density_from_params

    return density_from_params(x, d_min, gamma, x_toe, x_sh, w_t, w_s)
