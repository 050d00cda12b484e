"""The photographic chain: calibrated parameter bundles + host evaluation.

This module turns a (negative stock, print stock, user settings) triple into
three small frozen parameter bundles of matrices/vectors/curve constants.
Both the NumPy oracle (here) and the jitted TPU pipeline
(:mod:`raw2film_tpu_torch.pipeline.render`) evaluate the *same* closed-form math
from these bundles — the device path therefore needs no per-pixel LUT
gathers at all (XLA gathers measured ~20 MP/s on v5e; this design keeps the
hot chain elementwise + 3x3 matmuls at multi-GP/s).

Stage order matches the reference pipeline spec
(reference: src/raw2film/cpu_processor.py:269-414):

    camera XYZ --input transform--> linear layer exposures E
      [halation on E]
    E --log10 + H&D curve + masking--> negative density D
      [MTF, grain, highlight burn on D]
    D --print/inversion chain--> display linear RGB --OETF--> output

The tabulated-LUT builders in the program's ``film/luts.py`` sample these same
functions onto grids for parity with the reference's LUT-based engines
(get_input_lut / get_density_curve / create_lut).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.ref.film.config import DEFAULT_DTYPE, LOG10_EPS
from portbench.ref.film.data import XYZ_TO_DISPLAY_P3, XYZ_TO_REC709
from portbench.ref.film import spectra
from portbench.ref.film.sensitometry import (
    HDCurve,
    density_from_params,
    idealized,
    slope_from_params,
)
from portbench.ref.film.stock import (
    FilmStock,
    exposure_matrix,
    mid_grey_density,
    printing_density_matrix,
    viewing_density_matrix,
)
from portbench.ref.film.transfer import encode

GREY = 0.18
LOG_GREY = float(np.log10(GREY))


def _f32(a):
    return np.ascontiguousarray(np.asarray(a, DEFAULT_DTYPE))


def _curve_arrays(curve: HDCurve, push_pull=0.0, gamma_scale=None, use_ideal=False):
    c = idealized(curve) if use_ideal else curve
    params = c.params(push_pull, gamma_scale)
    out = []
    for p in params:
        p = np.asarray(p, np.float64)
        if p.shape[0] == 1:  # BW: replicate to 3 channels
            p = np.repeat(p, 3)
        out.append(_f32(p.reshape(3, 1, 1)))
    return tuple(out)


@dataclass(frozen=True)
class NegativeParams:
    """Input transform + development of the camera stock."""

    m_in: np.ndarray  # (3,3) XYZ -> layer exposure (CAT + exposure matrix + 2^ec)
    flare: float  # veiling-glare floor added to exposures
    curve: tuple  # 6 x (3,1,1) analytic H&D constants
    mask: np.ndarray  # (3,3) density coupling (color masking), applied to D-Dmin
    d_min: np.ndarray  # (3,) base densities
    bw: bool


@dataclass(frozen=True)
class PrintParams:
    """Print exposure + development, or direct inversion, or slide viewing."""

    mode: str  # "print" | "inversion" | "direct"
    a: np.ndarray  # (3,3) printing-density matrix (print mode)
    log_e0: np.ndarray  # (3,) printer calibration incl. lights
    curve: tuple  # print stock H&D constants (print mode)
    v: np.ndarray  # (3,3) viewing-density matrix
    d_offset: np.ndarray  # (3,) density offset subtracted before viewing
    vd_offset: np.ndarray  # (3,) -log10(projector white) folded into V.D
    inv_gamma: float  # exponent for inversion mode
    shadow_comp: float
    shadow_ref: float


@dataclass(frozen=True)
class OutputParams:
    to_display: np.ndarray  # (3,3) viewing XYZ -> linear display primaries
    white_gain: np.ndarray  # (3,) post gain (white balance / clip normalization)
    sat: float
    gamma_func: str


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------


def build_negative_params(
    stock: FilmStock,
    exp_kelvin: float = 6500.0,
    tint: float = 0.0,
    exp_comp: float = 0.0,
    push_pull: float = 0.0,
    color_masking: float | None = 1.0,
    flare: float = 0.0015,
) -> NegativeParams:
    """Calibrate the scene-side transform.

    White balance is a Bradford adaptation from the user-declared scene white
    (exp_kelvin/tint) to the stock's native balance — the role of the
    reference's ``get_input_lut(exp_kelvin, tint, exp_comp)``
    (reference: src/raw2film/cpu_processor.py:160).
    """
    if not (1000.0 <= float(exp_kelvin) <= 40000.0):
        raise ValueError(
            f"exp_kelvin={exp_kelvin!r} out of range [1000, 40000] K"
        )
    if abs(float(tint)) > 100.0:
        raise ValueError(f"tint={tint!r} out of range [-100, 100]")
    scene_white = spectra.white_with_tint(exp_kelvin, tint)
    native_white = spectra.kelvin_to_xyz(stock.native_kelvin)
    cat = spectra.adaptation_matrix(scene_white, native_white)
    m = exposure_matrix(stock)  # (L,3)
    if m.shape[0] == 1:
        m = np.repeat(m, 3, axis=0)
    m_in = (2.0**exp_comp) * (m @ cat)

    cm = 1.0 if color_masking is None else float(color_masking)
    # Interlayer-coupler masking: cm=1 -> fully masked (clean separation),
    # cm=0 -> unmasked crosstalk. Gamma trim mirrors the contrast change.
    if stock.is_bw:
        mask = np.eye(3)
        gamma_scale = None
    else:
        s = stock.color_masking_strength * (1.0 - cm)
        mask = (1.0 + 2.0 * s) * np.eye(3) - s * np.ones((3, 3))
        mask = mask / mask.sum(axis=1, keepdims=True) * (1.0 - 0.25 * s)
        gamma_scale = 1.0 + 0.10 * (cm - 1.0)

    curve = _curve_arrays(stock.curve, push_pull, gamma_scale)
    d_min = curve[0].reshape(3)
    return NegativeParams(
        m_in=_f32(m_in),
        flare=float(flare),
        curve=curve,
        mask=_f32(mask),
        d_min=_f32(d_min),
        bw=stock.is_bw,
    )


def _view_white(stock: FilmStock, projector_kelvin: float):
    """Viewing matrix + the XYZ of the projector light through D=0."""
    v = viewing_density_matrix(stock, projector_kelvin)
    if v.shape[1] == 1:  # BW medium: channel-replicated density triplets
        v = np.repeat(v, 3, axis=1) / 3.0
    white = spectra.kelvin_to_xyz(projector_kelvin)
    return v, white


def develop_negative(e_lin: np.ndarray, p: NegativeParams) -> np.ndarray:
    """Host oracle: linear exposures (3,H,W) -> status densities (3,H,W)."""
    x = np.log10(np.maximum(e_lin + p.flare, LOG10_EPS))
    d = density_from_params(x, *p.curve)
    d_min = p.d_min.reshape(3, 1, 1)
    return np.einsum("ij,jhw->ihw", p.mask, d - d_min) + d_min


def input_transform(xyz: np.ndarray, p: NegativeParams) -> np.ndarray:
    """Host oracle: camera XYZ (3,H,W) -> linear layer exposures (3,H,W)."""
    e = np.einsum("ij,jhw->ihw", p.m_in, xyz)
    return np.maximum(e, 0.0)


def build_print_params(
    neg: FilmStock,
    prt: FilmStock | None,
    red_light: float = 0.0,
    green_light: float = 0.0,
    blue_light: float = 0.0,
    projector_kelvin: float = 6500.0,
    shadow_comp: float = 0.0,
    inversion_gamma: float = 4.0,
    idealized_curve: bool = False,
    inversion: bool = False,
    white_balance: bool = False,
    neg_params: NegativeParams | None = None,
) -> PrintParams:
    """Calibrate the output side (the role of the reference's ``create_lut``,
    reference: src/raw2film/cpu_processor.py:232-253).

    Printer lights are in stops on the corresponding channel's exposure.
    ``white_balance=True`` solves the lights so a mid-grey scene prints
    neutral. Calibration anchors mid-grey scene -> display Y = 0.18.
    """
    if neg_params is None:
        neg_params = build_negative_params(neg)
    d_grey = develop_negative(
        np.full((3, 1, 1), GREY, np.float64), neg_params
    ).reshape(3)

    lights = np.array([red_light, green_light, blue_light], np.float64) * np.log10(2.0)

    if prt is not None and not inversion:
        # (Lp, Dn) -> (3, 3): a BW side has one layer/dye but its density
        # triplet is channel-replicated, so averaging columns / repeating rows
        # keeps A @ d exact.
        a = printing_density_matrix(neg, prt)
        if a.shape[1] == 1:
            a = np.repeat(a, 3, axis=1) / 3.0
        if a.shape[0] == 1:
            a = np.repeat(a, 3, axis=0)
        v, white = _view_white(prt, projector_kelvin)
        curve = _curve_arrays(prt.curve, 0.0, None, idealized_curve)

        # Anchor: the aim patch prints *neutral* at display Y = 0.18 with
        # printer lights at zero — the balanced default any lab targets; user
        # lights then shift per channel from this neutral point. The aim patch
        # is mid-grey, or diffuse white when ``white_balance`` is requested
        # (neutralizes highlight crossover instead of the midtones).
        d_aim = d_grey
        if white_balance:
            d_aim = develop_negative(
                np.full((3, 1, 1), 1.0, np.float64), neg_params
            ).reshape(3)
            aim_y = 0.85
        else:
            aim_y = GREY
        # Solve V . print_curve(log_e0 - A d_aim) = -log10(aim_y) per channel
        # by damped Newton through the analytic curve.
        target = -np.log10(aim_y)
        x_mid = 0.5 * (
            np.asarray(curve[2]).reshape(3) + np.asarray(curve[3]).reshape(3)
        )
        log_e0 = a @ d_aim + x_mid
        flat = [np.asarray(p).reshape(3) for p in curve]
        for _ in range(60):
            x = log_e0 - a @ d_aim
            d_p = density_from_params(x, *flat)
            resid = target - v @ d_p
            if np.max(np.abs(resid)) < 1e-9:
                break
            jac = v @ np.diag(np.maximum(slope_from_params(x, *flat), 0.02))
            # lstsq, not solve: a single-dye BW paper makes V rank-1 (flat
            # silver absorption -> identical columns), so the Jacobian is
            # singular and the minimum-norm step is the right one.
            log_e0 += 0.7 * np.linalg.lstsq(jac, resid, rcond=None)[0]
        log_e0 = log_e0 + lights
        return PrintParams(
            mode="print",
            a=_f32(a),
            log_e0=_f32(log_e0),
            curve=curve,
            v=_f32(v),
            d_offset=_f32(np.zeros(3)),
            vd_offset=_f32(-np.log10(np.clip(white / white[1], 1e-6, None))),
            inv_gamma=float(inversion_gamma),
            shadow_comp=float(shadow_comp),
            shadow_ref=float(np.mean(v @ np.asarray(curve[0]).reshape(3)) + 1.1),
        )

    if neg.film_type == "positive" and not inversion:
        # Slide film viewed directly on the projector: no printing step means
        # no re-anchoring — brightness is whatever the camera exposure put on
        # the film. Printer lights act as per-channel density trims.
        v, white = _view_white(neg, projector_kelvin)
        # Neutral-balance calibration: reversal stocks are designed so that an
        # equal-density neutral VIEWS neutral. Solve column scales s with
        # V @ s = c * 1 and fold them into V (the dye mix a real neutral
        # carries is not exactly 1:1:1 in normalized units).
        try:
            s = np.linalg.solve(v, np.ones(3))
            s = s / np.mean(s)
            if np.all(s > 0.2):
                v = v @ np.diag(s)
        except np.linalg.LinAlgError:
            pass
        d_off = -lights
        return PrintParams(
            mode="direct",
            a=_f32(np.eye(3)),
            log_e0=_f32(np.zeros(3)),
            curve=_curve_arrays(neg.curve),
            v=_f32(v),
            d_offset=_f32(d_off),
            vd_offset=_f32(-np.log10(np.clip(white / white[1], 1e-6, None))),
            inv_gamma=float(inversion_gamma),
            shadow_comp=float(shadow_comp),
            shadow_ref=0.0,
        )

    # Scan-style inversion (no print stock): display = 10^(g*(D - d_off)) so
    # a denser negative (brighter scene) yields brighter output. g =
    # inversion_gamma / 2.6 makes the default 4.0 a print-like system gamma
    # (~1.54 on top of the negative's ~0.65); printer lights shift channels.
    g = float(inversion_gamma) / 2.6
    d_off = d_grey - np.log10(GREY) / g - lights / g
    return PrintParams(
        mode="inversion",
        a=_f32(np.eye(3)),
        log_e0=_f32(np.zeros(3)),
        curve=_curve_arrays(neg.curve),
        v=_f32(np.eye(3) * -g),
        d_offset=_f32(d_off),
        vd_offset=_f32(np.zeros(3)),
        inv_gamma=g,
        shadow_comp=float(shadow_comp),
        shadow_ref=float(-np.log10(GREY) * g + 1.1),
    )


def print_to_linear_xyz(density: np.ndarray, p: PrintParams) -> np.ndarray:
    """Host oracle: negative density (3,H,W) -> viewing linear XYZ (3,H,W)
    (un-normalized; projector white handled by OutputParams)."""
    if p.mode == "print":
        log_e = p.log_e0.reshape(3, 1, 1) - np.einsum("ij,jhw->ihw", p.a, density)
        d_p = density_from_params(log_e, *p.curve)
    else:
        d_p = density - p.d_offset.reshape(3, 1, 1)
    vd = np.einsum("ij,jhw->ihw", p.v, d_p)
    if p.shadow_comp:
        from portbench.ref.film.sensitometry import softplus

        vd = vd - p.shadow_comp * softplus(vd - p.shadow_ref, 0.35)
    # Projector/viewing illuminant folded in as a density offset:
    # XYZ = white * 10^(-V.D)  ==  10^(-(V.D + vd_offset)).
    return 10.0 ** (-(vd + p.vd_offset.reshape(3, 1, 1)))


def build_output_params(
    neg: FilmStock,
    prt: FilmStock | None,
    print_params: PrintParams,
    neg_params: NegativeParams | None = None,
    projector_kelvin: float = 6500.0,
    sat_adjust: float = 1.0,
    gamma_func: str = "sRGB",
    white_clip: bool = False,
) -> OutputParams:
    """Output encoding: projector-adapted XYZ -> display primaries + OETF."""
    if gamma_func == "Display P3":
        prim = XYZ_TO_DISPLAY_P3
    else:
        prim = XYZ_TO_REC709
    proj_white = spectra.kelvin_to_xyz(projector_kelvin)
    cat = spectra.adaptation_matrix(proj_white, spectra.D65_XYZ)

    if print_params.mode == "inversion":
        # Inversion already yields balanced display-linear RGB.
        to_display = np.eye(3)
        base_white = np.ones(3)
    else:
        to_display = prim @ cat
        base_white = to_display @ (proj_white / proj_white[1])

    # Normalize so unattenuated projector light (D=0 everywhere) maps to
    # display white; white_clip re-anchors to the medium's D_min (paper/base
    # white) so the brightest printable tone hits exactly 1.0 per channel,
    # which also neutralizes the base tint.
    gain = 1.0 / np.clip(base_white, 1e-6, None)
    if (white_clip or print_params.mode == "direct") and print_params.mode != "inversion":
        # Minimum achievable density of the medium (reversal curves store the
        # unexposed high end in d_min; their low end is the other endpoint).
        c = [np.asarray(p).reshape(3) for p in print_params.curve]
        d_lo = np.minimum(c[0], c[0] + c[1] * (c[3] - c[2]))
        if print_params.mode == "direct":
            d_lo = d_lo - print_params.d_offset
        t = 10.0 ** (-(print_params.v @ d_lo))
        lin_dmin = gain * (to_display @ ((proj_white / proj_white[1]) * t))
        gain = gain / np.clip(lin_dmin, 1e-6, None)
    return OutputParams(
        to_display=_f32(to_display),
        white_gain=_f32(gain),
        sat=float(sat_adjust),
        gamma_func=str(gamma_func),
    )


def encode_output(lin_xyz: np.ndarray, p: OutputParams, xp=np):
    """Viewing linear XYZ (3,H,W) -> encoded display RGB (3,H,W) in [0,1]."""
    rgb = xp.einsum("ij,jhw->ihw", xp.asarray(p.to_display), lin_xyz)
    rgb = rgb * xp.asarray(p.white_gain).reshape(3, 1, 1)
    if p.sat != 1.0:
        luma = (
            0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
        )
        rgb = luma[None] + p.sat * (rgb - luma[None])
    rgb = xp.clip(rgb, 0.0, 1.0)
    return encode(rgb, p.gamma_func, xp)


# --------------------------------------------------------------------------
# Full host oracle (the "CPU reference" of this framework)
# --------------------------------------------------------------------------


def render_oracle(
    xyz: np.ndarray,
    neg_p: NegativeParams,
    prt_p: PrintParams,
    out_p: OutputParams,
) -> np.ndarray:
    """Plain chain with no spatial effects: (3,H,W) XYZ -> encoded (3,H,W)."""
    e = input_transform(xyz, neg_p)
    d = develop_negative(e, neg_p)
    lin = print_to_linear_xyz(d, prt_p)
    return encode_output(lin, out_p)
