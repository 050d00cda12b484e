"""Fit the analytic film models to measured samples.

The device pipeline evaluates analytic families (H&D softplus-bracket,
4-parameter MTF) because elementwise math runs ~200x faster than gathers on
TPU (see film/sensitometry.py). Measured data — datasheet scans, or curves
sampled from the reference's ``spectral_film_lut`` stocks via
``film/import_sfl.py`` — therefore enters the framework by FITTING those
families, not by tabulated lookup. This module owns the numpy-only fitters
(no scipy in the base environment): a compact Nelder-Mead simplex refiner
over data-driven initial guesses, per channel.

Reference context: the reference consumes measured curves as tabulated
arrays on CPU/GPU (reference: src/raw2film/cpu_processor.py:182,
gpu_processor.py:318-328); this framework's equivalent keeps the analytic
device path and absorbs measurements at calibration time.
"""

from __future__ import annotations

import numpy as np

from raw2film_tpu_torch.film.sensitometry import HDCurve, density_from_params
from raw2film_tpu_torch.film.stock import MTFModel


def nelder_mead(f, x0, scale, iters=400):
    """Minimize ``f`` over R^n from ``x0`` with per-dim simplex ``scale``.

    Standard reflection/expansion/contraction/shrink simplex; deterministic.
    Returns the best vertex. Small n (<= 8) only — exactly the model sizes
    here.
    """
    x0 = np.asarray(x0, np.float64)
    n = x0.size
    pts = [x0]
    for i in range(n):
        e = x0.copy()
        e[i] += scale[i]
        pts.append(e)
    pts = np.stack(pts)
    vals = np.array([f(p) for p in pts])
    for _ in range(iters):
        order = np.argsort(vals)
        pts, vals = pts[order], vals[order]
        if vals[-1] - vals[0] < 1e-12 * (1.0 + abs(vals[0])):
            break
        centroid = pts[:-1].mean(axis=0)
        xr = centroid + (centroid - pts[-1])  # reflect
        fr = f(xr)
        if fr < vals[0]:
            xe = centroid + 2.0 * (centroid - pts[-1])  # expand
            fe = f(xe)
            pts[-1], vals[-1] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < vals[-2]:
            pts[-1], vals[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (pts[-1] - centroid)  # contract
            fc = f(xc)
            if fc < vals[-1]:
                pts[-1], vals[-1] = xc, fc
            else:  # shrink toward best
                pts[1:] = pts[0] + 0.5 * (pts[1:] - pts[0])
                vals[1:] = [f(p) for p in pts[1:]]
    return pts[np.argmin(vals)]


def _fit_hd_channel(x, d):
    """Fit one channel's (log_e, density) samples. Returns the 6 HDCurve
    params (d_min, gamma, x_toe, x_sh, w_toe, w_sh) and the residual RMS."""
    x = np.asarray(x, np.float64)
    d = np.asarray(d, np.float64)
    lo, hi = float(d.min()), float(d.max())
    rng = max(hi - lo, 1e-6)
    rising = d[-1] >= d[0]
    # Initial guesses from the 5%/95% density crossings and central slope.
    # Falling (reversal) curves read crossings on the reversed orientation;
    # their model d_min is the HIGH density end (D(-inf) = d_min, gamma<0).
    t = (d - lo) / rng if rising else (d[::-1] - lo) / rng
    xs = x if rising else x[::-1]
    x_lo = float(np.interp(0.05, t, xs))
    x_hi = float(np.interp(0.95, t, xs))
    if x_hi < x_lo:  # falling curves cross in reverse x order
        x_lo, x_hi = x_hi, x_lo
    if x_hi <= x_lo:
        x_lo, x_hi = float(x.min()), float(x.max())
    gamma0 = rng / max(x_hi - x_lo, 1e-3) * (1.0 if rising else -1.0)
    p0 = [lo if rising else hi, gamma0, x_lo, x_hi, 0.35, 0.45]

    def loss(p):
        d_min, gamma, x_toe, x_sh, w_t, w_s = p
        if x_sh <= x_toe or w_t <= 0.01 or w_s <= 0.01:
            return 1e9
        pred = density_from_params(x, d_min, gamma, x_toe, x_sh, w_t, w_s)
        return float(np.mean((pred - d) ** 2))

    scale = [0.1 * rng, 0.2 * abs(gamma0), 0.3, 0.3, 0.15, 0.2]
    p = nelder_mead(loss, p0, scale, iters=600)
    p = nelder_mead(loss, p, [s * 0.2 for s in scale], iters=400)
    return p, float(np.sqrt(loss(p)))


def fit_hd_curve(log_e, density):
    """Fit the analytic HDCurve to measured samples.

    ``log_e``: (N,) log10-exposure grid. ``density``: (C, N) per-channel
    densities (the reference's get_density_curve rows 1..C, reference:
    src/raw2film/cpu_processor.py:182). Returns (HDCurve, rms_per_channel).
    """
    density = np.atleast_2d(np.asarray(density, np.float64))
    params, rms = [], []
    for ch in density:
        p, r = _fit_hd_channel(log_e, ch)
        params.append(p)
        rms.append(r)
    cols = list(zip(*params))
    curve = HDCurve(
        d_min=tuple(float(v) for v in cols[0]),
        gamma=tuple(float(v) for v in cols[1]),
        x_toe=tuple(float(v) for v in cols[2]),
        x_shoulder=tuple(float(v) for v in cols[3]),
        w_toe=tuple(float(v) for v in cols[4]),
        w_shoulder=tuple(float(v) for v in cols[5]),
    )
    return curve, np.asarray(rms)


def fit_mtf(logf, vals):
    """Fit the 4-parameter MTFModel to a tabulated (log1p(f), response)
    curve — the reference's per-stock ``mtf`` attribute shape (reference:
    src/raw2film/effects.py:114-120). Returns (MTFModel, rms)."""
    f = np.expm1(np.asarray(logf, np.float64))
    vals = np.asarray(vals, np.float64)
    keep = f > 1e-9
    f, vals = f[keep], vals[keep]
    # f50 guess: first crossing below 0.5.
    below = np.nonzero(vals < 0.5)[0]
    f50_0 = float(f[below[0]]) if below.size else float(f[-1])
    p0 = [f50_0, 1.8, max(float(vals.max()) - 1.0, 0.05), 12.0]

    def loss(p):
        f50, power, adj, f_adj = p
        if f50 <= 1.0 or power <= 0.2 or adj < 0.0 or f_adj <= 1.0:
            return 1e9
        m = MTFModel(f50=f50, power=power, adj=adj, f_adj=f_adj)
        return float(np.mean((m.response(f) - vals) ** 2))

    p = nelder_mead(loss, p0, [0.3 * p0[0], 0.5, 0.1, 5.0], iters=600)
    p = nelder_mead(loss, p, [0.05 * p0[0], 0.1, 0.03, 1.5], iters=300)
    model = MTFModel(
        f50=float(p[0]), power=float(p[1]), adj=float(p[2]), f_adj=float(p[3])
    )
    return model, float(np.sqrt(loss(p)))
