"""Generic LUT application ops (the counterpart of ``raw2film_tpu/ops/lut.py``).

Three families, as in the JAX package:

* :func:`apply_lut_2d`: energy-preserving chromaticity LUT, barycentric
  simplex interpolation;
* :func:`apply_curve_1d` (and its one-hot matmul form): per-channel
  tabulated curve on a uniform grid;
* :func:`apply_lut_3d_tetrahedral`: classic 6-case tetrahedral
  interpolation.

The exact paths gather per pixel and are for small images and validation.
The ICC output LUT of the render takes the CP-factored form instead: the
host fits the LUT once (:func:`fit_lut3d_cp`, numpy float64 ALS, a copy of
the JAX package's) and :func:`apply_lut_3d_cp` evaluates it per pixel from
three small factor tables. The JAX package computes that apply in XLA, which
fuses its (H, W, 3, r) products away; here it runs in plain PyTorch, over
row bands and one rank at a time, so no tensor larger than the output
exists (at 45 MP and rank 24 one (H, W, 3, r) float32 tensor would take
12.9 GB).
"""

from __future__ import annotations

import numpy as np
import torch

# Pixels per band of apply_lut_3d_cp: its temporaries are about ten band
# planes (16 MB each at this size), whatever the image size.
CP_BAND_PIXELS = 1 << 22


# --------------------------------------------------------------------- 2D


def apply_lut_2d(img: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """img (3, H, W) XYZ; lut (N, N, 3) indexed [x_idx, y_idx].

    S = X+Y+Z; (x, y) = (X, Y) * (N-1)/S; two-triangle barycentric interp;
    result scaled by S. Black shortcut for S < 1e-12.
    """
    n = lut.shape[0]
    s = img[0] + img[1] + img[2]
    safe = s > 1e-12
    inv = torch.where(safe, (n - 1.0) / torch.clamp(s, min=1e-12), torch.zeros_like(s))
    r = img[0] * inv
    g = img[1] * inv
    ri = torch.clamp(r.to(torch.int32), 0, n - 2)
    gi = torch.clamp(g.to(torch.int32), 0, n - 2)
    rf = r - ri
    gf = g - gi
    upper = (rf + gf) > 1.0

    flat = lut.reshape(-1, 3)

    def fetch(i, j):
        return flat[(i * n + j).long()]  # (..., 3)

    r_val = fetch(ri + 1, gi)
    g_val = fetch(ri, gi + 1)
    s_lo = fetch(ri, gi)
    s_hi = fetch(ri + 1, gi + 1)

    rf_ = rf[..., None]
    gf_ = gf[..., None]
    lo = r_val * rf_ + g_val * gf_ + s_lo * (1.0 - rf_ - gf_)
    hi = r_val * (1.0 - gf_) + g_val * (1.0 - rf_) + s_hi * (rf_ + gf_ - 1.0)
    out = torch.where(upper[..., None], hi, lo) * s[..., None]
    out = torch.where(safe[..., None], out, torch.zeros_like(out))
    return torch.movedim(out, -1, 0)


# --------------------------------------------------------------------- 1D


def resample_curve_uniform(curve: np.ndarray, n: int = 512):
    """Host: resample a (4, N) curve (row 0 = possibly non-uniform x-grid)
    onto a uniform grid. Returns (x_min, x_max, table (3, n))."""
    x = np.asarray(curve[0], np.float64)
    xu = np.linspace(x[0], x[-1], n)
    tab = np.stack([np.interp(xu, x, curve[1 + c]) for c in range(3)])
    return float(x[0]), float(x[-1]), tab.astype(np.float32)


def apply_curve_1d(img: torch.Tensor, x_min: float, x_max: float, table: torch.Tensor) -> torch.Tensor:
    """Per-channel uniform-grid linear interp: img (3, H, W) already in the
    curve's x-domain (log exposure); table (3, n)."""
    n = table.shape[1]
    pos = torch.clamp((img - x_min) / (x_max - x_min), 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(pos.to(torch.int32), 0, n - 2)
    f = pos - i0
    outs = []
    for c in range(3):
        t = table[c]
        idx = i0[c].long()
        outs.append(t[idx] * (1 - f[c]) + t[idx + 1] * f[c])
    return torch.stack(outs)


def apply_curve_1d_onehot(
    img: torch.Tensor, x_min: float, x_max: float, table: torch.Tensor
) -> torch.Tensor:
    """Gather-free variant: linear interp as a one-hot matmul. Same
    semantics as :func:`apply_curve_1d`; it forms a (pixels, n) matrix, so
    it is for small images."""
    n = table.shape[1]
    pos = torch.clamp((img - x_min) / (x_max - x_min), 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(pos), 0, n - 2)
    f = pos - i0
    iota = torch.arange(n, dtype=img.dtype, device=img.device)
    outs = []
    for c in range(3):
        p = i0[c].reshape(-1, 1)
        w = ((p == iota) * (1.0 - f[c].reshape(-1, 1)) + ((p + 1) == iota) * f[c].reshape(-1, 1)).to(img.dtype)
        outs.append((w @ table[c]).reshape(img.shape[1:]))
    return torch.stack(outs)


# --------------------------------------------------------------------- 3D


def apply_lut_3d_tetrahedral(img: torch.Tensor, lut: torch.Tensor, scale: float = 0.25) -> torch.Tensor:
    """Exact 6-case tetrahedral interpolation.

    img (3, H, W) pre-scaled by ``scale`` into [0, 1] LUT coords; lut
    (N, N, N, 3) indexed [r, g, b].
    """
    n = lut.shape[0]
    coords = img * (scale * (n - 1))
    i0 = torch.clamp(coords.to(torch.int32), 0, n - 2)
    d = torch.clamp(coords - i0, 0.0, 1.0)
    # Upper-edge clamp: when coords lands beyond the last cell the fraction
    # is exactly 1.
    d = torch.where(coords >= (n - 1), torch.ones_like(d), d)

    r0, g0, b0 = (i0[c].long() for c in range(3))
    dr, dg, db = d[0][..., None], d[1][..., None], d[2][..., None]

    flat = lut.reshape(-1, 3)

    def fetch(r, g, b):
        return flat[(r * n + g) * n + b]

    c000 = fetch(r0, g0, b0)
    c100 = fetch(r0 + 1, g0, b0)
    c010 = fetch(r0, g0 + 1, b0)
    c001 = fetch(r0, g0, b0 + 1)
    c110 = fetch(r0 + 1, g0 + 1, b0)
    c101 = fetch(r0 + 1, g0, b0 + 1)
    c011 = fetch(r0, g0 + 1, b0 + 1)
    c111 = fetch(r0 + 1, g0 + 1, b0 + 1)

    t1 = c000 + dr * (c100 - c000) + dg * (c110 - c100) + db * (c111 - c110)
    t2 = c000 + dr * (c100 - c000) + db * (c101 - c100) + dg * (c111 - c101)
    t3 = c000 + db * (c001 - c000) + dr * (c101 - c001) + dg * (c111 - c101)
    t4 = c000 + db * (c001 - c000) + dg * (c011 - c001) + dr * (c111 - c011)
    t5 = c000 + dg * (c010 - c000) + db * (c011 - c010) + dr * (c111 - c011)
    t6 = c000 + dg * (c010 - c000) + dr * (c110 - c010) + db * (c111 - c110)

    rg = dr >= dg
    gb = dg >= db
    rb = dr >= db

    out = torch.where(
        rg,
        torch.where(gb, t1, torch.where(rb, t2, t3)),
        torch.where(~gb, t4, torch.where(~rb, t5, t6)),
    )
    return torch.movedim(out, -1, 0)


def fit_lut3d_cp(
    lut: np.ndarray, rank: int = 16, iters: int = 60, seed: int = 0
):
    """Host: CP/ALS factorization of a (N, N, N, 3) LUT.

    lut[r,g,b,c] ~= sum_k U[r,k] V[g,k] W[b,k] C[k,c].
    Returns (U, V, W, C, max_abs_err). Smooth film LUTs reach <1e-3 max error
    at rank ~16-24; callers should check the returned error against their
    fidelity budget (ΔE 0.5 ≈ 2e-3 in encoded RGB).
    """
    n = lut.shape[0]
    t = np.asarray(lut, np.float64).reshape(n, n, n * 3)  # fold c into last
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, rank)) * 0.1 + 0.5
    v = rng.standard_normal((n, rank)) * 0.1 + 0.5
    w3 = rng.standard_normal((n * 3, rank)) * 0.1 + 0.5  # joint (b, c) mode

    full = np.asarray(lut, np.float64).reshape(n, n, n, 3)

    def unfold(a, mode):
        return np.moveaxis(a, mode, 0).reshape(a.shape[mode], -1)

    t3 = t.reshape(n, n, n * 3)
    for _ in range(iters):
        # mode-0
        kr = (v[:, None, :] * w3[None, :, :]).reshape(-1, rank)
        u = unfold(t3, 0) @ kr @ np.linalg.pinv(kr.T @ kr)
        # mode-1
        kr = (u[:, None, :] * w3[None, :, :]).reshape(-1, rank)
        v = unfold(t3, 1) @ kr @ np.linalg.pinv(kr.T @ kr)
        # mode-2 (joint b,c)
        kr = (u[:, None, :] * v[None, :, :]).reshape(-1, rank)
        w3 = unfold(t3, 2) @ kr @ np.linalg.pinv(kr.T @ kr)

    # Split the joint (b, c) mode into W (n, rank) x C (rank, 3) is not exact
    # in general; instead keep per-output-channel W_c: reshape to (n, 3, rank).
    w_bc = w3.reshape(n, 3, rank)
    approx = np.einsum("ir,jr,kcr->ijkc", u, v, w_bc)
    err = float(np.max(np.abs(approx - full)))
    return (
        u.astype(np.float32),
        v.astype(np.float32),
        w_bc.astype(np.float32),
        err,
    )


def _grid_index(coords: torch.Tensor, n: int):
    """(i0, i0 + 1, f, 1 - f) of fractional grid coords in [0, n-1]: the
    cell's two ends (int32) and their lerp weights."""
    i0 = torch.clamp(coords.to(torch.int32), 0, n - 2)
    f = coords - i0
    return i0, i0 + 1, f, 1 - f


def _interp_factor(coords: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Linearly interpolate factor rows at fractional grid coords.

    coords (H, W) in [0, n-1]; factor (n, ...) -> (H, W, ...). It forms the
    whole (H, W, ...) result; :func:`apply_lut_3d_cp` takes one factor
    column at a time instead.
    """
    i0, i1, f, g = _grid_index(coords, factor.shape[0])
    tail = (1,) * (factor.ndim - 1)
    f, g = f.reshape(*f.shape, *tail), g.reshape(*g.shape, *tail)
    return factor[i0.long()] * g + factor[i1.long()] * f


def _lerp_column(col: torch.Tensor, i0, i1, f, g) -> torch.Tensor:
    """col[..., i0] * (1 - f) + col[..., i1] * f along the last axis of a
    (n,) or (3, n) table column, for a flat run of pixels."""
    return col.index_select(-1, i0).mul_(g).addcmul_(col.index_select(-1, i1), f)


def apply_lut_3d_cp(
    img: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    w_bc: torch.Tensor,
    scale: float = 0.25,
) -> torch.Tensor:
    """Evaluate a CP-factored 3D LUT. img (3, H, W) -> (3, H, W) float32.

    out[c] = sum_k u_k(r) v_k(g) w_ck(b), each factor linearly interpolated
    on its n-point grid. Each channel's grid cell and weights are computed
    once per band of :data:`CP_BAND_PIXELS` pixels, and the ranks accumulate
    into the output one at a time, so the apply's temporaries are about ten
    band planes, whatever the image size and the rank.
    """
    n, rank = u.shape
    _, h, w = img.shape
    flat = img.reshape(3, h * w)
    out = torch.zeros((3, h * w), dtype=torch.float32, device=img.device)
    ut, vt = u.t().contiguous(), v.t().contiguous()  # (r, n)
    wt = w_bc.permute(2, 1, 0).contiguous()  # (r, 3, n)
    for p0 in range(0, h * w, CP_BAND_PIXELS):
        band = flat[:, p0 : p0 + CP_BAND_PIXELS]
        coords = torch.clamp(band * scale, 0.0, 1.0) * (n - 1)
        r, g, b = (_grid_index(coords[c], n) for c in range(3))
        del coords
        acc = out[:, p0 : p0 + CP_BAND_PIXELS]
        for k in range(rank):
            uv = _lerp_column(ut[k], *r).mul_(_lerp_column(vt[k], *g))
            acc.addcmul_(uv, _lerp_column(wt[k], *b))
    return out.reshape(3, h, w)
