"""The plain reference of the port's render: a CFA mosaic -> uint8 film print.

Plain PyTorch over float32 planes, written for this benchmark from the
program's plain versions as they stood when the benchmark was added (K1's
demosaic with the input matrix; the halation mixture tier: /4 box mean,
pyramid Gaussians, x4 row lerp, full-res ranks, column lerp, combine and
development; the MTF ranks with the colour-grain hash; the highlight burn's
small map; the print and encode). It imports nothing of the program: the
film parameters come from the frozen film science in ``portbench/ref/film``,
the taps from the constructions copied below, and the grain from the same
positional hash.

``Ref(tf32=True)`` is the control: every product of a convolution or a
matrix product takes its operands rounded to TF32 (10 mantissa bits, round
to nearest even) and accumulates in float32, as tensor cores in TF32 mode
do. Everything else is unchanged.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

LOG10_EPS = 1e-6
LOG2_10 = float(np.float32(np.log2(10.0)))
LOG10_2 = float(np.float32(np.log10(2.0)))
LOG2_E = float(np.float32(np.log2(np.e)))
LN_2 = float(np.float32(np.log(2.0)))
M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
PYR_F = 4
INNER_RADIUS = 5
PYRAMID_SIGMA = 8.0
KERNEL_SIZE_MM = 0.1
BAYER = {"RGGB": (0, 0), "BGGR": (1, 1), "GRBG": (0, 1), "GBRG": (1, 0)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties to
    even), held in float32."""
    b = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((b >> 13) & 1)
    return ((b + bias) & ~0x1FFF).view(torch.float32)


# ------------------------------------------------------------ elementwise


def log10(x):
    return torch.log2(x) * LOG10_2


def pow10(x):
    return torch.exp2(x * LOG2_10)


def softplus(u, w):
    if isinstance(w, float):
        w32 = np.float32(w)
        w, inv = float(w32), float(np.float32(1.0) / w32)
    else:
        inv = 1.0 / w
    t = u * inv
    return w * (torch.clamp(t, min=0.0) + LN_2 * torch.log2(1.0 + torch.exp2(-torch.abs(t) * LOG2_E)))


def powc(x, p: float):
    return torch.exp2(torch.log2(torch.clamp(x, min=1e-30)) * float(np.float32(p)))


def encode(x, key: str):
    """The display encode the configurations state (sRGB), on [0, 1]."""
    if key not in ("sRGB", "Display P3"):
        raise ValueError(f"gamma {key!r} is not in the reference")
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        x <= float(np.float32(0.0031308)),
        x * float(np.float32(12.92)),
        float(np.float32(1.055)) * powc(x, 1.0 / 2.4) - float(np.float32(0.055)),
    )


# ------------------------------------------------------------ host taps


def svd_separable(kernel, tol: float = 1e-4, max_rank: int = 6):
    u, s, vt = np.linalg.svd(np.asarray(kernel, np.float64))
    keep = min(max(1, int(np.sum(s > tol * s[0]))), max_rank)
    scale = np.sqrt(s[:keep])
    return (u[:, :keep] * scale).T.astype(np.float32), (vt[:keep] * scale[:, None]).astype(np.float32)


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def exponential_blur_kernel(size: float) -> np.ndarray:
    radius = size / 2.0
    n = 2 * int(np.floor(np.ceil(size) / 2)) + 1
    center = np.ceil(n / 2.0)
    ii = np.arange(1, n + 1, dtype=np.float64)
    di = (ii - center) ** 2
    dist = di[:, None] + di[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.where(dist == 0.0, 1.0, (1.0 / dist) * np.maximum((radius - np.sqrt(dist)) / radius, 0.0))
    return k / k.sum()


@lru_cache(maxsize=8)
def gaussian_mixture(size: float, n_terms: int = 5):
    """The halation kernel as an 11 x 11 dense core plus a least-squares sum
    of Gaussians fitted to its tail: (sigmas, weights, core)."""
    k = exponential_blur_kernel(size)
    n = k.shape[0]
    c = n // 2
    yy, xx = np.mgrid[0:n, 0:n]
    r2 = (yy - c) ** 2.0 + (xx - c) ** 2.0
    radius = max(size / 2.0, 1.0)
    sigmas = np.geomspace(max(1.2, radius / 30.0), radius / 1.7, n_terms)
    basis = np.stack([np.exp(-0.5 * r2 / s**2) / (2 * np.pi * s**2) for s in sigmas], axis=-1)
    a = basis.reshape(-1, n_terms)
    outer = (r2 > INNER_RADIUS**2).ravel()
    w, *_ = np.linalg.lstsq(a[outer], k.ravel()[outer], rcond=None)
    w = np.maximum(w, 0.0)
    recon = (a @ w).reshape(n, n)
    inner = np.zeros((2 * INNER_RADIUS + 1,) * 2, np.float64)
    lo_src, hi_src = max(c - INNER_RADIUS, 0), min(c + INNER_RADIUS + 1, n)
    lo_dst = lo_src - (c - INNER_RADIUS)
    patch = (k - recon)[lo_src:hi_src, lo_src:hi_src]
    inner[lo_dst : lo_dst + patch.shape[0], lo_dst : lo_dst + patch.shape[1]] = patch
    return tuple(float(s) for s in sigmas), tuple(float(x) for x in w), inner.astype(np.float32)


@lru_cache(maxsize=8)
def halation_taps(size: float):
    """(us, vs, by_factor): the full-res ranks (core plus the Gaussians up to
    sigma 8, SVD at tol 3e-3, rank <= 5) and the pyramid terms by factor."""
    sigmas, weights, inner = gaussian_mixture(size)
    full, by_factor = [], {}
    for s, w in zip(sigmas, weights):
        if w <= 1e-6:
            continue
        if s <= PYRAMID_SIGMA:
            full.append((s, w))
        else:
            by_factor.setdefault(4 if s <= 48.0 else 8, []).append((s, w))
    rad = INNER_RADIUS
    for s, _ in full:
        rad = max(rad, int(3.0 * s + 0.5))
    n = 2 * rad + 1
    comb = np.zeros((n, n), np.float64)
    ir = inner.shape[0] // 2
    comb[rad - ir : rad + ir + 1, rad - ir : rad + ir + 1] += inner
    for s, w in full:
        g = gaussian_kernel1d(s, truncate=3.0).astype(np.float64)
        r1 = len(g) // 2
        comb[rad - r1 : rad + r1 + 1, rad - r1 : rad + r1 + 1] += w * np.outer(g, g)
    us, vs = svd_separable(comb, tol=3e-3, max_rank=5)
    return us, vs, by_factor


def pyramid_taps(f: int, terms):
    su = [w * gaussian_kernel1d(s / f, truncate=3.0) for s, w in terms]
    sv = [gaussian_kernel1d(s / f, truncate=3.0) for s, _ in terms]
    return pad_ranks(su), pad_ranks(sv)


def pad_ranks(rows) -> np.ndarray:
    """Shared rank rows of odd lengths -> (R, k), zero-padded about the centre."""
    rows = [np.asarray(r, np.float32).ravel() for r in rows]
    n = max(len(r) for r in rows)
    return np.stack([np.pad(r, (n - len(r)) // 2) for r in rows])


def mtf_layer(logf, vals, scale: float, signed: bool) -> np.ndarray:
    pixel_size_mm = 1.0 / scale
    n = round(KERNEL_SIZE_MM / pixel_size_mm)
    if n % 2 == 0:
        n += 1
    n = max(n, 3)
    fx = np.fft.fftfreq(n, d=pixel_size_mm)
    f = np.sqrt(fx[:, None] ** 2 + fx[None, :] ** 2)
    h = np.interp(np.log1p(f), logf, vals, left=1.0, right=0.0)
    ks = np.fft.ifft2(h).real
    k = np.fft.fftshift(ks if signed else np.abs(ks))
    return (k / k.sum()).astype(np.float32)


def mtf_taps(mtf, scale: float, signed: bool = False):
    """(3, R, k) column and row stacks of the stock's MTF kernels: SVD per
    channel (tol 1e-4 and rank 6 up to 15 taps, else 2e-3 and rank 4), zero
    ranks padding each channel to a common rank. No unsharp term: the
    configurations leave ``sharpening_strength`` at 0."""
    layers = [mtf_layer(np.asarray(lf), np.asarray(v), scale, signed) for lf, v in mtf]
    if len(layers) == 1:
        layers = layers * 3
    k = np.stack(layers).astype(np.float32)
    tol, max_rank = (1e-4, 6) if k.shape[-1] <= 15 else (2e-3, 4)
    pairs = [svd_separable(k[c], tol=tol, max_rank=max_rank) for c in range(3)]
    rank = max(u.shape[0] for u, _ in pairs)
    u3 = np.zeros((3, rank, k.shape[-2]), np.float32)
    v3 = np.zeros((3, rank, k.shape[-1]), np.float32)
    for c, (u, v) in enumerate(pairs):
        u3[c, : u.shape[0]] = u
        v3[c, : v.shape[0]] = v
    return u3, v3


def grain_taps(sigma_px: float) -> list[float]:
    if sigma_px >= 0.3:
        k = gaussian_kernel1d(sigma_px, truncate=2.5).astype(np.float64)
        k = k / np.linalg.norm(k)
    else:
        k = np.ones(1, np.float64)
    return [float(np.float32(t)) for t in k]


def lerp_matrix(n_in: int, f: int) -> np.ndarray:
    """(n_in*f, n_in) half-pixel bilinear weights with edge clamp."""
    m = np.zeros((n_in * f, n_in), np.float32)
    for o in range(n_in * f):
        rel = (o + 0.5) / f - 0.5
        base = int(np.floor(rel))
        frac = rel - base
        m[o, min(max(base, 0), n_in - 1)] += 1.0 - frac
        m[o, min(max(base + 1, 0), n_in - 1)] += frac
    return m


def lerp_taps(n_in: int, f: int, n_out: int):
    o = np.arange(n_out, dtype=np.float64)
    rel = (o + 0.5) / f - 0.5
    base = np.floor(rel)
    frac = rel - base
    i0 = np.clip(base, 0, n_in - 1).astype(np.int64)
    i1 = np.clip(base + 1, 0, n_in - 1).astype(np.int64)
    w0 = (1.0 - frac).astype(np.float32)
    w1 = frac.astype(np.float32)
    same = i0 == i1
    w0[same] = w0[same] + w1[same]
    w1[same] = 0.0
    return i0, i1, w0, w1


def mean_matrix(n2: int, f: int) -> np.ndarray:
    m = np.zeros((n2, n2 * f), np.float32)
    for i in range(n2):
        m[i, i * f : (i + 1) * f] = 1.0 / f
    return m


def lerp_rows(n_in: int, factor: int, n: int) -> np.ndarray:
    m = lerp_matrix(n_in, factor)
    if m.shape[0] < n:
        m = np.concatenate([m, np.repeat(m[-1:], n - m.shape[0], 0)], 0)
    return m[:n]


# ------------------------------------------------------------ grain hash


def _mul32(a, b):
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & M32


def _pcg3d(x, y, z):
    v0 = (_mul32(x, 1664525) + 1013904223) & M32
    v1 = (_mul32(y, 1664525) + 1013904223) & M32
    v2 = (_mul32(z, 1664525) + 1013904223) & M32
    v0 = (v0 + _mul32(v1, v2)) & M32
    v1 = (v1 + _mul32(v2, v0)) & M32
    v2 = (v2 + _mul32(v0, v1)) & M32
    v0, v1, v2 = v0 ^ (v0 >> 16), v1 ^ (v1 >> 16), v2 ^ (v2 >> 16)
    v0 = (v0 + _mul32(v1, v2)) & M32
    v1 = (v1 + _mul32(v2, v0)) & M32
    return v0, v1


def _popcount(v):
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def grain_noise(h: int, w: int, ch: int, seed: int, row_off: int, device) -> torch.Tensor:
    """Binomial unit normals at (x, y + row_off) of channel ``ch``, the hash
    salted with ch * 0x9E3779B9 + seed."""
    y = ((torch.arange(h, device=device, dtype=torch.int64) + row_off) & M32)[:, None].expand(h, w)
    x = (torch.arange(w, device=device, dtype=torch.int64) & M32)[None, :].expand(h, w)
    z = torch.full((h, w), (ch * GOLDEN + seed) & M32, device=device, dtype=torch.int64)
    a, b = _pcg3d(x, y, z)
    return ((_popcount(a) + _popcount(b)).to(torch.float32) - 32.0) * 0.25


# ------------------------------------------------------------ the chain


class Ref:
    """The reference render. ``tf32``: the control (see the module doc)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _q(self, x):
        return round_tf32(x) if self.tf32 else x

    def matmul(self, a, b):
        return torch.matmul(self._q(a), self._q(b))

    def conv1d(self, img, k, axis: int):
        """Shift-and-add correlation along H (-2) or W (-1), reflect-101,
        taps (k,) shared or (C, k) per channel, summed in tap order."""
        k = np.asarray(k, np.float32)
        per_channel = k.ndim == 2
        taps = k.shape[-1]
        r = taps // 2
        h, w = img.shape[-2:]
        p = reflect_pad(img, r, 0) if axis == -2 else reflect_pad(img, 0, r)
        p = self._q(p)
        out = None
        for i in range(taps):
            if per_channel:
                coef = self._q(torch.tensor(k[:, i], device=img.device)).reshape(-1, 1, 1)
            else:
                if k[i] == 0.0:
                    continue
                coef = float(self._q(torch.tensor(k[i])).item())
            src = p[..., i : i + h, :] if axis == -2 else p[..., :, i : i + w]
            term = coef * src
            out = term if out is None else out + term
        return out if out is not None else torch.zeros_like(img)

    def sep_rank(self, img, u, v):
        """Sum over ranks of the column then row correlation; (R, k) shared
        or (C, R, k) per channel."""
        u, v = np.asarray(u, np.float32), np.asarray(v, np.float32)
        out = None
        for r in range(u.shape[-2]):
            term = self.conv1d(self.conv1d(img, u[..., r, :], -2), v[..., r, :], -1)
            out = term if out is None else out + term
        return out

    def grain_field(self, seed: int, hw, taps, row_off: int, device) -> torch.Tensor:
        h, w = hw
        n = len(taps)
        qt = [float(self._q(torch.tensor(t)).item()) for t in taps]
        out = []
        for ch in range(3):
            noise = self._q(grain_noise(h + n - 1, w + n - 1, ch, seed, row_off, device))
            col = None
            for q in range(n):
                term = qt[q] * noise[q : q + h, :]
                col = term if col is None else col + term
            col = self._q(col)
            field = None
            for q in range(n):
                term = qt[q] * col[:, q : q + w]
                field = term if field is None else field + term
            out.append(field)
        return torch.stack(out)

    # -------------------------------------------------------- stages

    def demosaic(self, bayer, pattern: str, mat, norm):
        """K1 with the input matrix: max(mat @ clip01(MHC(normalized)), 0)."""
        ry, rx = BAYER[pattern]
        black, inv_range = (float(v) for v in np.asarray(norm, np.float32).reshape(2))
        x = torch.clamp((bayer.to(torch.float32) - black) * inv_range, 0.0, 1.0)
        h, w = x.shape
        p = reflect_pad(x, 2, 2)

        def sh(dy, dx):
            return p[dy : dy + h, dx : dx + w]

        m = sh(2, 2)
        h1, v1 = sh(2, 1) + sh(2, 3), sh(1, 2) + sh(3, 2)
        h2, v2 = sh(2, 0) + sh(2, 4), sh(0, 2) + sh(4, 2)
        dg = (sh(1, 1) + sh(1, 3)) + (sh(3, 1) + sh(3, 3))
        e = 0.125
        hv2 = h2 + v2
        t_g = e * (4.0 * m + 2.0 * (h1 + v1) - hv2)
        t_row = e * (5.0 * m + 4.0 * h1 - dg - h2 + 0.5 * v2)
        t_col = e * (5.0 * m + 4.0 * v1 - dg - v2 + 0.5 * h2)
        t_opp = e * (6.0 * m + 2.0 * dg - 1.5 * hv2)
        yy = (torch.arange(h, device=x.device) & 1)[:, None]
        xx = (torch.arange(w, device=x.device) & 1)[None, :]
        is_r, is_b = (yy == ry) & (xx == rx), (yy == 1 - ry) & (xx == 1 - rx)
        g_r_row, g_b_row = (yy == ry) & (xx == 1 - rx), (yy == 1 - ry) & (xx == rx)
        r = torch.where(is_r, m, torch.where(g_r_row, t_row, torch.where(g_b_row, t_col, t_opp)))
        g = torch.where(is_r | is_b, t_g, m)
        b = torch.where(is_b, m, torch.where(g_b_row, t_row, torch.where(g_r_row, t_col, t_opp)))
        del p, h1, v1, h2, v2, dg, hv2, t_g, t_row, t_col, t_opp
        mt = [float(v) for v in self._q(torch.tensor(np.asarray(mat, np.float32).reshape(9)))]
        r, g, b = (self._q(torch.clamp(q, 0.0, 1.0)) for q in (r, g, b))
        return torch.stack(
            [torch.clamp(mt[3 * c] * r + mt[3 * c + 1] * g + mt[3 * c + 2] * b, min=0.0) for c in range(3)]
        )

    def halation_developed(self, img, scale: float, size_factor: float, factors, develop):
        """The /4 mixture tier with identity masking: the glow, the combine
        (img + f blur) / (1 + f), and the development to density."""
        size = scale / 4.0 * size_factor
        h, w = img.shape[-2:]
        us, vs, by_factor = halation_taps(size)
        if size <= 40.0 or h % PYR_F or w % PYR_F or list(by_factor) != [PYR_F]:
            raise ValueError(f"halation size {size} on {h}x{w}: not the /4 mixture tier")
        c = img.shape[0]
        small = img.reshape(c, h // PYR_F, PYR_F, w // PYR_F, PYR_F).sum(dim=2).sum(dim=-1)
        small = small * float(np.float32(1.0 / (PYR_F * PYR_F)))
        small_blur = self.sep_rank(small, *pyramid_taps(PYR_F, by_factor[PYR_F]))
        uh = torch.tensor(lerp_matrix(small_blur.shape[-2], PYR_F)[:h], device=img.device)
        rows_up = self.matmul(uh, small_blur)
        del small, small_blur, uh
        i0, i1, w0, w1 = (torch.tensor(a, device=img.device) for a in lerp_taps(rows_up.shape[-1], PYR_F, w))
        blur = self.sep_rank(img, us, vs)
        blur = blur + (rows_up.index_select(-1, i0) * w0 + rows_up.index_select(-1, i1) * w1)
        del rows_up
        f = factors.reshape(-1, 1, 1)
        out = (img + f * blur) * (1.0 / (1.0 + f))
        del blur
        dv = develop.reshape(19)
        planes = []
        for ch in range(out.shape[0]):
            flare, dmin, gam, x_t, x_s, w_t, w_s = dv[0], *(dv[1 + 3 * i + ch] for i in range(6))
            lx = log10(torch.clamp(out[ch] + flare, min=LOG10_EPS))
            planes.append(dmin + gam * (softplus(lx - x_t, w_t) - softplus(lx - x_s, w_s)))
        return torch.stack(planes)

    def mtf_grain(self, d, mtf, scale: float, seed: int, sigma_px: float, prm, signed: bool = False):
        u3, v3 = mtf_taps(mtf, scale, signed)
        out = self.sep_rank(d, u3, v3)
        field = self.grain_field(seed & M32, d.shape[-2:], grain_taps(float(sigma_px)), 0, d.device)
        return torch.clamp(out + grain_amplitude(out, prm) * field, min=0.0)

    def burn_smallmap(self, d, d_ref_green, burn_scale: float):
        """(small, rowmat, colmat) of the highlight burn, where its factor
        is above 8 (the configurations' frames)."""
        h, w = d.shape[-2:]
        factor = max(1, math.ceil(min(h, w) / burn_scale))
        hs, ws = h // factor, w // factor
        if factor <= 8 or hs == 0 or ws == 0:
            raise ValueError(f"burn factor {factor} on {h}x{w}: not the small-map path")
        mask = torch.clamp(d[1:2] - d_ref_green, min=0.0)
        dh = torch.tensor(mean_matrix(hs, factor), device=d.device)
        dw = torch.tensor(np.ascontiguousarray(mean_matrix(ws, factor).T), device=d.device)
        small = self.matmul(self.matmul(dh, mask[:, : hs * factor, : ws * factor]), dw)
        k = gaussian_kernel1d(3.0, truncate=2.0)
        small = self.sep_rank(small, k[None], k[None])[0]
        rowmat = torch.tensor(lerp_rows(hs, factor, h), device=d.device)
        colmat = torch.tensor(np.ascontiguousarray(lerp_rows(ws, factor, w).T), device=d.device)
        return small, rowmat, colmat

    def print_encode(self, d, pvec, mode: str, shadow: bool, sat_neutral: bool, gamma: str, burn=None):
        P = torch.as_tensor(pvec, device=d.device)
        Q = self._q(P)  # the 3x3 matrices' coefficients, as their products take them
        dp = (d[0], d[1], d[2])
        if burn is not None:
            small, rowmat, colmat = burn
            up = self.matmul(self.matmul(rowmat, small), colmat)
            dp = tuple(torch.clamp(q - P[60] * up, min=0.0) for q in dp)
        if mode == "print":
            d_pp = []
            dq = [self._q(q) for q in dp]
            for c in range(3):
                log_e = P[9 + c] - (Q[3 * c] * dq[0] + Q[3 * c + 1] * dq[1] + Q[3 * c + 2] * dq[2])
                d_pp.append(
                    P[12 + c] + P[15 + c] * (softplus(log_e - P[18 + c], P[24 + c]) - softplus(log_e - P[21 + c], P[27 + c]))
                )
        else:
            d_pp = [dp[c] - P[30 + c] for c in range(3)]
        d_pp = [self._q(q) for q in d_pp]
        vd = [Q[33 + 3 * c] * d_pp[0] + Q[34 + 3 * c] * d_pp[1] + Q[35 + 3 * c] * d_pp[2] for c in range(3)]
        if shadow:
            vd = [q - P[42] * softplus(q - P[43], 0.35) for q in vd]
        lin = [self._q(pow10(-(vd[c] + P[44 + c]))) for c in range(3)]
        rgb = [(Q[47 + 3 * c] * lin[0] + Q[48 + 3 * c] * lin[1] + Q[49 + 3 * c] * lin[2]) * P[56 + c] for c in range(3)]
        if not sat_neutral:
            luma = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
            rgb = [luma + P[59] * (q - luma) for q in rgb]
        out = torch.stack([encode(q, gamma) for q in rgb])
        return torch.round(out * 255.0).to(torch.uint8)

    def develop(self, ep, film):
        """Development with the film's masking, without halation (plain)."""
        neg = film["neg_curve"]
        dmin = film["d_min"].reshape(3)
        planes = []
        for c in range(3):
            x = log10(torch.clamp(ep[c] + film["flare"], min=LOG10_EPS))
            d_min, gamma, x_toe, x_sh, w_t, w_s = (t.reshape(3)[c] for t in neg)
            planes.append(d_min + gamma * (softplus(x - x_toe, w_t) - softplus(x - x_sh, w_s)) - dmin[c])
        m = self._q(film["mask"])
        planes = [self._q(q) for q in planes]
        return torch.stack(
            [m[i, 0] * planes[0] + m[i, 1] * planes[1] + m[i, 2] * planes[2] + dmin[i] for i in range(3)]
        )

    # -------------------------------------------------------- whole render

    def render_mosaic(self, mosaic, cam_to_xyz, gain, norm, pattern: str, film: dict, look: dict, seed: int):
        """(H, W) uint16 mosaic -> (3, H, W) uint8, as the fused path renders
        it: the camera matrix and the exposure gain folded into the input
        matrix on the host in float32."""
        mat = np.matmul(np.asarray(film["m_in"].cpu(), np.float32),
                        np.asarray(cam_to_xyz, np.float32) * np.float32(gain))
        ep = self.demosaic(mosaic, pattern, mat, norm)
        return self.render_exposure(ep, film, look, seed)

    def render_exposure(self, ep, film: dict, look: dict, seed: int):
        """The chain after the input transform, for the looks the
        configurations state."""
        scale = look["scale"]
        if look["halation"]:
            g = film["hal_green"]
            factors = film["hal_intensity"] * torch.stack([torch.ones_like(g), g, torch.zeros_like(g)])
            develop = torch.cat([film["flare"].reshape(1)] + [c.reshape(3) for c in film["neg_curve"]])
            d = self.halation_developed(ep, scale, look["halation_size"], factors, develop)
        else:
            d = self.develop(ep, film)
        del ep
        grain_on = look["grain"] == 2
        if look["sharpness"] and grain_on:
            prm = grain_params(film["grain_rms"], film["grain_shape"], scale)
            sigma_px = look["grain_size_mm"] * scale * look["grain_sigma"]
            d = self.mtf_grain(d, look["mtf"], scale, seed, sigma_px, prm, look["mtf_signed"])
        elif look["sharpness"] or look["grain"]:
            raise ValueError("the reference renders MTF with colour grain, or neither")
        burn = None
        if look["highlight_burn"]:
            burn = self.burn_smallmap(d, film["d_ref_green"], look["burn_scale"])
        return self.print_encode(d, film["pvec"], look["print_mode"], look["shadow_comp"],
                                 look["sat_neutral"], look["gamma_func"], burn=burn)


def reflect_pad(img, ph: int, pw: int):
    """Reflect-101 pad of the last two axes (the pad shorter than the axis)."""
    h, w = img.shape[-2:]
    if ph:
        i = torch.arange(-ph, h + ph, device=img.device).abs()
        img = img.index_select(-2, torch.where(i >= h, 2 * (h - 1) - i, i))
    if pw:
        i = torch.arange(-pw, w + pw, device=img.device).abs()
        img = img.index_select(-1, torch.where(i >= w, 2 * (w - 1) - i, i))
    return img


def grain_params(grain_rms, grain_shape, scale: float) -> torch.Tensor:
    peak, width, floor, d_lo, d_hi = (grain_shape[i] for i in range(5))
    rng = torch.clamp(d_hi - d_lo, min=1e-3)
    pixel_um = 1000.0 / scale
    rms_eff = (grain_rms / 1000.0) * (48.0 / pixel_um)
    return torch.stack(
        [torch.as_tensor(p, dtype=torch.float32).reshape(())
         for p in (rms_eff, floor, peak / rng * 0.5, 1.0 / (width * 0.35), d_lo, 1.0 / rng)]
    )


def grain_amplitude(d, prm):
    rms, floor, peak_half, inv_width, lo, inv_rng = (prm[i] for i in range(6))
    e = ((d - lo) * inv_rng - peak_half - 0.25) * inv_width
    return rms * (floor + (1.0 - floor) * torch.exp2(-0.5 * (e * e) * LOG2_E))
