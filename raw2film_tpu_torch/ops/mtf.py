"""Film MTF sharpness, with the grain apply fused as its epilogue.

The counterpart of ``raw2film_tpu/ops/mtf.py``: the kernel construction
(radial MTF on the FFT grid, inverse FFT, fftshift, normalise, optional
unsharp term) is the same host numpy, and the per-channel SVD stack runs as
one kernel K2 launch (``ops/sep_rank.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from raw2film_tpu_torch.ops import sep_rank
from raw2film_tpu_torch.ops.grain import grain_corr_taps
from raw2film_tpu_torch.ops.conv import svd_separable
from raw2film_tpu_torch.utils import trace

KERNEL_SIZE_MM = 0.1  # spatial support of the MTF kernel


def mtf_kernel_layer(
    logf: np.ndarray, vals: np.ndarray, scale: float, signed: bool = False
) -> np.ndarray:
    """One channel's spatial kernel from tabulated (log1p f, MTF);
    ``signed=False`` keeps the reference's np.abs() rectification."""
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


@lru_cache(maxsize=50)
def mtf_kernel(
    mtf_key,
    scale: float,
    sharpening_strength: float = 0.0,
    sharpening_sigma: float = 1.0,
    signed: bool = False,
) -> np.ndarray:
    """Stacked (3, k, k) kernel, with the optional unsharp boost
    k += strength * (k - gauss(k, sigma * scale / 50))."""
    layers = [
        mtf_kernel_layer(np.asarray(lf), np.asarray(v), scale, signed=signed)
        for lf, v in mtf_key
    ]
    if len(layers) == 1:
        layers = layers * 3
    k = np.stack(layers).astype(np.float32)
    if sharpening_strength:
        from scipy import ndimage

        sigma = sharpening_sigma * scale / 50.0
        blurred = np.stack([ndimage.gaussian_filter(ki, sigma=sigma) for ki in k])
        k = k + np.float32(sharpening_strength) * (k - blurred)
    return k


def _hashable_mtf(mtf) -> tuple:
    return tuple((tuple(map(float, lf)), tuple(map(float, v))) for lf, v in mtf)


def _svd_stack(k: np.ndarray, tol: float, max_rank: int):
    """Per-channel SVD factorization padded with zero ranks to a common rank."""
    us, vs = [], []
    rank = 0
    for c in range(3):
        u, v = svd_separable(k[c], tol=tol, max_rank=max_rank)
        us.append(u)
        vs.append(v)
        rank = max(rank, u.shape[0])
    u3 = np.zeros((3, rank, k.shape[-2]), np.float32)
    v3 = np.zeros((3, rank, k.shape[-1]), np.float32)
    for c in range(3):
        u3[c, : us[c].shape[0]] = us[c]
        v3[c, : vs[c].shape[0]] = vs[c]
    return u3, v3


@lru_cache(maxsize=50)
def mtf_taps(mtf_key, scale, sharpening_strength=0.0, sharpening_sigma=1.0, signed=False):
    """The (3, R, k) tap stacks the TPU path runs: small kernels (k <= 15)
    at tol 1e-4 / rank 6, larger ones at tol 2e-3 / rank 4 (cached,
    read-only)."""
    k = mtf_kernel(
        mtf_key, float(scale), float(sharpening_strength),
        float(sharpening_sigma), signed=signed,
    )
    tol, max_rank = (1e-4, 6) if k.shape[-1] <= 15 else (2e-3, 4)
    u3, v3 = _svd_stack(k, tol=tol, max_rank=max_rank)
    u3.setflags(write=False)
    v3.setflags(write=False)
    return u3, v3


def film_sharpness(
    img: torch.Tensor,
    mtf_key: tuple,
    scale: float,
    sharpening_strength: float = 0.0,
    sharpening_sigma: float = 1.0,
    signed: bool = False,
) -> torch.Tensor:
    """Apply the per-channel MTF kernel to a density image (3, H, W)."""
    u3, v3 = mtf_taps(mtf_key, scale, sharpening_strength, sharpening_sigma, signed)
    return sep_rank.fused_sep_rank(img, u3, v3)


def film_sharpness_grain(
    img: torch.Tensor,
    mtf_key: tuple,
    scale: float,
    sharpening_strength: float,
    sharpening_sigma: float,
    grain_seed: tuple[int, int],
    grain_sigma_px: float,
    grain_prm: torch.Tensor,
    signed: bool = False,
) -> torch.Tensor:
    """MTF sharpness with the colour-grain apply as its epilogue (the
    counterpart of ``film_sharpness_grain_from_key``). ``grain_seed`` is
    the (seed, row_off) pair of ``grain.seed2``. Where the TPU's K2 declines
    the shape (narrow frames), the JAX function returns None and the TPU
    runs the MTF on K4 and the grain on K8; the port's kernel serves every
    shape, so it keeps the epilogue and launches once. Recorded as the
    device span ``kernel.mtf_grain``."""
    with trace.stage_timer("kernel.mtf_grain", device=img):
        u3, v3 = mtf_taps(mtf_key, scale, sharpening_strength, sharpening_sigma, signed)
        return sep_rank.fused_sep_rank(
            img, u3, v3, grain=(grain_seed, grain_prm, grain_corr_taps(float(grain_sigma_px)))
        )
