"""Highlight burn: density -= strength * blur(max(green - d_ref, 0)).

The counterpart of ``raw2film_tpu/ops/burn.py`` (single-device, static
path). The blur is an area downsample by f = ceil(min(H, W) / burn_scale),
a sigma-3 Gaussian truncated at 2 sigma, and a half-pixel bilinear
upsample with edge padding.

For f > 8, :func:`burn_smallmap` returns the small blurred map and the
bilinear row and column matrices, and the print kernel K3 upsamples and
subtracts in its prologue, so the full-size glow never reaches memory.
For f <= 8 the staged :func:`burn` runs, as on the TPU. Neither runs a
kernel of its own: the small map is tiny (49 x 74 at 45 MP), and the TPU
path leaves it to XLA too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raw2film_tpu_torch.ops import conv as convops


def _factor(h: int, w: int, burn_scale: float) -> int:
    return max(1, math.ceil(min(int(h), int(w)) / burn_scale))


def _glow_mask(density: torch.Tensor, d_ref_green) -> torch.Tensor:
    return torch.clamp(density[1:2] - d_ref_green, min=0.0)


def burn_smallmap(density: torch.Tensor, d_ref_green, burn_scale: float = 50.0):
    """(small (hs, ws), rowmat (H, hs), colmat (ws, W)) float32 on the
    density's device, or None when f <= 8 (the caller runs :func:`burn`).

    The matrices reproduce the upsample to (hs*f, ws*f) followed by the edge
    pad to (H, W): rows and columns beyond the upsampled extent repeat the
    last weight row. They depend only on the shape and the factor, so they
    are built and uploaded once (``conv.device_matrix``) and shared, read
    only, by every render of that shape."""
    h, w = density.shape[-2:]
    factor = _factor(h, w, burn_scale)
    hs, ws = h // factor, w // factor
    if factor <= 8 or hs == 0 or ws == 0:
        return None
    small = convops.gaussian_blur(
        convops.box_downsample(_glow_mask(density, d_ref_green), factor), 3.0, truncate=2.0
    )[0]
    dev = density.device
    rowmat = convops.device_matrix(("burn_rows", hs, factor, h), lambda: _lerp_rows(hs, factor, h), dev)
    colmat = convops.device_matrix(("burn_cols", ws, factor, w), lambda: _lerp_rows(ws, factor, w).T, dev)
    return small.contiguous(), rowmat, colmat


def _lerp_rows(n_in: int, factor: int, n: int) -> np.ndarray:
    """(n, n_in): the x factor lerp weights of n_in inputs, the last row
    repeated (or the rows cut) to n."""
    m = convops._lerp_matrix_full(n_in, factor)
    if m.shape[0] < n:
        m = np.concatenate([m, np.repeat(m[-1:], n - m.shape[0], 0)], 0)
    return m[:n]


def burn(density: torch.Tensor, d_ref_green, highlight_burn, burn_scale: float = 50.0) -> torch.Tensor:
    """The staged burn on a (3, H, W) density image."""
    h, w = density.shape[-2:]
    factor = _factor(h, w, burn_scale)
    small = convops.box_downsample(_glow_mask(density, d_ref_green), factor)
    blurred = convops.gaussian_blur(small, 3.0, truncate=2.0)
    blur = convops.zoom_upsample(blurred, factor, (h, w))
    return torch.clamp(density - highlight_burn * blur, min=0.0)
