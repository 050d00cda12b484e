"""Highlight burn: density -= strength * blur(max(green - d_ref, 0)).

The counterpart of ``raw2film_tpu/ops/burn.py``. The blur is an area
downsample by f = ceil(min(H, W) / burn_scale), a sigma-3 Gaussian
truncated at 2 sigma, and a half-pixel bilinear upsample with edge padding.

A row shard of a larger frame (``parallel/mesh.py``'s halo path) passes
``ref_hw``, the whole frame's size, from which f is taken, and
``row_offset``, the frame row of its local row 0: its downsample cells then
lie on the frame's grid (cell boundaries at frame rows k*f), so every shard
computes the same small-map values for the same cells and no seam shifts
the glow by a cell.

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

from raw2film_tpu_torch.kernels import cache
from raw2film_tpu_torch.ops import conv as convops


def _factor(h: int, w: int, burn_scale: float) -> int:
    return max(1, math.ceil(min(int(h), int(w)) / burn_scale))


def _glow_mask(density: torch.Tensor, d_ref_green) -> torch.Tensor:
    return torch.clamp(density[1:2] - d_ref_green, min=0.0)


def _aligned_slice(mask: torch.Tensor, factor: int, row_offset: int) -> tuple:
    """The rows of a (1, H, W) shard whose box cells lie on the frame's grid:
    (the rows q .. q + hs*f, q, hs), q = (-row_offset) mod f being the local
    row of the first frame cell boundary and hs the cells that fit below it
    in the worst case, (H - (f - 1)) // f."""
    h = mask.shape[-2]
    hs = (h - (factor - 1)) // factor
    q = (-int(row_offset)) % factor
    return mask[:, q : q + hs * factor], q, hs


def _lerp_rows_dynamic(h: int, hs: int, factor: int, q: int, device) -> torch.Tensor:
    """(h, hs) half-pixel bilinear upsample weights whose cell grid starts at
    local row ``q``: the hat weights and edge clamp of
    ``conv._lerp_matrix_full``, built on ``device`` in float32 (q differs
    from shard to shard, so a cache of host-built matrices would upload one
    per render). Contiguous, as K3 takes it."""
    rel = (torch.arange(h, dtype=torch.float32, device=device) - q + 0.5) / factor - 0.5
    rel = torch.clamp(rel, 0.0, hs - 1.0)
    cells = torch.arange(hs, dtype=torch.float32, device=device)
    return torch.clamp(1.0 - torch.abs(rel[:, None] - cells[None, :]), min=0.0)


def burn_smallmap(density: torch.Tensor, d_ref_green, burn_scale: float = 50.0,
                  ref_hw: tuple | None = None, row_offset: int | None = None):
    """(small (hs, ws), rowmat (H, hs), colmat (ws, W)) float32 on the
    density's device, or None when f <= 8 or the shard holds no whole cell
    (the caller runs :func:`burn`).

    The matrices reproduce the upsample to (hs*f, ws*f) followed by the edge
    pad to (H, W): rows and columns beyond the upsampled extent repeat the
    last weight row. The column matrix, and without ``row_offset`` the row
    matrix, depend only on the shape and the factor, so they are built and
    uploaded once (``kernels/cache.py``) and shared, read only, by every
    render of that shape. With ``row_offset`` the cells are aligned to the
    frame's grid (:func:`_aligned_slice`) and the row matrix is built on the
    device (:func:`_lerp_rows_dynamic`)."""
    h, w = density.shape[-2:]
    rh, rw = ref_hw if ref_hw is not None else (h, w)
    factor = _factor(rh, rw, burn_scale)
    dev = density.device
    mask = _glow_mask(density, d_ref_green)
    if row_offset is not None and factor > 1:
        # Guard before slicing: a shard shorter than f - 1 rows has no cell.
        hs, ws = (h - (factor - 1)) // factor, w // factor
        if factor <= 8 or hs <= 0 or ws == 0:
            return None
        sliced, q, hs = _aligned_slice(mask, factor, row_offset)
        rowmat = _lerp_rows_dynamic(h, hs, factor, q, dev)
    else:
        hs, ws = h // factor, w // factor
        if factor <= 8 or hs == 0 or ws == 0:
            return None
        sliced = mask
        rowmat = cache.on_device(("burn_rows", hs, factor, h), lambda: _lerp_rows(hs, factor, h), dev)
    small = convops.gaussian_blur(convops.box_downsample(sliced, factor), 3.0, truncate=2.0)[0]
    colmat = cache.on_device(("burn_cols", ws, factor, w), lambda: _lerp_rows(ws, factor, w).T, dev)
    return small.contiguous(), rowmat, colmat


def _lerp_rows(n_in: int, factor: int, n: int) -> np.ndarray:
    """(n, n_in): the x factor lerp weights of n_in inputs, the last row
    repeated (or the rows cut) to n."""
    m = convops._lerp_matrix_full(n_in, factor)
    if m.shape[0] < n:
        m = np.concatenate([m, np.repeat(m[-1:], n - m.shape[0], 0)], 0)
    return m[:n]


def burn(density: torch.Tensor, d_ref_green, highlight_burn, burn_scale: float = 50.0,
         ref_hw: tuple | None = None, row_offset: int | None = None) -> torch.Tensor:
    """The staged burn on a (3, H, W) density image; ``ref_hw`` and
    ``row_offset`` as in :func:`burn_smallmap`. The aligned path upsamples
    by two exact float32 products (TF32 off: ``device.disable_tf32``)."""
    h, w = density.shape[-2:]
    rh, rw = ref_hw if ref_hw is not None else (h, w)
    factor = _factor(rh, rw, burn_scale)
    mask = _glow_mask(density, d_ref_green)
    if row_offset is not None and factor > 1 and (h - (factor - 1)) // factor > 0:
        sliced, q, hs = _aligned_slice(mask, factor, row_offset)
        ws = max(w // factor, 1)
        small = convops.gaussian_blur(convops.box_downsample(sliced, factor), 3.0, truncate=2.0)
        rowmat = _lerp_rows_dynamic(h, hs, factor, q, density.device)
        colmat = _lerp_rows_dynamic(w, ws, factor, 0, density.device)
        blur = torch.matmul(torch.matmul(rowmat, small), colmat.T)
    else:
        blurred = convops.gaussian_blur(convops.box_downsample(mask, factor), 3.0, truncate=2.0)
        blur = convops.zoom_upsample(blurred, factor, (h, w))
    return torch.clamp(density - highlight_burn * blur, min=0.0)
