"""Sum of separable rank-1 convolutions, with an optional grain epilogue.

The counterpart of ``raw2film_tpu/ops/pallas_conv2.py::fused_sep_rank_mxu``:
out[c] = sum_r colconv(u[c, r]) o rowconv(v[c, r]) (img[c]) with reflect-101
borders, and with ``grain`` the film-grain apply max(out + amp(out) * field,
0) on the result. On a CUDA tensor it launches kernel K2
(``csrc/sep_rank_grain.cu``); on a CPU tensor it runs
:func:`fused_sep_rank_plain`.

The taps are used in float32 exactly as given: the TPU path's bf16 "dc" tap
rescale is an artifact of its matrix unit and has no counterpart here.

The same kernel is the counterpart of K4, ``pallas_conv2.py::fused_sep_rank``:
the TPU's K2 declines narrow and short frames (:func:`tpu_declines`), and
runs K4 there (or, on still smaller ones, its XLA shift-add). The kernel here
serves every shape, so K4 needs no kernel of its own; a launch without grain
on such a shape is counted as ``sep_rank_narrow`` (K4), any other as
``sep_rank`` (K2).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import grain as grain_ops
from raw2film_tpu_torch.ops.conv import conv1d_axis


K2_CHUNK = 512  # the TPU K2's column chunk (pallas_conv2.py:581)
K2_TILE = 48  # its preferred row tile (pallas_conv2.py:571, _auto_tile)


def tpu_declines(h: int, w: int, rh: int) -> bool:
    """Whether the TPU's K2 declines an (h, w) image with column taps of
    radius ``rh`` (pallas_conv2.py:625-627): frames at most one chunk wide,
    and frames too short for its row tiling. The chunk is the generic
    entry's 512 and the row tile _auto_tile's first choice, 48 (the TPU's
    tile choosers, and the MTF's own ladder with its 256-px chunks, are not
    ported)."""
    th = min(max(K2_TILE, -(-rh // 8) * 8), -(-h // 8) * 8)
    hp = -(-h // th) * th
    return rh > th or h <= 2 * th + 1 or hp - h + th >= h or w <= K2_CHUNK


def _ranks(taps) -> np.ndarray:
    """An (R, k) or (C, R, k) array as float32; a list of shared 1-D rank
    rows of any odd lengths as (R, k), each shorter row zero-padded
    symmetrically to the longest. The centre stays put and a zero tap adds
    an exact 0, so the padding leaves the result unchanged."""
    if isinstance(taps, np.ndarray) or np.ndim(taps[0]) != 1:
        return np.asarray(taps, np.float32)
    rows = [np.asarray(r, np.float32).ravel() for r in taps]
    if any(len(r) % 2 == 0 for r in rows):
        raise ValueError("taps: lengths must be odd")
    n = max(len(r) for r in rows)
    return np.stack([np.pad(r, (n - len(r)) // 2) for r in rows])


def _stack(u, v):
    """(Cb, R, k) float32 column and row tap stacks; Cb = 1 when shared."""
    u = _ranks(u)
    v = _ranks(v)
    if u.ndim == 2:
        u, v = u[None], v[None]
    if u.ndim != 3 or v.ndim != 3 or u.shape[:2] != v.shape[:2]:
        raise ValueError(f"taps: want (R, k) or (C, R, k), got {u.shape}, {v.shape}")
    if u.shape[-1] % 2 == 0 or v.shape[-1] % 2 == 0:
        raise ValueError("taps: lengths must be odd")
    return u, v


def fused_sep_rank_plain(img: torch.Tensor, u, v, grain=None) -> torch.Tensor:
    """Plain version of K2. ``grain``: (seed pair, prm f32[6] tensor, taps)."""
    u3, v3 = _stack(u, v)
    per_channel = u3.shape[0] > 1
    out = None
    for r in range(u3.shape[1]):
        ku = u3[:, r] if per_channel else u3[0, r]
        kv = v3[:, r] if per_channel else v3[0, r]
        term = conv1d_axis(conv1d_axis(img, ku, -2), kv, -1)
        out = term if out is None else out + term
    if grain is not None:
        (seed, row_off), prm, taps = grain
        field = grain_ops.grain_field_hash(seed, img.shape[-2:], taps, row_off, img.device)
        out = torch.clamp(out + grain_ops.grain_amplitude(out, prm) * field, min=0.0)
    return out


def fused_sep_rank(img: torch.Tensor, u, v, grain=None) -> torch.Tensor:
    """K2 wrapper. img (C, H, W) float32; u, v numpy (R, k) shared or
    (C, R, k) per channel, or lists of shared rank rows of odd, possibly
    different lengths; grain = ((seed, row_off), prm, taps) or None."""
    if not kb.use_kernel(img):
        return fused_sep_rank_plain(img, u, v, grain)
    kb.require(img, "img", torch.float32)
    if img.dim() != 3:
        raise ValueError(f"img: want (C, H, W), got {tuple(img.shape)}")
    c, h, w = img.shape
    u3, v3 = _stack(u, v)
    cb = u3.shape[0]
    if cb not in (1, c):
        raise ValueError(f"taps for {cb} channels, image has {c}")
    nonzero = np.any(u3 != 0, axis=2) & np.any(v3 != 0, axis=2)  # (Cb, R)
    nrank = np.array(
        [int(np.nonzero(row)[0].max()) + 1 if row.any() else 0 for row in nonzero],
        np.int32,
    )
    taps = torch.as_tensor(np.concatenate([u3, v3], axis=2), device=img.device)
    nrank_t = torch.as_tensor(nrank, device=img.device)
    out = torch.empty_like(img)
    seed = row_off = 0
    prm_ptr = None
    gtaps, n_gtaps = None, 0
    if grain is not None:
        (seed, row_off), prm, gt = grain
        if len(gt) > grain_ops.MAX_TAPS:
            raise ValueError(f"grain: {len(gt)} taps, the kernel takes {grain_ops.MAX_TAPS}")
        prm = prm.to(device=img.device, dtype=torch.float32).contiguous()
        kb.require(prm, "grain prm", torch.float32, (6,))
        prm_ptr = prm.data_ptr()
        n_gtaps = len(gt)
        gtaps = (ctypes.c_float * n_gtaps)(*[float(t) for t in gt])
    err = kb.lib().r2f_sep_rank(
        img.data_ptr(), out.data_ptr(), c, h, w, taps.data_ptr(), nrank_t.data_ptr(),
        int(cb > 1), u3.shape[1], u3.shape[2], v3.shape[2], int(grain is not None),
        seed, row_off, prm_ptr,
        ctypes.cast(gtaps, ctypes.c_void_p) if gtaps is not None else None,
        n_gtaps, kb.stream_ptr(img),
    )
    kb.check(err, "r2f_sep_rank")
    narrow = grain is None and tpu_declines(h, w, u3.shape[2] // 2)
    kb.launches["sep_rank_narrow" if narrow else "sep_rank"] += 1
    return out


def hash_words_kernel(h: int, w: int, x0: int, y0: int, ch: int, seed: int,
                      row_off: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The K2 epilogue's PCG-3D words on an (h, w) grid, from the kernel
    library's test hook, as int64 tensors holding uint32 values (compare
    with :func:`raw2film_tpu_torch.ops.grain.hash_words`)."""
    a = torch.empty((h, w), dtype=torch.int32, device=device)
    b = torch.empty_like(a)
    seed, row_off = grain_ops.seed2(seed, row_off)
    err = kb.lib().r2f_hash_words(
        a.data_ptr(), b.data_ptr(), h, w, x0, y0, ch, seed, row_off,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    kb.check(err, "r2f_hash_words")
    mask = grain_ops.M32
    return a.to(torch.int64) & mask, b.to(torch.int64) & mask
