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

The taps reach the kernel by value: :func:`pack` lays a stack out as the
``r2f::sep::Ranks`` struct of ``csrc/sep_rank.cuh``, once per distinct
stack, kept by the taps' contents (``kernels/cache.py``), and a launch
passes a pointer to it, so no launch copies anything to the device. The
kernel runs every rank's taps in chunks of :data:`CK`: :func:`pack`
zero-pads each rank about its centre to a multiple of CK from its true
length (the span of its nonzero taps), and gives it its own chunk counts
and window offsets (:func:`chunk_axis`). A
stack above the struct's :data:`MAX_TAPS` floats is uploaded once to a
device buffer, kept there the same way.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.kernels import cache
from raw2film_tpu_torch.ops import grain as grain_ops
from raw2film_tpu_torch.ops.conv import conv1d_axis
from raw2film_tpu_torch.utils import trace


K2_CHUNK = 512  # the TPU K2's column chunk (pallas_conv2.py:581)
K2_TILE = 48  # its preferred row tile (pallas_conv2.py:571, _auto_tile)
# r2f::sep (csrc/sep_rank.cuh): the tile, the taps per chunk, per-channel
# stacks of at most 4 channels and 16 ranks, floats of taps passed by value
# (a stack of at most SMALL_TAPS launches with a struct cut to that size)
TH, TW = 32, 128
CK = 8
MAX_C = 4
MAX_R = 16
MAX_TAPS = 2048
SMALL_TAPS = 128


class Rank(ctypes.Structure):
    """``r2f::sep::Rank``: a rank's column-tap chunks and the window row of
    its first tap, its row-tap chunks and the window column of its first
    tap."""

    _fields_ = [("nv", ctypes.c_int), ("ov", ctypes.c_int), ("nh", ctypes.c_int), ("oh", ctypes.c_int)]


class Ranks(ctypes.Structure):
    """``r2f::sep::Ranks`` (csrc/sep_rank.cuh): the image shape, the window
    and the chunked rank stack of one launch."""

    _fields_ = [
        ("C", ctypes.c_int),
        ("H", ctypes.c_int),
        ("W", ctypes.c_int),
        ("per_channel", ctypes.c_int),
        ("R", ctypes.c_int),
        ("stride", ctypes.c_int),
        ("top", ctypes.c_int),
        ("left", ctypes.c_int),
        ("EH", ctypes.c_int),
        ("EW", ctypes.c_int),
        ("nrank", ctypes.c_int * MAX_C),
        ("rank", Rank * MAX_R),
        ("taps", ctypes.c_float * MAX_TAPS),
    ]


class GrainArgs(ctypes.Structure):
    """``r2f::grain::Args`` (csrc/grain.cuh): the seed pair and the
    correlation taps of the grain epilogue."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("row_off", ctypes.c_uint32),
        ("ntaps", ctypes.c_int),
        ("taps", ctypes.c_float * grain_ops.MAX_TAPS),
    ]


@dataclass(frozen=True)
class Packed:
    """A rank stack as the kernel reads it: ``taps`` (Cb, stride) float32,
    per rank its chunk-padded column taps then its row taps; ``nrank`` (Cb,)
    the ranks run per channel; ``args`` the by-value struct, its taps filled
    only when ``by_value``, and ``args_ptr`` its address; ``narrow``:
    whether the TPU's K2 declines this stack on the image shape it was
    packed for; ``key`` the key of its device buffer, the same for every
    image shape."""

    taps: np.ndarray
    nrank: np.ndarray
    args: Ranks
    args_ptr: int
    by_value: bool
    narrow: bool
    key: Any


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


def stack_taps(u, v):
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


def true_radius(t: np.ndarray) -> np.ndarray:
    """(R,) the radius about the centre of each rank's nonzero taps, over
    every channel of a (Cb, R, k) stack (0 for an all-zero rank): the true
    length of a rank zero-padded to a longer neighbour is 2 radius + 1."""
    k = t.shape[-1]
    dist = np.abs(np.arange(k) - k // 2)
    live = np.any(t != 0, axis=0)  # (R, k)
    return np.array([int(dist[row].max()) if row.any() else 0 for row in live], np.int64)


def chunk_axis(t: np.ndarray, ck: int = CK):
    """One axis of a (Cb, R, k) stack in chunks of ``ck`` taps. Rank r, of
    true radius rad, runs n[r] = ceil((2 rad + 1) / ck) chunks: its true
    taps with (n ck - 2 rad - 1) // 2 zeros before them and the rest after.
    Returns (n, off, padded, before, after): ``padded[r]`` its (Cb, n[r] ck)
    taps; the window reaches ``before`` positions before the output and
    ``after`` past it; ``off[r]`` is the window position of the rank's first
    tap for output 0 (the window starting ``before`` positions early)."""
    rad = true_radius(t)
    centre = t.shape[-1] // 2
    n = -(-(2 * rad + 1) // ck)
    pad = (n * ck - 2 * rad - 1) // 2
    lo = rad + pad  # reach before the output
    hi = n * ck - 1 - lo  # and after it
    before, after = int(lo.max()), int(hi.max())
    padded = []
    for r in range(t.shape[1]):
        p = np.zeros((t.shape[0], n[r] * ck), np.float32)
        p[:, pad[r] : pad[r] + 2 * rad[r] + 1] = t[:, r, centre - rad[r] : centre + rad[r] + 1]
        padded.append(p)
    return n, before - lo, padded, before, after


def fused_sep_rank_plain(img: torch.Tensor, u, v, grain=None) -> torch.Tensor:
    """Plain version of K2. ``grain``: (seed pair, prm f32[6] tensor, taps)."""
    u3, v3 = stack_taps(u, v)
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


def chunked(u3: np.ndarray, v3: np.ndarray, c: int, h: int, w: int, nrank, ck: int = CK):
    """(taps, args): the (Cb, R, k) stacks (u3, v3) for a (c, h, w) image in
    chunks of ``ck`` taps, as the (Cb, stride) padded taps, per rank its
    column chunks then its row chunks, and their Ranks struct (its taps not
    filled); ``nrank`` (Cb,) the ranks each channel runs."""
    cb, r, _ = u3.shape
    nv, ov, pu, top, bottom = chunk_axis(u3, ck)
    nh, oh, pv, left, right = chunk_axis(v3, ck)
    taps = np.ascontiguousarray(np.concatenate([t for i in range(r) for t in (pu[i], pv[i])], axis=1))
    args = Ranks(C=c, H=h, W=w, per_channel=int(cb > 1), R=r, stride=taps.shape[1], top=top,
                 left=left, EH=TH + top + bottom, EW=TW + left + right)
    args.nrank[:cb] = [int(n) for n in nrank]
    for i in range(r):
        args.rank[i] = Rank(int(nv[i]), int(ov[i]), int(nh[i]), int(oh[i]))
    return taps, args


def pack(u, v, c: int, h: int, w: int) -> Packed:
    """The kernel's form of the stack (u, v) for a (c, h, w) image, kept
    by the taps' contents and the image shape."""
    key = ("sep_rank", cache.content_key(u), cache.content_key(v), c, h, w)
    return cache.host(key, lambda: _pack(u, v, c, h, w, key[:3]))


def _pack(u, v, c: int, h: int, w: int, key) -> Packed:
    u3, v3 = stack_taps(u, v)
    cb, r, kv = u3.shape
    if cb not in (1, c):
        raise ValueError(f"taps for {cb} channels, image has {c}")
    if cb > MAX_C:
        raise ValueError(f"per-channel taps for {cb} channels, the kernel takes {MAX_C}")
    if r > MAX_R:
        raise ValueError(f"{r} ranks, the kernel takes {MAX_R}")
    nonzero = np.any(u3 != 0, axis=2) & np.any(v3 != 0, axis=2)  # (Cb, R)
    nrank = np.array(
        [int(np.nonzero(row)[0].max()) + 1 if row.any() else 0 for row in nonzero],
        np.int32,
    )
    taps, args = chunked(u3, v3, c, h, w, nrank)
    taps.setflags(write=False)
    by_value = taps.size <= MAX_TAPS
    if by_value:
        ctypes.memmove(args.taps, taps.ctypes.data, taps.nbytes)
    narrow = tpu_declines(h, w, kv // 2)
    return Packed(taps, nrank, args, ctypes.addressof(args), by_value, narrow, key)


def fused_sep_rank(img: torch.Tensor, u, v, grain=None) -> torch.Tensor:
    """K2 wrapper. img (C, H, W) float32; u, v numpy (R, k) shared or
    (C, R, k) per channel, or lists of shared rank rows of odd, possibly
    different lengths; grain = ((seed, row_off), prm, taps) or None."""
    if not kb.use_kernel(img):
        return fused_sep_rank_plain(img, u, v, grain)
    kb.require(img, "img", torch.float32)
    shape = img.shape
    if len(shape) != 3:
        raise ValueError(f"img: want (C, H, W), got {tuple(shape)}")
    c, h, w = shape
    p = pack(u, v, c, h, w)
    dtaps = None if p.by_value else cache.on_device(p.key, lambda: p.taps, img.device).data_ptr()
    out = torch.empty_like(img)
    gargs = prm_ptr = None
    if grain is not None:
        (seed, row_off), prm, gt = grain
        if len(gt) > grain_ops.MAX_TAPS:
            raise ValueError(f"grain: {len(gt)} taps, the kernel takes {grain_ops.MAX_TAPS}")
        prm = trace.to_device(prm, img.device, torch.float32).contiguous()
        kb.require(prm, "grain prm", torch.float32, (6,))
        prm_ptr = prm.data_ptr()
        gargs = ctypes.byref(GrainArgs(seed, row_off, len(gt), tuple(float(t) for t in gt)))
    err = kb.lib().r2f_sep_rank(
        img.data_ptr(), out.data_ptr(), p.args_ptr, dtaps, gargs, prm_ptr, kb.stream_ptr(img)
    )
    if err:
        kb.check(err, "r2f_sep_rank")
    trace.count("launch.sep_rank_narrow" if grain is None and p.narrow else "launch.sep_rank")
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
