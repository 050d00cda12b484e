"""Demosaic: Malvar-He-Cutler 5x5 with the input transform fused, the
half-size decode, the bilinear decode and the masked X-Trans decode.

The counterpart of ``raw2film_tpu/ops/demosaic.py``:

- ``demosaic_mhc`` and ``demosaic_exposure`` launch kernel K1 on a CUDA
  tensor (``csrc/demosaic.cu``, the port of
  ``pallas_demosaic.demosaic_mhc_pallas``); on a CPU tensor they run
  :func:`demosaic_plain`, which mirrors that kernel's arithmetic (the
  grouped pair sums) in plain PyTorch;
- :func:`half_size_decode` launches K11 (``csrc/demosaic.cu``, the port of
  ``pallas_pyramid.half_size_decode_pallas``), or :func:`half_size_plain`;
- :func:`demosaic_bilinear` and :func:`demosaic_masked`, the X-Trans
  decode, run their depthwise convs as SVD ranks on K2, as
  ``depthwise_conv2d`` does on the TPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import sep_rank
from raw2film_tpu_torch.ops.conv import pad_reflect, svd_separable

PATTERNS = {
    "RGGB": (0, 0),
    "BGGR": (1, 1),
    "GRBG": (0, 1),
    "GBRG": (1, 0),
}
R = 2  # stencil radius


def _norm_pair(norm) -> tuple[float, float] | None:
    """(black, inv_range) as float32 values, or None."""
    if norm is None:
        return None
    if isinstance(norm, torch.Tensor):
        norm = norm.detach().cpu().numpy()
    n = np.asarray(norm, np.float32).reshape(-1)
    return float(n[0]), float(n[1])


def normalize(bayer: torch.Tensor, norm) -> torch.Tensor:
    """clip01((x - black) * inv_range) in float32 (render.py:546-548 of the
    JAX package)."""
    black, inv_range = _norm_pair(norm)
    return torch.clamp((bayer.to(torch.float32) - black) * inv_range, 0.0, 1.0)


def demosaic_plain(bayer: torch.Tensor, ry: int, rx: int, mat=None, norm=None) -> torch.Tensor:
    """Plain version of K1: (H, W) -> (3, H, W) float32; with ``mat`` (3x3),
    max(mat @ clip01(rgb), 0)."""
    x = normalize(bayer, norm) if norm is not None else bayer.to(torch.float32)
    h, w = x.shape
    p = pad_reflect(x, R, R)

    def sh(dy, dx):
        return p[dy : dy + h, dx : dx + w]

    m = sh(2, 2)
    h1 = sh(2, 1) + sh(2, 3)
    v1 = sh(1, 2) + sh(3, 2)
    h2 = sh(2, 0) + sh(2, 4)
    v2 = sh(0, 2) + sh(4, 2)
    dg = (sh(1, 1) + sh(1, 3)) + (sh(3, 1) + sh(3, 3))
    e = 0.125
    hv2 = h2 + v2
    t_g = e * (4.0 * m + 2.0 * (h1 + v1) - hv2)
    t_row = e * (5.0 * m + 4.0 * h1 - dg - h2 + 0.5 * v2)
    t_col = e * (5.0 * m + 4.0 * v1 - dg - v2 + 0.5 * h2)
    t_opp = e * (6.0 * m + 2.0 * dg - 1.5 * hv2)
    yy = (torch.arange(h, device=x.device) & 1)[:, None]
    xx = (torch.arange(w, device=x.device) & 1)[None, :]
    is_r = (yy == ry) & (xx == rx)
    is_b = (yy == 1 - ry) & (xx == 1 - rx)
    g_r_row = (yy == ry) & (xx == 1 - rx)
    g_b_row = (yy == 1 - ry) & (xx == rx)
    r = torch.where(is_r, m, torch.where(g_r_row, t_row, torch.where(g_b_row, t_col, t_opp)))
    g = torch.where(is_r | is_b, t_g, m)
    b = torch.where(is_b, m, torch.where(g_b_row, t_row, torch.where(g_r_row, t_col, t_opp)))
    if mat is None:
        return torch.stack([r, g, b])
    mt = [float(v) for v in np.asarray(mat, np.float32).reshape(9)]
    r, g, b = (torch.clamp(q, 0.0, 1.0) for q in (r, g, b))
    return torch.stack(
        [
            torch.clamp(mt[3 * c] * r + mt[3 * c + 1] * g + mt[3 * c + 2] * b, min=0.0)
            for c in range(3)
        ]
    )


def vec_path(w: int, dtype: torch.dtype, *ptrs: int) -> bool:
    """Whether K1 takes its 16-byte path: W a multiple of the values in 16
    bytes (8 uint16, 4 float32), the mosaic and output 16-byte aligned;
    otherwise its general path (any shape)."""
    return w % (8 if dtype == torch.uint16 else 4) == 0 and all(p % 16 == 0 for p in ptrs)


def demosaic_kernel(bayer: torch.Tensor, ry: int, rx: int, mat=None, norm=None) -> torch.Tensor:
    """K1 wrapper: (H, W) uint16 or float32 on the card -> (3, H, W) float32.
    The kernel's path follows :func:`vec_path`."""
    if not kb.use_kernel(bayer):
        return demosaic_plain(bayer, ry, rx, mat, norm)
    kb.require(bayer, "mosaic", (torch.uint16, torch.float32))
    if bayer.dim() != 2:
        raise ValueError(f"mosaic: want (H, W), got {tuple(bayer.shape)}")
    h, w = bayer.shape
    out = torch.empty((3, h, w), dtype=torch.float32, device=bayer.device)
    pair = _norm_pair(norm)
    mat_arg = None
    if mat is not None:
        mat_arg = (ctypes.c_float * 9)(*np.asarray(mat, np.float32).reshape(9).tolist())
    src, dst = bayer.data_ptr(), out.data_ptr()
    err = kb.lib().r2f_demosaic(
        src, int(bayer.dtype == torch.uint16), dst, h, w,
        ry, rx, int(pair is not None), *(pair or (0.0, 1.0)),
        ctypes.cast(mat_arg, ctypes.c_void_p) if mat_arg is not None else None,
        int(vec_path(w, bayer.dtype, src, dst)), kb.stream_ptr(bayer),
    )
    kb.check(err, "r2f_demosaic")
    kb.launches["demosaic"] += 1
    return out


def _phase(pattern: str) -> tuple[int, int]:
    if pattern not in PATTERNS:
        raise ValueError(f"unsupported Bayer pattern {pattern!r}")
    return PATTERNS[pattern]


def demosaic_mhc(bayer: torch.Tensor, pattern: str = "RGGB", norm=None) -> torch.Tensor:
    """(H, W) mosaic -> planar RGB (3, H, W) float32."""
    return demosaic_kernel(bayer, *_phase(pattern), norm=norm)


def demosaic_exposure(bayer: torch.Tensor, pattern: str, mat, norm=None) -> torch.Tensor:
    """max(mat @ clip01(demosaic_mhc(bayer)), 0): the demosaic fused with the
    chain's input transform (``mat`` a host 3x3). ``norm`` = (black,
    inv_range) normalizes raw sensor codes first."""
    return demosaic_kernel(bayer, *_phase(pattern), mat=mat, norm=norm)


# ------------------------------------------------------------ K11


def half_size_plain(bayer: torch.Tensor, ry: int, rx: int, norm=None) -> torch.Tensor:
    """Plain version of K11: strided slices of the (normalized) mosaic, the
    greens averaged as 0.5 * (a + b); an odd last row or column is dropped."""
    x = normalize(bayer, norm) if norm is not None else bayer.to(torch.float32)
    h2, w2 = x.shape[0] // 2, x.shape[1] // 2
    x = x[: h2 * 2, : w2 * 2]
    r = x[ry::2, rx::2]
    b = x[1 - ry :: 2, 1 - rx :: 2]
    g = 0.5 * (x[ry::2, 1 - rx :: 2] + x[1 - ry :: 2, rx::2])
    return torch.stack([r, g, b])


def half_size_decode(bayer: torch.Tensor, pattern: str = "RGGB", norm=None) -> torch.Tensor:
    """K11 wrapper: (H, W) uint16 or float32 mosaic -> (3, H//2, W//2)
    float32, each 2x2 Bayer cell one RGB pixel. ``norm`` = (black,
    inv_range) normalizes raw sensor codes first, as in K1."""
    ry, rx = _phase(pattern)
    if bayer.dim() != 2 or bayer.shape[0] < 2 or bayer.shape[1] < 2:
        raise ValueError(f"mosaic: want (H, W) with H, W >= 2, got {tuple(bayer.shape)}")
    if not kb.use_kernel(bayer):
        return half_size_plain(bayer, ry, rx, norm)
    kb.require(bayer, "mosaic", (torch.uint16, torch.float32))
    h, w = bayer.shape
    out = torch.empty((3, h // 2, w // 2), dtype=torch.float32, device=bayer.device)
    pair = _norm_pair(norm)
    err = kb.lib().r2f_half_size(
        bayer.data_ptr(), int(bayer.dtype == torch.uint16), out.data_ptr(), h, w, ry, rx,
        int(pair is not None), *(pair or (0.0, 1.0)), kb.stream_ptr(bayer),
    )
    kb.check(err, "r2f_half_size")
    kb.launches["half_size"] += 1
    return out


# ------------------------------------------------------------ bilinear

# The bilinear stencils (x 1/4): green at red and blue sites from its four
# neighbours; red (blue) from the red (blue) plane, zero elsewhere.
_BILINEAR_G = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], np.float32) / 4.0
_BILINEAR_RB = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 4.0


def demosaic_bilinear(bayer: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
    """Cheap bilinear demosaic: (H, W) float32 -> (3, H, W), each measured
    value kept at its own site. Both 3x3 stencils run as their SVD ranks on
    K2 (K4 on small frames), as ``depthwise_conv2d`` does on the TPU: green
    in one launch, red and blue as the two planes of another."""
    ry, rx = _phase(pattern)
    h, w = bayer.shape
    yy = (torch.arange(h, device=bayer.device) & 1)[:, None]
    xx = (torch.arange(w, device=bayer.device) & 1)[None, :]
    r_mask = (yy == ry) & (xx == rx)
    b_mask = (yy == 1 - ry) & (xx == 1 - rx)
    g = torch.where(r_mask | b_mask, _depthwise(bayer[None], _BILINEAR_G)[0], bayer)
    zero = torch.zeros((), dtype=bayer.dtype, device=bayer.device)
    planes = torch.stack([torch.where(r_mask, bayer, zero), torch.where(b_mask, bayer, zero)])
    rb = _depthwise(planes, _BILINEAR_RB)
    r = torch.where(r_mask, bayer, rb[0])
    b = torch.where(b_mask, bayer, rb[1])
    return torch.stack([r, g, b])


# ------------------------------------------------------------ X-Trans


def _depthwise(img: torch.Tensor, k2d: np.ndarray) -> torch.Tensor:
    """A shared 2-D kernel as its SVD ranks on K2 (tol 1e-4, rank <= 6), as
    ``depthwise_conv2d`` runs on the TPU."""
    return sep_rank.fused_sep_rank(img.contiguous(), *svd_separable(k2d, tol=1e-4, max_rank=6))


def demosaic_masked(mosaic: torch.Tensor, pattern: str, tile_h: int, tile_w: int) -> torch.Tensor:
    """Masked demosaic for any CFA tiling (the X-Trans 6x6 decode): the green
    plane by normalized 3x3-triangle interpolation over the G sites, then
    R and B from the interpolated colour differences (5x5 triangle), each
    measured value kept at its own site. (H, W) float32 -> (3, H, W)."""
    h, w = mosaic.shape
    code = {"R": 0, "G": 1, "B": 2}
    grid = np.array([code[c] for c in pattern], np.int32).reshape(tile_h, tile_w)
    full = np.tile(grid, (-(-h // tile_h), -(-w // tile_w)))[:h, :w]
    masks = torch.as_tensor(
        np.stack([(full == c) for c in range(3)]).astype(np.float32), device=mosaic.device
    )
    t3 = np.array([1.0, 2.0, 1.0], np.float32)
    t5 = np.array([1.0, 2.0, 3.0, 2.0, 1.0], np.float32)
    k3, k5 = np.outer(t3, t3), np.outer(t5, t5)

    gm = masks[1:2]
    g_num = _depthwise(mosaic[None] * gm, k3)
    g_den = _depthwise(gm, k3)
    g = torch.where(gm[0] > 0.5, mosaic, (g_num / torch.clamp(g_den, min=1e-8))[0])

    rb_masks = torch.stack([masks[0], masks[2]])
    diff = (mosaic - g)[None] * rb_masks
    d = _depthwise(diff, k5) / torch.clamp(_depthwise(rb_masks, k5), min=1e-8)
    r = torch.where(rb_masks[0] > 0.5, mosaic, g + d[0])
    b = torch.where(rb_masks[1] > 0.5, mosaic, g + d[1])
    return torch.stack([r, g, b])
