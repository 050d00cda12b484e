"""RAW -> linear camera XYZ on the device: the staged decode.

The counterpart of ``raw2film_tpu/io/raw.py``. The container parse stays on
the host (``io/dng.py::read_raw``, the port's copy of the JAX package's);
the normalize and the decode run on the device: the Bayer MHC demosaic on K1
(without its matrix epilogue), the half-size decode on K11, the X-Trans
masked decode on K2, or the plain normalize of non-CFA data. The camera
matrix is an exact float32 3x3 of scalar mul-adds, as the JAX package's
``HIGHEST``-precision einsum.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raw2film_tpu_torch.io import dng
from raw2film_tpu_torch.ops import demosaic as dm


def calc_exposure(
    xyz: np.ndarray,
    ref_exposure: float = 0.18,
    metadata: dict | None = None,
    subsampled: bool = False,
) -> float:
    """Stops of gain that bring the image to mid-grey: the power mean of the
    2x-subsampled green plane with an EXIF-derived exponent (a copy of
    the JAX package's ``io/raw.py::calc_exposure``, whose module imports JAX;
    ``subsampled=True``: ``xyz`` already is that plane)."""
    lum = np.asarray(xyz) if subsampled else np.asarray(xyz)[1, ::2, ::2]
    factor = 3.0
    if metadata:
        try:
            fn = float(metadata.get("EXIF:FNumber") or 4.0)
            iso = float(metadata["EXIF:ISO"])
            t = float(metadata["EXIF:ExposureTime"])
            factor = math.sqrt(fn**2 / iso / t) + 1.0
        except (KeyError, TypeError, ValueError, ZeroDivisionError):
            factor = 3.0
    lum = np.maximum(lum, 1e-9)
    avg = float(np.mean(lum ** (1.0 / factor)) ** factor)
    return math.log2(ref_exposure / max(avg, 1e-9))


def apply_orientation(rgb: torch.Tensor, orientation: int) -> torch.Tensor:
    """Upright a planar (3, H, W) image per TIFF tag 274."""
    o = int(orientation)
    if o == 2:  # mirror horizontal
        return rgb.flip(-1)
    if o == 3:  # rotate 180
        return rgb.flip(-2, -1)
    if o == 4:  # mirror vertical
        return rgb.flip(-2)
    if o == 5:  # transpose
        return rgb.transpose(1, 2).contiguous()
    if o == 6:  # rotate 90 clockwise
        return torch.rot90(rgb, k=-1, dims=(1, 2)).contiguous()
    if o == 7:  # transverse
        return rgb.transpose(1, 2).flip(-2, -1)
    if o == 8:  # rotate 90 counter-clockwise
        return torch.rot90(rgb, k=1, dims=(1, 2)).contiguous()
    return rgb


def _upload(data: np.ndarray, device) -> torch.Tensor:
    """The sensor data on the device: uint16 codes as they are, anything
    else as float32 (what JAX makes of it with 64-bit types off)."""
    data = np.ascontiguousarray(data)
    if data.dtype != np.uint16:
        data = data.astype(np.float32)
    return torch.as_tensor(data, device=device)


def decode_raw(raw, half_size: bool = False, demosaic: str = "mhc", device=None) -> torch.Tensor:
    """RawImage -> (3, H, W) float32 camera-linear XYZ in [0, 1] on
    ``device``, uprighted per the container's Orientation tag. A full-size
    Bayer decode is Malvar-He-Cutler (``demosaic="mhc"``, K1) or bilinear
    (``"bilinear"``, its stencils on K2)."""
    data = _upload(raw.data, device)
    norm = (raw.black_level, 1.0 / max(raw.white_level - raw.black_level, 1.0))
    if raw.cfa_pattern is not None:
        if len(raw.cfa_pattern) == 36:
            # X-Trans (6x6); the half-size preview is the same decode
            # box-averaged 2x2.
            rgb = dm.demosaic_masked(dm.normalize(data, norm), raw.cfa_pattern, 6, 6)
            if half_size:
                h2, w2 = rgb.shape[1] // 2, rgb.shape[2] // 2
                rgb = rgb[:, : h2 * 2, : w2 * 2].reshape(3, h2, 2, w2, 2).mean(dim=(2, 4))
        elif half_size:
            rgb = dm.half_size_decode(data, raw.cfa_pattern, norm)
        elif demosaic == "bilinear":
            rgb = dm.demosaic_bilinear(dm.normalize(data, norm), raw.cfa_pattern)
        else:
            rgb = dm.demosaic_mhc(data, raw.cfa_pattern, norm=norm)
        rgb = torch.clamp(rgb, 0.0, 1.0)
    else:
        rgb = torch.clamp(dm.normalize(data, norm).movedim(-1, 0), 0.0, 1.0)
    if raw.color_matrix is not None:
        m = np.linalg.inv(np.asarray(raw.color_matrix, np.float64)).astype(np.float32)
        mt = [[float(v) for v in row] for row in m]
        rgb = torch.stack(
            [mt[i][0] * rgb[0] + mt[i][1] * rgb[1] + mt[i][2] * rgb[2] for i in range(3)]
        )
    orient = int(raw.metadata.get("EXIF:Orientation", 1) or 1)
    if orient != 1:
        rgb = apply_orientation(rgb, orient)
    return rgb.contiguous()


def raw_to_linear(src, half_size: bool = True, device=None) -> tuple[torch.Tensor, dict]:
    """File path (or a parsed RawImage) -> ((3, H, W) XYZ on ``device``
    auto-exposed to mid-grey, metadata). Only the 2x-subsampled green plane
    the exposure estimate reads is fetched to the host."""
    raw = src if isinstance(src, dng.RawImage) else dng.read_raw(str(src))
    xyz = decode_raw(raw, half_size=half_size, device=device)
    lum = xyz[1, ::2, ::2].cpu().numpy()
    gain = 2.0 ** calc_exposure(lum, metadata=raw.metadata, subsampled=True)
    return xyz * gain, raw.metadata
