"""The benchmark's inputs, made from the seed: sensor mosaics on the device
and the DNG files a roll is written as.

A scene is camera-linear RGB at mid-grey on average: a smooth field of
about +-3 stops, a smooth colour cast, per-pixel texture, and small square
highlights four stops over, which the halation and the burn act on. It is
sampled through an RGGB filter and written as 16-bit codes between the
configuration's black and white levels. One ``torch.Generator`` on the
device draws everything, in a few large calls, so the same seed gives the
same mosaics on every run.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

# The EXIF a written DNG carries (the exposure estimate reads these).
EXIF = {"iso": 100, "exposure_time": 1 / 125, "f_number": 4.0}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)


def mosaics(n: int, h: int, w: int, black: int, white: int, gen: torch.Generator, device) -> list:
    """``n`` (h, w) uint16 RGGB mosaics on ``device``."""
    return [mosaic(h, w, black, white, gen, device) for _ in range(n)]


def mosaic(h: int, w: int, black: int, white: int, gen: torch.Generator, device) -> torch.Tensor:
    def smooth(c: int, cell: int, lo: float, hi: float) -> torch.Tensor:
        coarse = torch.rand((1, c, -(-h // cell) + 1, -(-w // cell) + 1), generator=gen, device=device)
        up = F.interpolate(coarse * (hi - lo) + lo, scale_factor=cell, mode="bilinear", align_corners=False)
        return up[0, :, :h, :w]

    stops = smooth(1, 256, -3.0, 3.0)[0]
    cast = smooth(3, 512, 0.6, 1.4)
    spots = torch.rand((1, 1, -(-h // 32), -(-w // 32)), generator=gen, device=device) > 0.995
    spots = F.interpolate(spots.to(torch.float32), scale_factor=32, mode="nearest")[0, 0, :h, :w]
    texture = 1.0 + 0.08 * torch.randn((h, w), generator=gen, device=device)
    lum = 0.18 * torch.exp2(stops + 4.0 * spots) * texture
    yy = (torch.arange(h, device=device) & 1)[:, None]
    xx = (torch.arange(w, device=device) & 1)[None, :]
    chan = torch.where((yy == 0) & (xx == 0), 0, torch.where((yy == 1) & (xx == 1), 2, 1))
    cfa = torch.gather(cast, 0, chan[None].expand(1, h, w))[0] * lum
    codes = black + (white - black) * cfa
    return torch.clamp(torch.round(codes), 0, white).to(torch.int32).to(torch.uint16)


# ------------------------------------------------------------ DNG


def _entry(tag, typ, values, heap, heap_base):
    if typ == 2:
        raw = values.encode("ascii") + b"\0"
        n = len(raw)
    elif typ in (5, 10):
        fmt = "II" if typ == 5 else "ii"
        raw = b"".join(struct.pack("<" + fmt, *v) for v in values)
        n = len(values)
    else:
        fmt = {1: "B", 3: "H", 4: "I"}[typ]
        raw = struct.pack("<" + fmt * len(values), *values)
        n = len(values)
    if len(raw) <= 4:
        return struct.pack("<HHI", tag, typ, n) + raw + b"\0" * (4 - len(raw))
    ptr = heap_base + len(heap)
    heap += raw if len(raw) % 2 == 0 else raw + b"\0"
    return struct.pack("<HHI", tag, typ, n) + struct.pack("<I", ptr)


def write_dng(path: str, mosaic_u16: np.ndarray, black: int, white: int, color_matrix) -> None:
    """An uncompressed 16-bit RGGB DNG (one strip) with the XYZ -> camera
    ``color_matrix`` and :data:`EXIF` (the layout of the program's test
    writer, ``io/dng.py::write_dng``, copied)."""
    h, w = mosaic_u16.shape
    data = np.ascontiguousarray(mosaic_u16, "<u2").tobytes()
    n_ifd0, n_exif = 19, 3
    ifd0_size = 2 + n_ifd0 * 12 + 4
    exif_offset = 8 + ifd0_size
    heap_base = exif_offset + 2 + n_exif * 12 + 4
    heap = bytearray()
    e = []

    def E(tag, typ, values):
        e.append(_entry(tag, typ, values, heap, heap_base))

    for tag, typ, values in (
        (254, 4, [0]), (256, 4, [w]), (257, 4, [h]), (258, 3, [16]), (259, 3, [1]), (262, 3, [32803]),
        (271, 2, "raw2film-tpu"), (272, 2, "synthetic"), (273, 4, [0]), (277, 3, [1]), (278, 4, [h]),
        (279, 4, [len(data)]), (33421, 3, [2, 2]), (33422, 1, [0, 1, 1, 2]), (34665, 4, [exif_offset]),
        (50706, 1, [1, 4, 0, 0]), (50714, 3, [black]), (50717, 3, [white]),
        (50721, 10, [(int(round(x * 10000)), 10000) for x in np.asarray(color_matrix, np.float64).ravel()]),
    ):
        E(tag, typ, values)
    ex = []
    for tag, typ, values in (
        (33434, 5, [(int(EXIF["exposure_time"] * 1_000_000), 1_000_000)]),
        (33437, 5, [(int(EXIF["f_number"] * 100), 100)]),
        (34855, 3, [EXIF["iso"]]),
    ):
        ex.append(_entry(tag, typ, values, heap, heap_base))
    data_offset = heap_base + len(heap)
    e[8] = struct.pack("<HHI", 273, 4, 1) + struct.pack("<I", data_offset)
    out = bytearray(b"II" + struct.pack("<HI", 42, 8))
    out += struct.pack("<H", n_ifd0) + b"".join(e) + struct.pack("<I", 0)
    out += struct.pack("<H", n_exif) + b"".join(ex) + struct.pack("<I", 0)
    out += heap + data
    with open(path, "wb") as f:
        f.write(out)


def written_meta() -> dict:
    """The EXIF values as a reader decodes the rationals written above."""
    return {
        "iso": float(EXIF["iso"]),
        "exposure_time": int(EXIF["exposure_time"] * 1_000_000) / 1_000_000,
        "f_number": int(EXIF["f_number"] * 100) / 100,
    }


def written_matrix(color_matrix) -> np.ndarray:
    """The XYZ -> camera matrix as a reader decodes it (4 decimals)."""
    return np.round(np.asarray(color_matrix, np.float64) * 10000) / 10000


def cam_to_xyz(color_matrix) -> np.ndarray:
    """The camera -> XYZ matrix a renderer takes from the written one."""
    return np.linalg.inv(written_matrix(color_matrix)).astype(np.float32)


def roll(folder: str, mosaics_dev: list, black: int, white: int, color_matrix) -> list[str]:
    """The mosaics written as ``frame_<i>.dng`` in ``folder``."""
    paths = []
    for i, m in enumerate(mosaics_dev):
        path = os.path.join(folder, f"frame_{i}.dng")
        write_dng(path, m.cpu().numpy(), black, white, color_matrix)
        paths.append(path)
    return paths
