"""Pentax-Huffman PEF decode (TIFF Compression 65535).

The reference ingests PEF via LibRaw (reference:
src/raw2film/raw_conversion.py:36-48). The format (LibRaw/dcraw's
``pentax_load_raw``): an LJPEG-class Huffman predictor stream whose
Huffman table ships in the file itself — Pentax MakerNote tag 0x0220:

====== =============================================
0..1   u16 v — symbol count dep = (v + 12) & 15
2..13  12 reserved bytes
then   dep × u16 left-aligned 12-bit code starts
then   dep × u8 code lengths
====== =============================================

Symbol value = storage index = the T.81 ssss category of the following
signed residual; predictors are the Nikon-style two-column scheme with
zero-initialized vpred. Decoded by the native kernel
(``native/r2f_native.cc::r2f_decode_pef``), verified by encoder round-trip
in tests/test_raw_formats.py.
"""

from __future__ import annotations

import struct

import numpy as np


def find_pentax_makernote(mn: bytes) -> tuple[int, str] | None:
    """Locate the Pentax MakerNote IFD inside the MakerNote bytes.
    Layouts: b"AOC\\0" + order mark + IFD, or b"PENTAX \\0" + order mark +
    IFD. Returns (ifd offset within mn, endian)."""
    for prefix in (b"AOC\x00", b"PENTAX \x00"):
        if mn.startswith(prefix):
            base = len(prefix)
            order = mn[base : base + 2]
            endian = {b"II": "<", b"MM": ">"}.get(order)
            if endian:
                return base + 2, endian
    return None


def read_huff_table(
    mn: bytes, ifd_off: int, endian: str
) -> tuple[np.ndarray, np.ndarray] | None:
    """Tag 0x0220 -> (starts uint16[dep], lens uint8[dep]). Value offsets
    are tried relative to the MakerNote start (self-contained files, our
    fixtures) and validated by structure."""
    try:
        (count,) = struct.unpack_from(endian + "H", mn, ifd_off)
        pos = ifd_off + 2
        for _ in range(min(count, 256)):
            tag, typ, n = struct.unpack_from(endian + "HHI", mn, pos)
            pos += 12
            if tag != 0x0220:
                continue
            if n <= 4:
                return None
            (ptr,) = struct.unpack_from(endian + "I", mn, pos - 4)
            for blob_off in (ptr, ptr - 10):  # relative bases seen in the wild
                if blob_off < 0:  # would wrap into the buffer tail
                    continue
                blob = mn[blob_off : blob_off + n]
                parsed = parse_huff_blob(blob, endian)
                if parsed is not None:
                    return parsed
            return None
    except struct.error:
        return None
    return None


def parse_huff_blob(
    blob: bytes, endian: str
) -> tuple[np.ndarray, np.ndarray] | None:
    if len(blob) < 14:
        return None
    (v,) = struct.unpack_from(endian + "H", blob, 0)
    dep = (v + 12) & 15
    need = 14 + 3 * dep
    if dep < 1 or len(blob) < need:
        return None
    starts = np.frombuffer(
        blob, np.dtype(endian + "u2"), count=dep, offset=14
    ).astype(np.uint16)
    lens = np.frombuffer(
        blob, np.uint8, count=dep, offset=14 + 2 * dep
    ).copy()
    if not ((lens >= 1) & (lens <= 12)).all():
        return None
    return starts, lens


def decode_pef_compressed(
    bitstream: bytes, makernote: bytes, width: int, height: int
) -> np.ndarray:
    from raw2film_tpu_torch.native import decode_pef

    found = find_pentax_makernote(makernote)
    if found is None:
        raise NotImplementedError(
            "Pentax-compressed PEF without a recognizable MakerNote"
        )
    table = read_huff_table(makernote, *found)
    if table is None:
        raise NotImplementedError(
            "PEF Huffman table (MakerNote 0x0220) missing or unparseable"
        )
    starts, lens = table
    return decode_pef(bitstream, starts, lens, width, height)
