"""Nikon-compressed NEF decode (TIFF Compression 34713).

The reference ingests these via LibRaw (reference:
src/raw2film/raw_conversion.py:36-48; extension list
src/raw2film/data.py:87-102). This module owns the format natively:

* **MakerNote walk** — Nikon MakerNotes are an embedded TIFF ("Nikon\\0"
  header + its own byte-order mark); tag 0x0096 holds the compression
  metadata blob (version, vpred[2][2] initial predictors, linearization
  curve, split row).
* **Bitstream** — a Huffman-coded predictor-residual stream (the scheme
  LibRaw/dcraw call ``nikon_load_raw``): fixed per-format Huffman trees,
  two-column predictor state seeded from vpred, LJPEG-style signed-residual
  categories, NO JPEG byte stuffing. Decoded by the native C++ kernel
  (``native/r2f_native.cc::r2f_decode_nef``).
* **Linearization** — version 0x46 streams ("lossless") use an identity
  curve; 0x44 ("lossy"/type-1) versions carry a sampled curve expanded by
  linear interpolation and may switch Huffman trees at a split row.

The fixed Huffman trees are format constants (every NEF uses them; they
play the role JPEG's standard DHT tables do). The LOSSLESS trees are
verified by encoder round-trip in tests/test_raw_formats.py; the lossy
trees (type-1 and after-split, incl. the shl high-nibble reconstruction,
sampled-curve expansion, quarter-range 0x44 0x40 curves, and the D100-era
filler layout) are pinned against an independent Python model on
adversarial synthetic streams (tests/test_raw_formats.py::TestNikonLossy)
plus a greedy spec-encoder container round trip — the same conformance
methodology as the CRX suite. Real-camera lossy files remain unverifiable
in this zero-egress environment, so lossy decodes stay flagged in the
metadata.
"""

from __future__ import annotations

import struct

import numpy as np

# Nikon fixed Huffman trees, JPEG-canonical (16 length counts + symbol
# values). Symbols encode len in the low nibble and an optional shift in the
# high nibble (used only by the after-split lossy trees).
_TREES = {
    # 12-bit lossless (version 0x46)
    "12_lossless": (
        [0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12],
    ),
    # 14-bit lossless (version 0x46)
    "14_lossless": (
        [0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0],
        [7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14],
    ),
    # 12-bit lossy type 1 (version 0x44 0x10)
    "12_lossy": (
        [0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0],
        [5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12],
    ),
    # 14-bit lossy type 1
    "14_lossy": (
        [0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0],
        [5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14],
    ),
    # 12-bit lossy after split (version 0x44 0x20)
    "12_split": (
        [0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0],
        [0x39, 0x5A, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12],
    ),
    # 14-bit lossy after split
    "14_split": (
        [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0],
        [8, 0x5C, 0x4B, 0x3A, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14],
    ),
}


def find_nikon_makernote(
    buf: bytes, makernote_offset: int, makernote_len: int
) -> tuple[int, str] | None:
    """Locate the embedded MakerNote TIFF. Returns (absolute base offset,
    endian) or None. Nikon format: b"Nikon\\0" + 4 version/pad bytes + a
    self-contained TIFF whose value offsets are relative to its own start."""
    mn = buf[makernote_offset : makernote_offset + max(makernote_len, 16)]
    if not mn.startswith(b"Nikon\x00"):
        return None
    base = makernote_offset + 10
    bom = buf[base : base + 2]
    if bom == b"II":
        return base, "<"
    if bom == b"MM":
        return base, ">"
    return None


def read_makernote_tag(
    buf: bytes, base: int, endian: str, want_tag: int
) -> bytes | None:
    """Read one tag's value bytes from the embedded MakerNote TIFF (the
    shared hardened IFD walker does the parsing; offsets are relative to
    the embedded TIFF start, so the rebased slice resolves them)."""
    from raw2film_tpu_torch.io.dng import _read_ifd

    try:
        (magic, first_ifd) = struct.unpack_from(endian + "HI", buf, base + 2)
        if magic != 42:
            return None
        ifd, _ = _read_ifd(buf[base:], first_ifd, endian)
        val = ifd.get(want_tag)
        if isinstance(val, (bytes, bytearray)):
            return bytes(val)
        return None
    except struct.error:
        return None


def parse_linearization(
    blob: bytes, endian: str, bits: int
) -> tuple[np.ndarray, np.ndarray, int, str]:
    """Parse the MakerNote 0x0096 blob -> (curve uint16, vpred uint16[4],
    split_row, kind). Layout (LibRaw/dcraw ``nikon_load_raw`` metadata):

    byte 0..1   version (0x46,* = lossless; 0x44,0x20 = lossy with split;
                0x44,0x10 / 0x46-less = lossy type 1)
    bytes 2..9  vpred[2][2] as four u16
    bytes 10..11 curve sample count csize
    then        csize u16 curve samples (lossy: expanded by linear interp
                over max/(csize-1) steps; lossless keeps identity)
    offset 562  u16 split row (version 0x44 0x20 only)
    """
    if len(blob) < 12:
        raise ValueError("NEF linearization blob too short")
    ver0, ver1 = blob[0], blob[1]
    pos = 2
    if ver0 == 0x49 or ver1 == 0x58:
        # D100-era: 2110 filler bytes precede the predictors.
        pos += 2110
    vpred = np.array(
        struct.unpack_from(endian + "HHHH", blob, pos), np.uint16
    )
    pos += 8
    (csize,) = struct.unpack_from(endian + "H", blob, pos)
    pos += 2
    vmax = 1 << bits
    curve = np.arange(vmax, dtype=np.uint16)  # identity default
    split = 0
    if ver0 == 0x44 and ver1 in (0x20, 0x40):
        kind = "lossy_split"
        # 0x40 streams sample a quarter-range table (LibRaw scales the
        # step and range by 4); both variants carry the split row at
        # offset 562. Lossy handling remains best-effort (no in-repo
        # camera fixtures) — see module docstring.
        srange = vmax // 4 if ver1 == 0x40 else vmax
        step = srange // (csize - 1) if csize > 1 else 0
        if len(blob) >= 564:
            (split,) = struct.unpack_from(endian + "H", blob, 562)
        if step > 0 and pos + 2 * csize <= len(blob):
            samples = np.frombuffer(
                blob, np.dtype(endian + "u2"), count=csize, offset=pos
            ).astype(np.float64)
            xs = np.arange(csize) * step
            curve = np.interp(
                np.arange(vmax), np.clip(xs, 0, vmax - 1), samples
            ).astype(np.uint16)
    elif ver0 != 0x46 and 1 < csize <= 0x4001 and pos + 2 * csize <= len(blob):
        kind = "lossy"
        curve = np.frombuffer(
            blob, np.dtype(endian + "u2"), count=csize, offset=pos
        ).copy()
    else:
        kind = "lossless" if ver0 == 0x46 else "lossy"
    return curve, vpred, int(split), kind


def decode_nef_compressed(
    bitstream: bytes,
    blob: bytes,
    blob_endian: str,
    width: int,
    height: int,
    bits: int,
) -> np.ndarray:
    """Decode a Nikon-compressed strip -> (height, width) uint16."""
    from raw2film_tpu_torch.native import decode_nef

    curve, vpred, split, kind = parse_linearization(blob, blob_endian, bits)
    b = "14" if bits == 14 else "12"
    if kind == "lossless":
        tree1, tree2 = _TREES[f"{b}_lossless"], None
    elif kind == "lossy_split" and split > 0:
        tree1, tree2 = _TREES[f"{b}_lossy"], _TREES[f"{b}_split"]
    else:
        tree1, tree2 = _TREES[f"{b}_lossy"], None
        split = 0
    return decode_nef(
        bitstream, tree1, tree2, split, vpred, curve, width, height
    )
