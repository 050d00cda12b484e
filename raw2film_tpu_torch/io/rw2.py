"""Panasonic RW2 container decode.

The reference ingests RW2 via LibRaw (reference:
src/raw2film/raw_conversion.py:36-48; extension list
src/raw2film/data.py:87-102). RW2 is a little-endian TIFF dialect with
magic 85 ("IIU\\0") and Panasonic-private tags in IFD0:

====== ======================================
0x0002 SensorWidth (full raw width)
0x0003 SensorHeight
0x0004 SensorTopBorder    (active-area crop)
0x0005 SensorLeftBorder
0x0006 SensorBottomBorder
0x0007 SensorRightBorder
0x0009 CFAPattern (1=RGGB 2=GRBG 3=GBRG 4=BGGR)
0x000A BitsPerSample
0x0017 ISO
0x001C/1D/1E per-channel black level (stored minus the +15 pedestal
       LibRaw/rawspeed add back)
0x002D RawFormat (4 = v4 bitstream; others vary by generation)
0x0118 RawDataOffset (payload runs to end of file)
====== ======================================

Payloads: RawFormat 4 decodes through the native v4 kernel
(``native/r2f_native.cc::r2f_decode_rw2_v4``); RawFormat 5 is plain
LSB-first bit packing in 16-byte packets inside rotated 0x4000 sections,
RawFormat 7 the same packets streamed straight, RawFormat 6 (full-frame
S bodies) the differential 11-pixel block code (all vectorized numpy);
16-bit and Panasonic 12-bit-packed payloads are size-inferred like the
NEF/ORF strips.
"""

from __future__ import annotations

import struct

import numpy as np

from raw2film_tpu_torch.io.dng import RawImage, _read_ifd

_CFA = {1: "RGGB", 2: "GRBG", 3: "GBRG", 4: "BGGR"}


def _unpack12_le(payload: bytes, n: int) -> np.ndarray:
    """Panasonic little-endian 12-bit packing: 3 bytes -> 2 samples,
    low sample first (p0 = b0 | (b1 & 0xF) << 8; p1 = b1 >> 4 | b2 << 4)."""
    b = np.frombuffer(payload, np.uint8)
    b = b[: (n + 1) // 2 * 3].reshape(-1, 3).astype(np.uint16)
    p0 = b[:, 0] | ((b[:, 1] & 0x0F) << 8)
    p1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
    return np.stack([p0, p1], axis=1).ravel()[:n]


_SECTION, _SPLIT = 0x4000, 0x1FF8


def _unrotate_sections(payload: bytes, need: int) -> np.ndarray:
    """Undo the per-0x4000-section rotation (first 0x1ff8 file bytes of a
    section are stored last — same layout v4 and v5 share)."""
    n_sec = -(-need // _SECTION)
    raw = np.zeros(n_sec * _SECTION, np.uint8)
    avail = min(len(payload), n_sec * _SECTION)
    raw[:avail] = np.frombuffer(payload, np.uint8, count=avail)
    raw = raw.reshape(n_sec, _SECTION)
    return np.concatenate(
        [raw[:, _SPLIT:], raw[:, :_SPLIT]], axis=1
    ).reshape(-1)


def _unpack_16byte_packets(
    packets: np.ndarray, per: int, bits: int
) -> np.ndarray:
    """LSB-first bit unpack of (N, 16) byte packets: pixel i occupies bits
    [i*bits, (i+1)*bits) of each 128-bit packet (shared by v5 and v7)."""
    lo = packets[:, :8].copy().view("<u8")[:, 0]
    hi = packets[:, 8:].copy().view("<u8")[:, 0]
    out = np.empty((len(packets), per), np.uint16)
    mask = np.uint64((1 << bits) - 1)
    for i in range(per):
        start = i * bits
        if start + bits <= 64:
            v = (lo >> np.uint64(start)) & mask
        elif start >= 64:
            v = (hi >> np.uint64(start - 64)) & mask
        else:
            low_bits = 64 - start
            v = (
                (lo >> np.uint64(start))
                | ((hi & np.uint64((1 << (bits - low_bits)) - 1)) << np.uint64(low_bits))
            ) & mask
        out[:, i] = v.astype(np.uint16)
    return out


def decode_rw2_v5(payload: bytes, width: int, height: int, bits: int) -> np.ndarray:
    """Panasonic v5 (RawFormat 5): plain LSB-first bit packing in 16-byte
    packets — 10 pixels/packet at 12 bits, 9 at 14 — inside the same
    rotated 0x4000-byte sections as v4 (the layout rawspeed's
    PanasonicDecompressorV5 describes). Vectorized numpy unpack."""
    if bits not in (12, 14):
        raise NotImplementedError(f"RW2 v5 with {bits}-bit samples")
    per = 10 if bits == 12 else 9
    npix = width * height
    n_packets = -(-npix // per)
    sec = _unrotate_sections(payload, n_packets * 16)
    packets = sec[: n_packets * 16].reshape(n_packets, 16)
    out = _unpack_16byte_packets(packets, per, bits)
    return out.reshape(-1)[:npix].reshape(height, width)


def decode_rw2_v7(payload: bytes, width: int, height: int, bits: int) -> np.ndarray:
    """Panasonic v7 (RawFormat 7, current S/G bodies): the v5 16-byte
    LSB-first packet packing WITHOUT the 0x4000-section rotation — blocks
    stream straight from RawDataOffset (the layout rawspeed's
    PanasonicV7Decompressor describes). Real sensor widths divide evenly
    into packets (e.g. 6048 = 672 x 9), so rows need no alignment padding;
    other widths are rejected rather than guessed."""
    if bits not in (12, 14):
        raise NotImplementedError(f"RW2 v7 with {bits}-bit samples")
    per = 10 if bits == 12 else 9
    if width % per:
        raise NotImplementedError(
            f"RW2 v7 with width {width} not a multiple of {per} "
            "(row alignment would be ambiguous); convert to DNG"
        )
    npix = width * height
    n_packets = npix // per
    if len(payload) < n_packets * 16:
        raise ValueError(
            f"RW2 v7 payload too small ({len(payload)} bytes for "
            f"{n_packets} packets)"
        )
    packets = np.frombuffer(payload, np.uint8, count=n_packets * 16).reshape(
        n_packets, 16
    )
    out = _unpack_16byte_packets(packets, per, bits)
    return out.reshape(height, width)


# RW2 v6 block layout: each 16-byte block is a 128-bit little-endian
# integer packing 14 fields MSB-first: two 14-bit seed pixels, then three
# groups of [2-bit scale base + three 10-bit coded pixels].  Field order
# == consumption order.  NOT fully contiguous: 2 unused bits sit between
# the last base group's first pixel and the final two fields (bits
# [22,24)) and 2 more pad the bottom (bits [0,2)) — the layout LibRaw's
# pana_cs6_page_decoder byte expressions encode (pinned by
# tests/test_raw_formats.py::test_v6_field_layout_matches_libraw_byte_expressions).
_V6_WIDTHS = (14, 14, 2, 10, 10, 10, 2, 10, 10, 10, 2, 10, 10, 10)
_V6_STARTS = (114, 100, 98, 88, 78, 68, 66, 56, 46, 36, 34, 24, 12, 2)


def _v6_extract_fields(packets: np.ndarray) -> np.ndarray:
    """(N, 16) uint8 blocks -> (N, 14) uint16 fields (order as consumed)."""
    lo = packets[:, :8].copy().view("<u8")[:, 0]
    hi = packets[:, 8:].copy().view("<u8")[:, 0]
    out = np.empty((len(packets), 14), np.uint16)
    for i, (start, bits) in enumerate(zip(_V6_STARTS, _V6_WIDTHS)):
        mask = np.uint64((1 << bits) - 1)
        if start + bits <= 64:
            v = (lo >> np.uint64(start)) & mask
        elif start >= 64:
            v = (hi >> np.uint64(start - 64)) & mask
        else:
            low_bits = 64 - start
            v = (
                (lo >> np.uint64(start))
                | ((hi & np.uint64((1 << (bits - low_bits)) - 1)) << np.uint64(low_bits))
            ) & mask
        out[:, i] = v.astype(np.uint16)
    return out


def decode_rw2_v6(payload: bytes, width: int, height: int, bits: int) -> np.ndarray:
    """Panasonic v6 (RawFormat 6, full-frame S / late G bodies): 16-byte
    blocks of 11 pixels — two raw 14-bit seeds, then 10-bit values scaled
    by a per-triple 2-bit base (pmul = 1<<base, base 3 meaning 4) and
    accumulated differentially per Bayer parity (the scheme LibRaw's
    panasonicC6_load_raw / rawspeed's PanasonicV6Decompressor implement).
    Blocks are independent, so the reconstruction vectorizes across blocks
    with one pass over the 11 in-block positions."""
    if bits != 14:
        raise NotImplementedError(
            f"RW2 v6 with {bits}-bit samples (only the 14-bit block code "
            "is supported); convert to DNG"
        )
    if width % 11:
        raise NotImplementedError(
            f"RW2 v6 with width {width} not a multiple of 11 "
            "(row alignment would be ambiguous); convert to DNG"
        )
    n_blocks = width * height // 11
    if len(payload) < n_blocks * 16:
        raise ValueError(
            f"RW2 v6 payload too small ({len(payload)} bytes for "
            f"{n_blocks} blocks)"
        )
    packets = np.frombuffer(payload, np.uint8, count=n_blocks * 16).reshape(
        n_blocks, 16
    )
    f = _v6_extract_fields(packets).astype(np.int64)

    out = np.empty((n_blocks, 11), np.uint16)
    oddeven = [np.zeros(n_blocks, np.int64), np.zeros(n_blocks, np.int64)]
    nonzero = [np.zeros(n_blocks, np.int64), np.zeros(n_blocks, np.int64)]
    pmul = np.zeros(n_blocks, np.int64)
    pixel_base = np.zeros(n_blocks, np.int64)
    field = 0
    for pix in range(11):
        if pix % 3 == 2:
            base = f[:, field]
            field += 1
            base = np.where(base == 3, 4, base)
            pixel_base = np.int64(0x200) << base
            pmul = np.int64(1) << base
        epixel = f[:, field]
        field += 1
        par = pix & 1
        first = oddeven[par] == 0
        # Continuation branch: scale by pmul, add the running predictor's
        # offset above pixel_base (skipped at the largest base).
        cont = epixel * pmul + np.where(
            (pixel_base < 0x2000) & (nonzero[par] > pixel_base),
            nonzero[par] - pixel_base,
            0,
        )
        nonzero[par] = np.where(first, np.where(epixel != 0, epixel, nonzero[par]), cont)
        value = np.where(first, np.where(epixel != 0, epixel, nonzero[par]), cont)
        oddeven[par] = np.where(first, epixel, oddeven[par])
        spix = value - 0xF
        out[:, pix] = np.where(
            spix <= 0xFFFF, spix & 0xFFFF, np.where(value >= 0x1000F, 0x3FFF, 0)
        ).astype(np.uint16)
    return out.reshape(height, width)


def read_rw2(buf: bytes, path: str) -> RawImage:
    endian = "<"
    (first_ifd,) = struct.unpack_from(endian + "I", buf, 4)
    ifd, _ = _read_ifd(buf, first_ifd, endian)

    def tag(t, default=None):
        v = ifd.get(t)
        return v if v is not None else default

    full_w = int(tag(0x0002, [0])[0])
    full_h = int(tag(0x0003, [0])[0])
    if not full_w or not full_h:
        raise ValueError(f"{path}: RW2 missing sensor dimensions")
    from raw2film_tpu_torch.io.dng import _check_dims

    _check_dims(full_w, full_h, path)
    bits = int(tag(0x000A, [12])[0])
    raw_format = int(tag(0x002D, [0])[0])
    off_entry = tag(0x0118)
    if not off_entry:
        raise NotImplementedError(f"{path}: RW2 without RawDataOffset (0x0118)")
    offset = int(off_entry[0])
    payload = buf[offset:]
    n = full_w * full_h

    # Tag-less (raw_format 0) files distinguish by payload size: plain
    # 12-bit packing is exactly 1.5 bytes/px; the v4 bitstream compresses
    # well below that (dcraw uses the same size discrimination).
    is_packed12 = bits == 12 and 3 * n <= 2 * len(payload) < 4 * n
    if raw_format == 4 or (
        raw_format == 0 and len(payload) < 2 * n and not is_packed12
    ):
        from raw2film_tpu_torch.native import decode_rw2_v4

        if full_w % 14 != 0:
            raise NotImplementedError(
                f"{path}: RW2 v4 with width {full_w} not a multiple of 14"
            )
        data = decode_rw2_v4(bytes(payload), full_w, full_h).astype(np.float32)
    elif raw_format == 5:
        data = decode_rw2_v5(bytes(payload), full_w, full_h, bits).astype(
            np.float32
        )
    elif raw_format == 6:
        data = decode_rw2_v6(bytes(payload), full_w, full_h, bits).astype(
            np.float32
        )
    elif raw_format == 7:
        data = decode_rw2_v7(bytes(payload), full_w, full_h, bits).astype(
            np.float32
        )
    elif len(payload) >= 2 * n:
        data = np.frombuffer(payload, "<u2", count=n).astype(np.float32)
        data = data.reshape(full_h, full_w)
    elif is_packed12:
        data = _unpack12_le(payload, n).astype(np.float32).reshape(full_h, full_w)
    else:
        raise NotImplementedError(
            f"{path}: RW2 RawFormat {raw_format} payload "
            f"({len(payload)} bytes for {n} samples) is not supported "
            "(v4, v5, v6, v7, 16-bit and 12-bit-packed are; convert to DNG)"
        )

    # Active-area crop (even Bayer phase, like the Canon SensorInfo path).
    top = int(tag(0x0004, [0])[0])
    left = int(tag(0x0005, [0])[0])
    bottom = int(tag(0x0006, [full_h])[0])
    right = int(tag(0x0007, [full_w])[0])
    meta = {}
    if 0 <= top < bottom <= full_h and 0 <= left < right <= full_w:
        left += left % 2
        top += top % 2
        data = data[top:bottom, left:right]
        meta["EXIF:SensorLeftBorder"] = left
        meta["EXIF:SensorTopBorder"] = top

    cfa = _CFA.get(int(tag(0x0009, [1])[0]), "RGGB")
    # Per-channel blacks (tags store the value minus the +15 pedestal that
    # LibRaw/rawspeed add back); collapse to the mean like the DNG path.
    # The v6 block code subtracts the pedestal in-stream (value - 0xf), so
    # its tag blacks apply directly.
    blacks = [int(tag(t, [0])[0]) for t in (0x001C, 0x001D, 0x001E)]
    pedestal = 0.0 if raw_format == 6 else 15.0
    black = float(np.mean(blacks)) + pedestal if any(blacks) else pedestal
    white = float((1 << bits) - 1)

    for name, t in (("Make", 0x010F), ("Model", 0x0110)):
        if t in ifd:
            meta[f"EXIF:{name}"] = ifd[t]
    if 0x0112 in ifd:
        meta["EXIF:Orientation"] = int(ifd[0x0112][0])
    if 0x0017 in ifd:
        meta["EXIF:ISO"] = int(ifd[0x0017][0])
    # Shot EXIF (exposure/aperture/lens) from the standard ExifIFD — feeds
    # auto exposure and lens-profile matching like the DNG path.
    exif_ptr = ifd.get(0x8769)
    if exif_ptr:
        try:
            exif, _ = _read_ifd(buf, int(exif_ptr[0]), endian)
        except (ValueError, struct.error):
            exif = {}
        from raw2film_tpu_torch.io.dng import _TAGS

        for name in ("ExposureTime", "FNumber", "ISO", "FocalLength", "LensModel"):
            tag = _TAGS[name]
            if tag in exif and f"EXIF:{name}" not in meta:
                v = exif[tag]
                meta[f"EXIF:{name}"] = v[0] if isinstance(v, list) else v

    return RawImage(
        data=data,
        cfa_pattern=cfa,
        black_level=black,
        white_level=white,
        color_matrix=None,
        as_shot_neutral=None,
        metadata=meta,
    )
