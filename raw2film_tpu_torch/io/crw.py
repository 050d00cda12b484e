"""Canon CRW (CIFF) container support: browsing + raw payload decode.

The reference ingests CRW via LibRaw (reference:
src/raw2film/raw_conversion.py:36-48; extension list
src/raw2film/data.py:87-102). CRW is Canon's pre-CR2 CIFF container
(1996-2004 bodies): a 26-byte header (byte order, heap start, ``HEAPCCDR``
magic) followed by a heap whose directory sits at the END — the last 4
bytes of the heap give the directory offset, then u16 record count and
10-byte records (type u16, length u32, offset u32, heap-relative).

Record semantics (CIFF spec): the type's high bits select storage —
``& 0x4000`` means the 8 length/offset bytes ARE the value; type-class
``0x28xx``/``0x30xx`` records are nested sub-heaps. Tags used here:
``0x2007`` embedded JPEG thumbnail, ``0x080a`` make+model strings
(NUL-separated), ``0x080b`` firmware, ``0x0810`` owner, ``0x180e``
capture time (u32 unix), ``0x1810`` image width/height, ``0x1031``
SensorInfo (raw dims + active-area borders), ``0x1835`` DecoderTable.

The compressed raw payload (the old 10-bit Canon Huffman codec) decodes
through the native kernel (:func:`raw2film_tpu_torch.native.decode_crw`) —
fixed-offset layout per the codec: an optional 2-bit low-bits plane at
file offset 26, the byte-stuffed Huffman stream at 540 (+ plane size).
"""

from __future__ import annotations

import struct

import numpy as np

_HEAP_MAGIC = b"HEAPCCDR"


def is_crw(buf: bytes) -> bool:
    return len(buf) >= 14 and buf[6:14] == _HEAP_MAGIC and buf[:2] in (b"II", b"MM")


def _walk_heap(buf: bytes, start: int, end: int, endian: str, out: dict, depth: int = 0):
    """Yield (type, payload) for every record, recursing into sub-heaps."""
    if depth > 4 or end - start < 4 or end > len(buf):
        return
    (dir_off,) = struct.unpack_from(endian + "I", buf, end - 4)
    pos = start + dir_off
    if not start <= pos <= end - 2:
        return
    (nrecs,) = struct.unpack_from(endian + "H", buf, pos)
    pos += 2
    for _ in range(min(nrecs, 256)):
        if pos + 10 > end:
            return
        typ, length, off = struct.unpack_from(endian + "HII", buf, pos)
        if typ & 0x4000:  # value stored in the 8 record bytes themselves
            payload = buf[pos + 2 : pos + 10]
        else:
            a0 = start + off
            if a0 < start or a0 + length > end:
                pos += 10
                continue
            payload = buf[a0 : a0 + length]
            if (typ >> 8) in (0x28, 0x30):  # nested sub-heap
                _walk_heap(buf, a0, a0 + length, endian, out, depth + 1)
                pos += 10
                continue
        out.setdefault(typ & 0x3FFF, payload)
        pos += 10


def _records(buf: bytes) -> tuple[dict, str]:
    endian = "<" if buf[:2] == b"II" else ">"
    (heap_start,) = struct.unpack_from(endian + "I", buf, 2)
    out: dict = {}
    if 14 <= heap_start < len(buf):
        _walk_heap(buf, heap_start, len(buf), endian, out)
    return out, endian


def extract_preview(buf: bytes) -> bytes | None:
    """Embedded JPEG thumbnail (CIFF tag 0x2007)."""
    if not is_crw(buf):
        return None
    recs, _ = _records(buf)
    jpg = recs.get(0x2007)
    if jpg and jpg[:2] == b"\xff\xd8":
        return bytes(jpg)
    return None


def extract_metadata(buf: bytes) -> dict:
    """Make/Model (+ capture time) from the CIFF heap."""
    if not is_crw(buf):
        return {}
    recs, endian = _records(buf)
    meta: dict = {}
    mm = recs.get(0x080A)
    if mm:
        parts = [p.decode("ascii", "replace") for p in bytes(mm).split(b"\0") if p]
        if parts:
            meta["EXIF:Make"] = parts[0].strip()
        if len(parts) > 1:
            meta["EXIF:Model"] = parts[1].strip()
    ts = recs.get(0x180E)
    if ts and len(ts) >= 4:
        (t,) = struct.unpack_from(endian + "I", ts, 0)
        if t:
            import datetime

            dt = datetime.datetime.fromtimestamp(t, datetime.timezone.utc)
            meta["EXIF:DateTimeOriginal"] = dt.strftime("%Y:%m:%d %H:%M:%S")
    return meta


def _has_lowbits(buf: bytes) -> bool:
    """Probe for the 2-bit low-bits plane (12-bit bodies) at offset 26.

    Codec property the probe exploits: a byte-stuffed Huffman stream never
    contains 0xFF followed by a nonzero byte, while the unconstrained
    low-bits plane almost surely does. Scan the first 16 KiB from offset
    540: 0xFF+nonzero proves a plane is present (the region is plane
    data); 0xFF+0x00 with no such proof means the stream itself starts at
    540 (no plane). No 0xFF at all defaults to plane-present.
    """
    window = buf[540 : 0x4000]
    ret = True
    for i in range(len(window) - 1):
        if window[i] == 0xFF:
            if window[i + 1]:
                return True
            ret = False
    return ret


def read_raw_payload(buf: bytes, path: str):
    """Decode the CRW compressed raw payload -> RawImage.

    Layout (fixed by the codec, not by heap offsets): low-bits plane at
    file offset 26 when present (``width*height/4`` bytes), Huffman
    bitstream at ``540 + plane_size``. Sensor dims + active-area crop come
    from CIFF SensorInfo (0x1031: u16s [1]=width [2]=height [5]=left
    [6]=top [7]=right [8]=bottom), the Huffman table choice from
    DecoderTable (0x1835, first u32). Matches the reference's LibRaw
    ingest semantics (reference: src/raw2film/raw_conversion.py:36-48).
    """
    from raw2film_tpu_torch import native
    from raw2film_tpu_torch.io.dng import RawImage

    recs, endian = _records(buf)
    sensor = recs.get(0x1031)
    if not sensor or len(sensor) < 6:
        raise ValueError(f"{path}: CRW heap has no SensorInfo (0x1031) record")
    vals = struct.unpack_from(endian + "H" * (len(sensor) // 2), sensor, 0)
    width, height = vals[1], vals[2]
    if not (0 < width <= 8192 and 0 < height <= 8192 and width % 8 == 0):
        raise ValueError(f"{path}: implausible CRW sensor dims {width}x{height}")
    table = 0
    dt = recs.get(0x1835)
    if dt and len(dt) >= 4:
        table = struct.unpack_from(endian + "I", dt, 0)[0]

    lowbits = _has_lowbits(buf)
    plane = None
    stream_off = 540
    if lowbits:
        plane_len = width * height // 4
        plane = bytes(buf[26 : 26 + plane_len])
        if len(plane) < plane_len:
            raise ValueError(f"{path}: CRW low-bits plane truncated")
        stream_off += plane_len
    if stream_off >= len(buf):
        raise ValueError(f"{path}: CRW bitstream missing (file too short)")
    data = native.decode_crw(
        bytes(buf[stream_off:]), plane, table, width, height
    ).astype(np.float32)
    white = 4095.0 if lowbits else 1023.0

    meta = extract_metadata(buf)
    pattern = "RGGB"  # every CIFF-era Canon sensor; crop keeps even phase
    black = 0.0
    if len(vals) >= 9:
        left, top, right, bottom = vals[5], vals[6], vals[7], vals[8]
        if 0 <= top < bottom < height and 0 <= left < right < width:
            left += left % 2
            top += top % 2
            # Optically black columns left of the active area give the
            # black level (dcraw's canon black strip); need a few masked
            # columns to be meaningful.
            if left >= 4:
                black = float(np.median(data[top : bottom + 1, : left - 1]))
            data = data[top : bottom + 1, left : right + 1]
            meta["EXIF:SensorLeftBorder"] = left
            meta["EXIF:SensorTopBorder"] = top
    return RawImage(
        data=data,
        cfa_pattern=pattern,
        black_level=black,
        white_level=white,
        color_matrix=None,
        as_shot_neutral=None,
        metadata=meta,
    )
