"""Canon CR3 container (ISO-BMFF) — preview + metadata extraction.

The CR3 raw payload (Canon's CRX codec) decodes through
:mod:`raw2film_tpu_torch.io.crx` (lossless path; see that module for the
compatibility contract). This module walks the ISO base media boxes for
the browsing surfaces —

* **metadata** from the ``CMT1`` box (a complete little-endian TIFF/EXIF
  block inside Canon's ``moov``-level uuid 85c0b687-820f-11e0-8111-
  f4ce462b6a48): Make/Model/Orientation + the EXIF subset the pipeline
  carries (reference's LibRaw metadata role).
* **previews**: the large ``PRVW`` JPEG (top-level uuid eaf42b5e-1c98-
  4b88-b9fb-b7dc406e4d16) or the small ``THMB`` JPEG — the viewer's
  thumbnail strip uses these exactly like rawpy's extract_thumb
  (reference: src/raw2film/image_bar.py:97-113).
"""

from __future__ import annotations

import struct

_CANON_UUID = bytes.fromhex("85c0b687820f11e08111f4ce462b6a48")
_PRVW_UUID = bytes.fromhex("eaf42b5e1c984b88b9fbb7dc406e4d16")


def _walk_boxes(buf: bytes, start: int, end: int):
    """Yield (type, usertype|None, payload_start, payload_end)."""
    pos = start
    while pos + 8 <= end:
        (size,) = struct.unpack_from(">I", buf, pos)
        btype = buf[pos + 4 : pos + 8]
        header = 8
        if size == 1:
            if pos + 16 > end:
                return
            (size,) = struct.unpack_from(">Q", buf, pos + 8)
            header = 16
        elif size == 0:
            size = end - pos
        usertype = None
        if btype == b"uuid":
            usertype = buf[pos + header : pos + header + 16]
            header += 16
        if size < header or pos + size > end:
            return
        yield btype, usertype, pos + header, pos + size
        pos += size


def _find_box(buf: bytes, start: int, end: int, path: list):
    """Descend a path of (type, usertype|None) pairs. Tries EVERY matching
    sibling (a failed descent into the first match must not mask data in a
    later one), and tolerates small prefix padding before child boxes
    (Canon's preview uuid carries a few bytes before its PRVW child)."""
    if not path:
        return start, end
    want_type, want_uuid = path[0]
    for off in (0, 8):
        if start + off >= end:
            break
        for btype, usertype, p0, p1 in _walk_boxes(buf, start + off, end):
            if btype == want_type and (
                want_uuid is None or usertype == want_uuid
            ):
                found = _find_box(buf, p0, p1, path[1:])
                if found is not None:
                    return found
    return None


def is_cr3(buf: bytes) -> bool:
    return len(buf) > 16 and buf[4:8] == b"ftyp" and buf[8:12] == b"crx "


def extract_preview(buf: bytes) -> bytes | None:
    """Largest embedded JPEG: PRVW, else THMB."""
    found = _find_box(
        buf, 0, len(buf), [(b"uuid", _PRVW_UUID), (b"PRVW", None)]
    )
    if found is not None:
        p0, p1 = found
        # PRVW payload: u32 ver/flags, u16 unknown, u16 w, u16 h, u16
        # unknown, u32 jpeg length, jpeg bytes.
        if p1 - p0 > 16:
            (jlen,) = struct.unpack_from(">I", buf, p0 + 12)
            j0 = p0 + 16
            if j0 + jlen <= p1 and buf[j0 : j0 + 2] == b"\xff\xd8":
                return buf[j0 : j0 + jlen]
    found = _find_box(
        buf,
        0,
        len(buf),
        [(b"moov", None), (b"uuid", _CANON_UUID), (b"THMB", None)],
    )
    if found is not None:
        p0, p1 = found
        # THMB payload: u32 ver/flags, u16 w, u16 h, u32 jpeg length, u32
        # unknown, jpeg bytes.
        if p1 - p0 > 16:
            (jlen,) = struct.unpack_from(">I", buf, p0 + 8)
            j0 = p0 + 16
            if j0 + jlen <= p1 and buf[j0 : j0 + 2] == b"\xff\xd8":
                return buf[j0 : j0 + jlen]
        # Fallback: scan the box for a JPEG SOI..EOI span.
        s = buf.find(b"\xff\xd8\xff", p0, p1)
        e = buf.rfind(b"\xff\xd9", p0, p1)
        if 0 <= s < e:
            return buf[s : e + 2]
    # Last resort for layout-variant preview uuids: SOI..EOI scan inside
    # the preview uuid region.
    found = _find_box(buf, 0, len(buf), [(b"uuid", _PRVW_UUID)])
    if found is not None:
        p0, p1 = found
        s = buf.find(b"\xff\xd8\xff", p0, p1)
        e = buf.rfind(b"\xff\xd9", p0, p1)
        if 0 <= s < e:
            return buf[s : e + 2]
    return None


def extract_metadata(buf: bytes) -> dict:
    """EXIF subset from the CMT1 TIFF block."""
    found = _find_box(
        buf,
        0,
        len(buf),
        [(b"moov", None), (b"uuid", _CANON_UUID), (b"CMT1", None)],
    )
    if found is None:
        return {}
    p0, p1 = found
    from raw2film_tpu_torch.io.dng import exif_from_tiff

    return exif_from_tiff(buf[p0:p1])
