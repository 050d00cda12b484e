"""Fuji RAF container decode.

The reference ingests RAF via LibRaw (reference:
src/raw2film/raw_conversion.py:36-48; extension list
src/raw2film/data.py:87-102). RAF is Fuji's own container:

* Fixed big-endian header: magic ``FUJIFILMCCD-RAW``, camera string at
  0x1C, then an offset table — 0x54 JPEG offset/length, 0x5C CFA-header
  offset/length, 0x64 CFA-data offset/length.
* **CFA header**: a count-prefixed list of (tag u16, size u16, data)
  records — 0x0100 RawImageFullSize (height, width), 0x0121 RawImageSize,
  0x0130 FujiLayout, 0x0131 XTransLayout (36 bytes, 0=R 1=G 2=B — the 6x6
  X-Trans mosaic).
* **CFA data**: either the bare sensor dump (older bodies) or an embedded
  little-endian TIFF whose FujiIFD (tag 0xF000) carries RawImageFullWidth/
  Height (0xF001/2), BitsPerSample (0xF003), StripOffsets/ByteCounts
  (0xF007/8, relative to the embedded TIFF) and BlackLevel (0xF00A).

Uncompressed payloads (16-bit little-endian; 12/14-bit packed inferred
from byte counts) decode for both Bayer and X-Trans mosaics — X-Trans
demosaics through the generic masked-interpolation kernel
(:func:`raw2film_tpu_torch.ops.demosaic.demosaic_masked`). Lossless-compressed
payloads (the default on modern X/GFX bodies) are detected by their
16-byte header and decode through the threaded native strip decoder
(``r2f_decode_fuji`` — see the compatibility note in
native/r2f_native.cc: reconstructed schedule, clean abort on mismatch).
"""

from __future__ import annotations

import struct

import numpy as np

from raw2film_tpu_torch.io.dng import RawImage, _read_ifd, _unpack_12bit, _unpack_14bit

# The canonical X-Trans 6x6 layout shared by every X-Trans sensor
# generation (row-major, as in the RAF 0x0131 record).
XTRANS_CANONICAL = (
    "GGRGGB"
    "GGBGGR"
    "BRGRBG"
    "GGBGGR"
    "GGRGGB"
    "RBGBRG"
)

_CODES = {0: "R", 1: "G", 2: "B"}


def _parse_cfa_header(buf: bytes, off: int) -> dict:
    """Record list: u32-BE count, then (tag u16, size u16, data)."""
    out: dict = {}
    try:
        (count,) = struct.unpack_from(">I", buf, off)
        pos = off + 4
        for _ in range(min(count, 256)):
            tag, size = struct.unpack_from(">HH", buf, pos)
            data = buf[pos + 4 : pos + 4 + size]
            pos += 4 + size
            if tag == 0x0100 and size >= 4:
                h, w = struct.unpack_from(">HH", data, 0)
                out["full_size"] = (h, w)
            elif tag == 0x0131 and size >= 36:
                out["xtrans"] = "".join(
                    _CODES.get(b, "G") for b in data[:36]
                )
            elif tag == 0x0130:
                out["layout"] = bytes(data)
    except struct.error:
        pass
    return out


def _parse_fuji_tiff(buf: bytes, base: int) -> dict | None:
    """Embedded TIFF at the CFA-data offset: FujiIFD 0xF000 -> raw tags.
    All offsets are relative to the embedded TIFF start."""
    bom = buf[base : base + 2]
    endian = {"II": "<", "MM": ">"}.get(bom.decode("latin1", "replace"))
    if endian is None:
        return None
    try:
        (magic, first) = struct.unpack_from(endian + "HI", buf, base + 2)
        if magic != 42:
            return None
        sub = buf[base:]
        ifd, _ = _read_ifd(sub, first, endian)
        fuji_ptr = ifd.get(0xF000)
        if fuji_ptr:
            ifd, _ = _read_ifd(sub, int(fuji_ptr[0]), endian)
        out = {"endian": endian}
        if 0xF001 in ifd:
            out["width"] = int(ifd[0xF001][0])
        if 0xF002 in ifd:
            out["height"] = int(ifd[0xF002][0])
        if 0xF003 in ifd:
            out["bits"] = int(ifd[0xF003][0])
        if 0xF007 in ifd and 0xF008 in ifd:
            out["strips"] = [
                (base + int(o), int(c))
                for o, c in zip(ifd[0xF007], ifd[0xF008])
            ]
        if 0xF00A in ifd:
            blacks = ifd[0xF00A]
            if isinstance(blacks, list) and blacks:
                out["black"] = float(np.mean(blacks))
        return out
    except (struct.error, ValueError):
        return None


def _parse_compressed_header(payload: bytes) -> dict | None:
    """The lossless-compressed payload leads with a 16-byte big-endian
    header: signature 0x4953, version 1, raw type (16 = X-Trans, 0 =
    Bayer), bits, height, rounded width, width, strip size, strips per
    row, line-set count. See native/r2f_native.cc for the codec notes."""
    if len(payload) < 16:
        return None
    try:
        sig, ver, rtype, rbits, rh, rrw, rw, bsize, bir, tlines = (
            struct.unpack_from(">HBBBHHHHBH", payload, 0)
        )
    except struct.error:
        return None
    if sig != 0x4953 or ver != 1 or rtype not in (0, 16):
        return None
    if rbits not in (12, 14, 16) or not bir or not tlines or not rw or not rh:
        return None
    return {
        "xtrans": rtype == 16,
        "bits": rbits,
        "height": rh,
        "rounded_width": rrw,
        "width": rw,
        "block_size": bsize,
        "blocks_in_row": bir,
        "total_lines": tlines,
    }


def _decode_compressed(payload: bytes, comp: dict, pattern: str, path: str):
    from raw2film_tpu_torch import native

    table_len = 4 * comp["blocks_in_row"]
    if table_len & 0xC:
        table_len += 0x10 - (table_len & 0xC)
    if len(payload) < 16 + table_len:
        raise ValueError(f"{path}: truncated Fuji-compressed strip table")
    sizes = np.frombuffer(
        payload, ">u4", count=comp["blocks_in_row"], offset=16
    ).astype(np.uint32)
    return native.decode_fuji(
        payload[16 + table_len :],
        sizes,
        comp["bits"],
        pattern,
        comp["width"],
        comp["height"],
        comp["rounded_width"],
        comp["block_size"],
        comp["total_lines"],
    )


def extract_preview(buf: bytes) -> bytes | None:
    """The embedded preview JPEG (offset-table slot 0x54) — RAF's only
    EXIF carrier, and the thumbnail source (io/thumbnail.py)."""
    if not buf.startswith(b"FUJIFILM"):
        return None
    try:
        jpg_off, jpg_len = struct.unpack_from(">II", buf, 0x54)
    except struct.error:
        return None
    if not jpg_off or not jpg_len or jpg_off + jpg_len > len(buf):
        return None
    jpg = buf[jpg_off : jpg_off + jpg_len]
    return jpg if jpg[:2] == b"\xff\xd8" else None


def _base_meta(buf: bytes, model: str) -> dict:
    """Make/Model plus the shot EXIF from the embedded preview JPEG."""
    from raw2film_tpu_torch.io.dng import exif_from_jpeg

    meta = {"EXIF:Make": "FUJIFILM"}
    if model:
        meta["EXIF:Model"] = model
    jpg = extract_preview(buf)
    if jpg:
        meta.update(exif_from_jpeg(jpg))
    meta.setdefault("EXIF:Make", "FUJIFILM")
    return meta


def read_raf(buf: bytes, path: str) -> RawImage:
    if not buf.startswith(b"FUJIFILM"):
        raise ValueError(f"{path}: not a RAF file")
    model = buf[0x1C:0x3C].split(b"\0")[0].decode("ascii", "replace").strip()
    cfa_hdr_off, cfa_hdr_len, cfa_off, cfa_len = struct.unpack_from(
        ">IIII", buf, 0x5C
    )
    hdr = _parse_cfa_header(buf, cfa_hdr_off) if cfa_hdr_off else {}
    tiff = _parse_fuji_tiff(buf, cfa_off) if cfa_off else None

    sample_endian = "<"
    if tiff and "strips" in tiff:
        w = tiff.get("width", hdr.get("full_size", (0, 0))[1])
        h = tiff.get("height", hdr.get("full_size", (0, 0))[0])
        bits = tiff.get("bits", 14)
        payload = b"".join(buf[o : o + c] for o, c in tiff["strips"])
        black = tiff.get("black", 0.0)
        sample_endian = tiff.get("endian", "<")
    else:
        if "full_size" not in hdr:
            raise NotImplementedError(
                f"{path}: RAF without a parseable CFA header or Fuji IFD"
            )
        h, w = hdr["full_size"]
        bits = 14
        payload = buf[cfa_off : cfa_off + (cfa_len or len(buf) - cfa_off)]
        black = 0.0
    if not w or not h:
        raise ValueError(f"{path}: RAF missing raw dimensions")
    from raw2film_tpu_torch.io.dng import _check_dims

    _check_dims(int(w), int(h), path)

    cfa = hdr.get("xtrans")

    comp = _parse_compressed_header(payload)
    if comp is not None:
        if comp["xtrans"]:
            pattern = cfa if cfa and len(cfa) == 36 else XTRANS_CANONICAL
        else:
            pattern = cfa if cfa and len(cfa) == 4 else "RGGB"
        h, w, bits = comp["height"], comp["width"], comp["bits"]
        _check_dims(int(w), int(h), path)
        data = _decode_compressed(payload, comp, pattern, path).astype(
            np.float32
        )
        meta = _base_meta(buf, model)
        return RawImage(
            data=data,
            cfa_pattern=pattern,
            black_level=black,
            white_level=float((1 << bits) - 1),
            color_matrix=None,
            as_shot_neutral=None,
            metadata=meta,
        )

    n = h * w
    if len(payload) >= 2 * n:
        # Sample byte order follows the embedded Fuji TIFF's BOM.
        data = np.frombuffer(payload, sample_endian + "u2", count=n).astype(
            np.float32
        )
    elif bits == 12 and len(payload) * 2 >= 3 * n:
        data = _unpack_12bit(payload, n).astype(np.float32)
    elif bits == 14 and len(payload) * 4 >= 7 * n:
        data = _unpack_14bit(payload, n).astype(np.float32)
    else:
        raise NotImplementedError(
            f"{path}: unrecognized RAF payload layout ({len(payload)} "
            f"bytes for {n} {bits}-bit samples, no lossless-compression "
            "header); convert to DNG"
        )
    data = data.reshape(h, w)

    cfa = hdr.get("xtrans")
    if cfa is None:
        # No X-Trans record: Bayer body (GFX / X-A / early FinePix).
        cfa = "RGGB"

    meta = _base_meta(buf, model)
    return RawImage(
        data=data,
        cfa_pattern=cfa,
        black_level=black,
        white_level=float((1 << bits) - 1),
        color_matrix=None,
        as_shot_neutral=None,
        metadata=meta,
    )
