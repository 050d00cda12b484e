"""Self-contained RAW container reader + DNG writer.

The reference leans on LibRaw via rawpy for container parsing + demosaic
(reference: src/raw2film/raw_conversion.py:33-53, supported extension list
src/raw2film/data.py:87-102). This framework owns its RAW path: a
pure-Python TIFF-family parser here, device-side demosaic in
:mod:`raw2film_tpu_torch.ops.demosaic`, native lossless-JPEG decode in
:mod:`raw2film_tpu_torch.native`, and a matching DNG writer used for synthetic
test fixtures.

Containers handled by :func:`read_raw`:

* **DNG** — uncompressed + lossless-JPEG (Compression 7), CFA + LinearRaw.
* **NEF/ARW/PEF** (TIFF dialects) — raw IFD discovered via photometric
  32803 across the IFD chain + SubIFDs; uncompressed strips stored 16-bit
  or bit-packed 12/14-bit (packing inferred from StripByteCounts);
  vendor black-level defaults where the TIFF-EP tags are absent.
* **ORF** — same TIFF structure under Olympus magics (0x4F52 'RO' /
  0x5352 'RS').
* **CR2** — lossless-JPEG raw IFD (Compression 6) decoded with the native
  SOF3 decoder, slice-interleaved columns reassembled via tag 0xC640.
* **Nikon-compressed NEF** (Compression 34713) — Huffman predictor
  bitstream + MakerNote 0x0096 linearization, decoded by the native kernel
  (:mod:`raw2film_tpu_torch.io.nef`).
* **RW2** — Panasonic magic-85 TIFF dialect (sensor borders, per-channel
  blacks, CFA code) with v4-compressed, 16-bit and 12-bit-packed payloads
  (:mod:`raw2film_tpu_torch.io.rw2`).
* **RAF** — Fuji container (offset table + CFA-header records + embedded
  Fuji TIFF), Bayer and X-Trans mosaics; X-Trans demosaics through the
  generic masked-interpolation kernel (:mod:`raw2film_tpu_torch.io.raf`).
* **Sony cRAW / ARW2** (Compression 32767) — 16-byte max/min + 7-bit-delta
  blocks via the native kernel, with the tone curve read from Sony's
  ENCRYPTED SR2 region (:mod:`raw2film_tpu_torch.io.sr2` implements
  sony_decrypt + the 0x7010 knot expansion; structural mismatch falls
  back to the linear expansion).
* **Pentax-Huffman PEF** (Compression 65535) — in-file Huffman table from
  MakerNote 0x0220 + two-column predictors (:mod:`raw2film_tpu_torch.io.pef`).
* **Olympus-compressed ORF** — carry-filter + gradient-predictor bitstream
  via the native kernel; detected by tag 65536 or (as real bodies write
  it) an undersized Compression=1 strip.

* **Panasonic RW2** — the v4 bitstream via the native kernel, the v5/v7
  LSB-first 16-byte packet layouts (12/14-bit) and the v6 differential
  block code via vectorized numpy (:mod:`raw2film_tpu_torch.io.rw2`), plus
  16-bit and 12-bit-packed layouts.

* **Canon CRW** — the pre-CR2 CIFF compressed payload via the native
  kernel (:mod:`raw2film_tpu_torch.io.crw`).

* **Canon CR3** — the CRX lossless payload (CRAW track + CMP1, subplane /
  wavelet / Golomb-Rice decode, :mod:`raw2film_tpu_torch.io.crx`); lossy CRAW
  raises a clear error (convert to DNG), and containers without a raw
  track still get browsing support (PRVW/THMB previews + CMT1 EXIF,
  :mod:`raw2film_tpu_torch.io.cr3`).

Also parsed: CFAPattern, BlackLevel/WhiteLevel, ColorMatrix1, AsShotNeutral,
core EXIF (ISO, exposure time, f-number, focal length, make/model/lens).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# TIFF tag ids
_TAGS = {
    "NewSubfileType": 254,
    "ImageWidth": 256,
    "ImageLength": 257,
    "BitsPerSample": 258,
    "Compression": 259,
    "Photometric": 262,
    "Make": 271,
    "Model": 272,
    "Orientation": 274,
    "StripOffsets": 273,
    "SamplesPerPixel": 277,
    "RowsPerStrip": 278,
    "StripByteCounts": 279,
    "TileWidth": 322,
    "TileLength": 323,
    "TileOffsets": 324,
    "TileByteCounts": 325,
    "SubIFDs": 330,
    "ExifIFD": 34665,
    "CFARepeatPatternDim": 33421,
    "CFAPattern": 33422,
    "DNGVersion": 50706,
    "BlackLevel": 50714,
    "WhiteLevel": 50717,
    "ColorMatrix1": 50721,
    "AsShotNeutral": 50728,
    # EXIF IFD
    "ExposureTime": 33434,
    "FNumber": 33437,
    "ISO": 34855,
    "FocalLength": 37386,
    "MakerNote": 37500,
    "LensModel": 42036,
    # Vendor
    "CR2Slices": 50752,
}

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}


@dataclass
class RawImage:
    """Decoded RAW container contents (host)."""

    data: np.ndarray  # (H, W) CFA mosaic or (H, W, C) linear
    cfa_pattern: str | None  # e.g. "RGGB"; None for linear
    black_level: float
    white_level: float
    color_matrix: np.ndarray | None  # (3, 3) XYZ -> camera (DNG ColorMatrix1)
    as_shot_neutral: np.ndarray | None
    metadata: dict = field(default_factory=dict)


def _read_ifd(buf: bytes, offset: int, endian: str) -> tuple[dict, int]:
    (count,) = struct.unpack_from(endian + "H", buf, offset)
    entries = {}
    pos = offset + 2
    for _ in range(count):
        tag, typ, n = struct.unpack_from(endian + "HHI", buf, pos)
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            raw = buf[pos + 8 : pos + 8 + size]
        else:
            (ptr,) = struct.unpack_from(endian + "I", buf, pos + 8)
            raw = buf[ptr : ptr + size]
        # A corrupted count must not drive a gigabyte unpack: clamp to what
        # the value block actually holds (fuzz suite finding).
        n = min(n, len(raw) // max(_TYPE_SIZES.get(typ, 1), 1))
        entries[tag] = _decode_values(raw, typ, n, endian)
        pos += 12
    (next_ifd,) = struct.unpack_from(endian + "I", buf, pos)
    return entries, next_ifd


def _entry_value_offset(
    buf: bytes, ifd_offset: int, endian: str, want_tag: int
) -> int | None:
    """File-absolute offset of a tag's value block (None if inline/absent)."""
    (count,) = struct.unpack_from(endian + "H", buf, ifd_offset)
    pos = ifd_offset + 2
    for _ in range(count):
        tag, typ, n = struct.unpack_from(endian + "HHI", buf, pos)
        if tag == want_tag:
            size = _TYPE_SIZES.get(typ, 1) * n
            if size <= 4:
                return pos + 8
            (ptr,) = struct.unpack_from(endian + "I", buf, pos + 8)
            return ptr
        pos += 12
    return None


def _decode_values(raw: bytes, typ: int, n: int, endian: str):
    if typ == 2:  # ASCII
        return raw.split(b"\0")[0].decode("ascii", "replace")
    fmt = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}.get(typ)
    if fmt:
        vals = struct.unpack_from(endian + fmt * n, raw)
        return list(vals)
    if typ in (5, 10):  # rational
        fmt = "II" if typ == 5 else "ii"
        vals = struct.unpack_from(endian + fmt * n, raw)
        return [vals[2 * i] / vals[2 * i + 1] if vals[2 * i + 1] else 0.0 for i in range(n)]
    return raw


_CFA_CODES = {0: "R", 1: "G", 2: "B"}

# TIFF magic numbers: classic TIFF (DNG/NEF/ARW/PEF/CR2), Olympus ORF,
# Panasonic RW2 (magic 85, dispatched to io.rw2).
_TIFF_MAGICS = {42, 0x4F52, 0x5352, 0x55}

# Vendor black-level defaults where the TIFF-EP tags are absent (the vendors
# store them in MakerNotes; these are the conventional sensor pedestals).
_MAKE_BLACK_DEFAULTS = {"SONY": 512.0}


def _unpack_12bit(payload: bytes, n: int) -> np.ndarray:
    """Big-endian MSB-first 12-bit packing: 3 bytes -> 2 samples."""
    b = np.frombuffer(payload, np.uint8)
    b = b[: (n + 1) // 2 * 3].reshape(-1, 3).astype(np.uint16)
    p0 = (b[:, 0] << 4) | (b[:, 1] >> 4)
    p1 = ((b[:, 1] & 0x0F) << 8) | b[:, 2]
    return np.stack([p0, p1], axis=1).ravel()[:n]


def _unpack_14bit(payload: bytes, n: int) -> np.ndarray:
    """Big-endian MSB-first 14-bit packing: 7 bytes -> 4 samples."""
    b = np.frombuffer(payload, np.uint8)
    b = b[: (n + 3) // 4 * 7].reshape(-1, 7).astype(np.uint16)
    p0 = (b[:, 0] << 6) | (b[:, 1] >> 2)
    p1 = ((b[:, 1] & 0x03) << 12) | (b[:, 2] << 4) | (b[:, 3] >> 4)
    p2 = ((b[:, 3] & 0x0F) << 10) | (b[:, 4] << 2) | (b[:, 5] >> 6)
    p3 = ((b[:, 5] & 0x3F) << 8) | b[:, 6]
    return np.stack([p0, p1, p2, p3], axis=1).ravel()[:n]


def _check_dims(w: int, h: int, path: str) -> None:
    """Plausibility cap on raw dimensions: a corrupted dimension field must
    raise, not drive a multi-GB allocation or a minutes-long decode loop
    (found by the fuzz suite, tests/test_raw_robustness.py)."""
    if not (0 < w <= 65535 and 0 < h <= 65535 and w * h <= (1 << 28)):
        raise ValueError(f"{path}: implausible raw dimensions {w}x{h}")


def exif_from_tiff(tiff: bytes) -> dict:
    """Make/Model/Orientation + the EXIF subset the pipeline uses (auto
    exposure, lens matching, export write-back) from a standalone TIFF/EXIF
    block — CR3's CMT1 box, a JPEG APP1 payload."""
    try:
        endian = {b"II": "<", b"MM": ">"}.get(tiff[:2])
        if endian is None:
            return {}
        (magic, first) = struct.unpack_from(endian + "HI", tiff, 2)
        if magic != 42:
            return {}
        ifd0, _ = _read_ifd(tiff, first, endian)
        meta = {}
        for name in ("Make", "Model"):
            if _TAGS[name] in ifd0:
                meta[f"EXIF:{name}"] = ifd0[_TAGS[name]]
        if _TAGS["Orientation"] in ifd0:
            meta["EXIF:Orientation"] = int(ifd0[_TAGS["Orientation"]][0])
        exif_ptr = ifd0.get(_TAGS["ExifIFD"])
        if exif_ptr:
            exif, _ = _read_ifd(tiff, int(exif_ptr[0]), endian)
            for name in ("ExposureTime", "FNumber", "ISO", "FocalLength", "LensModel"):
                tag = _TAGS[name]
                if tag in exif:
                    v = exif[tag]
                    meta[f"EXIF:{name}"] = v[0] if isinstance(v, list) else v
        return meta
    except Exception:
        return {}


def exif_from_jpeg(jpeg: bytes) -> dict:
    """EXIF from a JPEG's APP1 segment. RAF keeps the shot's full EXIF only
    inside its embedded preview JPEG (the CFA sections carry none), so this
    is how Fuji files get ISO/FocalLength/LensModel for auto exposure and
    lens-profile matching."""
    try:
        if jpeg[:2] != b"\xff\xd8":
            return {}
        i = 2
        while i + 4 <= len(jpeg) and jpeg[i] == 0xFF:
            marker = jpeg[i + 1]
            if marker in (0x01,) or 0xD0 <= marker <= 0xD8:
                i += 2
                continue
            (seglen,) = struct.unpack_from(">H", jpeg, i + 2)
            if seglen < 2:
                return {}
            if marker == 0xE1 and jpeg[i + 4 : i + 10] == b"Exif\x00\x00":
                return exif_from_tiff(jpeg[i + 10 : i + 2 + seglen])
            if marker == 0xDA:  # start of scan: no more metadata segments
                break
            i += 2 + seglen
        return {}
    except Exception:
        return {}


def read_raw(path: str) -> RawImage:
    """Decode any supported RAW container (see module docstring).

    Error contract: unsupported formats raise NotImplementedError with the
    remedy; malformed/truncated files raise ValueError — never an internal
    IndexError/struct.error (production batch runs isolate per-file
    failures on these types, pipeline/batch.py)."""
    try:
        return _read_raw(path)
    except (NotImplementedError, ValueError):
        raise
    except (struct.error, IndexError, KeyError, OverflowError) as e:
        raise ValueError(
            f"{path}: malformed or truncated RAW container ({type(e).__name__}: {e})"
        ) from e


def _read_raw(path: str) -> RawImage:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8].startswith(b"FUJIFILM"):
        from raw2film_tpu_torch.io.raf import read_raf

        return read_raf(buf, path)
    if len(buf) >= 8 and buf[4:8] == b"ftyp":
        from raw2film_tpu_torch.io.crx import read_raw_payload as read_crx

        return read_crx(buf, path)
    if len(buf) >= 14 and buf[6:14] == b"HEAPCCDR":
        from raw2film_tpu_torch.io.crw import read_raw_payload

        return read_raw_payload(buf, path)
    return _read_tiff_raw(buf, path)


def read_dng(path: str) -> RawImage:
    return read_raw(path)


def _read_tiff_raw(buf: bytes, path: str) -> RawImage:
    if buf[:2] == b"II":
        endian = "<"
    elif buf[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError(f"{path}: not a TIFF-family RAW file")
    (magic, first_ifd) = struct.unpack_from(endian + "HI", buf, 2)
    if magic not in _TIFF_MAGICS:
        raise ValueError(f"{path}: bad TIFF magic {magic}")
    if magic == 0x55:
        from raw2film_tpu_torch.io.rw2 import read_rw2

        return read_rw2(buf, path)
    is_cr2 = buf[8:10] == b"CR"

    # Collect IFDs: walk the chain plus SubIFDs. Visited-set + cap: a
    # corrupted next-IFD pointer must not loop forever (fuzz finding).
    ifds = []
    offset = first_ifd
    seen: set = set()
    while offset and offset not in seen and len(ifds) < 64:
        seen.add(offset)
        ifd, offset = _read_ifd(buf, offset, endian)
        ifds.append(ifd)
        for sub in (ifd.get(_TAGS["SubIFDs"], []) or [])[:16]:
            if sub in seen:
                continue
            seen.add(sub)
            sub_ifd, _ = _read_ifd(buf, sub, endian)
            ifds.append(sub_ifd)

    # Pick the raw IFD: CFA photometric preferred, else the largest image.
    def photometric(i):
        return (i.get(_TAGS["Photometric"]) or [0])[0]

    raw_ifds = [i for i in ifds if photometric(i) == 32803]
    if not raw_ifds and is_cr2:
        # CR2 raw IFD carries no photometric: it is the lossless-JPEG IFD
        # with the largest strip (the preview JPEGs use Compression 6 too
        # but are far smaller).
        cands = [
            i
            for i in ifds
            if (i.get(_TAGS["Compression"]) or [0])[0] == 6
            and _TAGS["StripByteCounts"] in i
        ]
        if cands:
            raw_ifds = [max(cands, key=lambda i: sum(i[_TAGS["StripByteCounts"]]))]
    if not raw_ifds:
        raw_ifds = [
            i
            for i in ifds
            if _TAGS["ImageWidth"] in i and _TAGS["StripOffsets"] in i
        ]
    if not raw_ifds:
        raise ValueError(f"{path}: no decodable image IFD")
    ifd = max(
        raw_ifds,
        key=lambda i: (i.get(_TAGS["ImageWidth"]) or [0])[0]
        * (i.get(_TAGS["ImageLength"]) or [0])[0]
        + sum(i.get(_TAGS["StripByteCounts"]) or [0]),
    )

    comp = (ifd.get(_TAGS["Compression"]) or [1])[0]
    if comp not in (1, 6, 7, 32767, 34713, 65535, 65536):
        raise NotImplementedError(
            f"{path}: compression {comp} is unsupported (uncompressed, "
            "lossless-JPEG, Nikon-compressed, Sony-cRAW, Pentax-Huffman "
            "and Olympus-compressed raws are handled; convert other "
            "vendor-compressed files to DNG)"
        )
    w = ifd[_TAGS["ImageWidth"]][0]
    h = ifd[_TAGS["ImageLength"]][0]
    _check_dims(w, h, path)
    bits = (ifd.get(_TAGS["BitsPerSample"]) or [16])[0]
    spp = (ifd.get(_TAGS["SamplesPerPixel"]) or [1])[0]
    if not 1 <= spp <= 4 or not 1 <= bits <= 16:
        raise ValueError(f"{path}: implausible bits/spp {bits}/{spp}")

    # Metadata first: the Nikon-compressed decode below needs the
    # MakerNote's linearization blob.
    ifd0 = ifds[0]
    meta = {}
    for name, tag in (("Make", _TAGS["Make"]), ("Model", _TAGS["Model"])):
        if tag in ifd0:
            meta[f"EXIF:{name}"] = ifd0[tag]
    # Camera orientation (TIFF tag 274) from IFD0 or the raw IFD: the
    # reference gets upright images for free from LibRaw's postprocess;
    # io.raw.decode_raw applies the equivalent rotation on device.
    orient = ifd0.get(_TAGS["Orientation"]) or ifd.get(_TAGS["Orientation"])
    if orient:
        meta["EXIF:Orientation"] = int(orient[0])
    exif_ptr = ifd0.get(_TAGS["ExifIFD"])
    sensor_info = None
    makernote: bytes | None = None
    if exif_ptr:
        exif, _ = _read_ifd(buf, exif_ptr[0], endian)
        for name in ("ExposureTime", "FNumber", "ISO", "FocalLength", "LensModel"):
            tag = _TAGS[name]
            if tag in exif:
                v = exif[tag]
                meta[f"EXIF:{name}"] = v[0] if isinstance(v, list) else v
        mn = exif.get(_TAGS["MakerNote"])
        if isinstance(mn, (bytes, bytearray)):
            makernote = bytes(mn)
        make = str(meta.get("EXIF:Make", ""))
        if is_cr2 or make.lower().startswith("canon"):
            mn_off = _entry_value_offset(
                buf, exif_ptr[0], endian, _TAGS["MakerNote"]
            )
            if mn_off is not None:
                try:
                    # Canon MakerNote is a plain IFD whose value offsets are
                    # file-absolute — the easy vendor.
                    mn_ifd, _ = _read_ifd(buf, mn_off, endian)
                    si = mn_ifd.get(0x00E0)
                    if si and len(si) >= 9:
                        sensor_info = [int(x) for x in si]
                except Exception:
                    sensor_info = None

    tiled = _TAGS["TileOffsets"] in ifd
    if comp == 7:
        from raw2film_tpu_torch.native import decode_ljpeg

        data = np.zeros((h, w, spp), np.float32)
        if tiled:
            tw = ifd[_TAGS["TileWidth"]][0]
            tl = ifd[_TAGS["TileLength"]][0]
            offsets = ifd[_TAGS["TileOffsets"]]
            counts = ifd[_TAGS["TileByteCounts"]]
            tiles_across = (w + tw - 1) // tw

            def _one_tile(args):
                idx, o, cnt = args
                flat, dw, dh, dc = decode_ljpeg(
                    bytes(buf[o : o + cnt]), tw * tl * spp * 2
                )
                # DNG LJPEG tiles often split a row into 2 components; fold
                # components back into width.
                tile = flat.reshape(dh, dw * dc)
                ty = (idx // tiles_across) * tl
                tx = (idx % tiles_across) * tw
                eh = min(tl, h - ty)
                ew = min(tw, w - tx)
                data[ty : ty + eh, tx : tx + ew, 0] = tile[:eh, :ew]

            jobs = [(i, o, c) for i, (o, c) in enumerate(zip(offsets, counts))]
            if len(jobs) > 1:
                # Tiles are independent and the native decoder runs outside
                # the GIL (ctypes): a thread pool parallelizes the host
                # decode — the wall-clock bottleneck of batch export.
                import concurrent.futures as _cf

                from raw2film_tpu_torch.utils.workers import decode_workers

                workers = decode_workers(len(jobs))
                with _cf.ThreadPoolExecutor(max_workers=workers) as ex:
                    list(ex.map(_one_tile, jobs))
            else:
                for job in jobs:
                    _one_tile(job)
        else:
            offsets = ifd[_TAGS["StripOffsets"]]
            counts = ifd[_TAGS["StripByteCounts"]]
            rows_per = (ifd.get(_TAGS["RowsPerStrip"]) or [h])[0]
            y = 0
            for o, cnt in zip(offsets, counts):
                flat, dw, dh, dc = decode_ljpeg(
                    bytes(buf[o : o + cnt]), w * rows_per * spp * 2
                )
                strip = flat.reshape(dh, dw * dc)
                eh = min(dh, h - y)
                if spp == 1:
                    data[y : y + eh, :, 0] = strip[:eh, :w]
                else:
                    data[y : y + eh] = strip[:eh, : w * spp].reshape(eh, w, spp)
                y += dh
        data = data[..., 0] if spp == 1 else data
    elif comp == 34713:
        # Nikon-compressed NEF: Huffman predictor bitstream; metadata lives
        # in MakerNote tag 0x0096 (version, vpred, linearization curve).
        from raw2film_tpu_torch.io import nef as nefmod

        if makernote is None:
            raise NotImplementedError(
                f"{path}: Nikon-compressed NEF without a readable MakerNote"
            )
        found = nefmod.find_nikon_makernote(makernote, 0, len(makernote))
        if found is None:
            raise NotImplementedError(
                f"{path}: unrecognized Nikon MakerNote layout"
            )
        mn_base, mn_endian = found
        blob = nefmod.read_makernote_tag(makernote, mn_base, mn_endian, 0x0096)
        if blob is None:
            raise NotImplementedError(
                f"{path}: NEF linearization table (MakerNote 0x0096) missing"
            )
        offsets = ifd[_TAGS["StripOffsets"]]
        counts = ifd[_TAGS["StripByteCounts"]]
        payload = b"".join(buf[o : o + c] for o, c in zip(offsets, counts))
        data = nefmod.decode_nef_compressed(
            payload, bytes(blob), mn_endian, w, h, bits
        ).astype(np.float32)
    elif comp == 65536:
        # Olympus-compressed: carry-filter + gradient-predictor bitstream.
        from raw2film_tpu_torch.native import decode_orf

        offsets = ifd[_TAGS["StripOffsets"]]
        counts = ifd[_TAGS["StripByteCounts"]]
        payload = b"".join(buf[o : o + c] for o, c in zip(offsets, counts))
        data = decode_orf(payload, w, h).astype(np.float32)
    elif comp == 65535:
        # Pentax-Huffman PEF: in-file Huffman table (MakerNote 0x0220) +
        # NEF-style two-column predictors.
        from raw2film_tpu_torch.io import pef as pefmod

        if makernote is None:
            raise NotImplementedError(
                f"{path}: Pentax-compressed PEF without a readable MakerNote"
            )
        offsets = ifd[_TAGS["StripOffsets"]]
        counts = ifd[_TAGS["StripByteCounts"]]
        payload = b"".join(buf[o : o + c] for o, c in zip(offsets, counts))
        data = pefmod.decode_pef_compressed(payload, makernote, w, h).astype(
            np.float32
        )
    elif comp == 32767:
        # Sony cRAW / ARW2: 16-byte blocks of 16 same-phase pixels (11-bit
        # max/min + 7-bit deltas) expanded through a decompanding curve.
        # The real tone curve lives in Sony's ENCRYPTED SR2 region — io.sr2
        # decrypts and reads it (tag 0x7010 knots); any structural mismatch
        # falls back to the linear no-curve expansion.
        from raw2film_tpu_torch.io import sr2 as sr2mod
        from raw2film_tpu_torch.native import decode_arw2

        offsets = ifd[_TAGS["StripOffsets"]]
        counts = ifd[_TAGS["StripByteCounts"]]
        payload = b"".join(buf[o : o + c] for o, c in zip(offsets, counts))
        found = sr2mod.try_read_arw2_curve(buf, makernote)
        curve = None
        if found is not None:
            curve, white_override = found
            meta["EXIF:SonyToneCurve"] = "sr2"
        data = decode_arw2(payload, w, h, curve).astype(np.float32)
        bits = 14  # decoded values are linear 14-bit regardless of storage
        if found is not None:
            ifd.setdefault(_TAGS["WhiteLevel"], [int(white_override)])
    elif comp == 6:
        # CR2: one lossless-JPEG blob; columns stored as vertical slices
        # (tag 0xC640: [n, slice_w, last_slice_w]).
        from raw2film_tpu_torch.native import decode_ljpeg

        offsets = ifd[_TAGS["StripOffsets"]]
        counts = ifd[_TAGS["StripByteCounts"]]
        blob0 = bytes(buf[offsets[0] : offsets[0] + counts[0]])
        sof3 = blob0.find(b"\xff\xc3")
        if sof3 >= 0 and _TAGS["BitsPerSample"] not in ifd:
            bits = blob0[sof3 + 4]  # SOF3 sample precision
        flat, dw, dh, dc = decode_ljpeg(blob0, (h * w + 16) * 2)
        full_w = dw * dc
        if not w or not h:
            w, h = full_w, dh
        slices = ifd.get(_TAGS["CR2Slices"])
        frame = np.empty((dh, full_w), np.float32)
        if slices and len(slices) == 3 and slices[0]:
            n_sl, w_a, w_b = int(slices[0]), int(slices[1]), int(slices[2])
            widths = [w_a] * n_sl + [w_b]
            flat = flat[: dh * full_w]
            pos = 0
            x0 = 0
            for wi in widths:
                frame[:, x0 : x0 + wi] = flat[pos : pos + dh * wi].reshape(dh, wi)
                pos += dh * wi
                x0 += wi
        else:
            frame[:] = flat[: dh * full_w].reshape(dh, full_w)
        data = frame[:h, :w]
    else:
        offsets = ifd[_TAGS["StripOffsets"]]
        counts = ifd.get(_TAGS["StripByteCounts"]) or [h * w * spp * bits // 8]
        # One strip stays a view on the file's bytes; several are joined once.
        strips = [memoryview(buf)[o : o + c] for o, c in zip(offsets, counts)]
        payload = strips[0] if len(strips) == 1 else b"".join(strips)
        n = h * w * spp
        if bits == 8:
            data = np.frombuffer(payload, np.uint8, count=n).astype(np.float32)
        elif len(payload) >= 2 * n:
            # 16-bit codes stay uint16 in host byte order: no copy where the
            # file's order is the host's (torch takes no other order).
            data = np.frombuffer(payload, np.dtype(endian + "u2"), count=n).astype(
                "=u2", copy=False
            )
        elif bits == 12 and len(payload) * 2 >= 3 * n:
            # NEF/ORF-style bit-packed strips (inferred from byte counts).
            data = _unpack_12bit(payload, n).astype(np.float32)
        elif bits == 14 and len(payload) * 4 >= 7 * n:
            data = _unpack_14bit(payload, n).astype(np.float32)
        elif magic in (0x4F52, 0x5352) and spp == 1:
            # Olympus bodies leave Compression=1 on compressed payloads;
            # the undersized strip is the tell (LibRaw does the same
            # size-based detection).
            from raw2film_tpu_torch.native import decode_orf

            data = decode_orf(bytes(payload), w, h).astype(np.float32)
        else:
            raise NotImplementedError(
                f"{path}: cannot infer sample packing "
                f"({len(payload)} bytes for {n} {bits}-bit samples)"
            )
        data = data.reshape((h, w) if spp == 1 else (h, w, spp))

    cfa = None
    if photometric(ifd) == 32803:
        pat = ifd.get(_TAGS["CFAPattern"])
        if pat is None:
            cfa = "RGGB"
        else:
            cfa = "".join(_CFA_CODES.get(int(v), "G") for v in bytes(bytearray(int(x) for x in pat)))

    def tag0(name, default=None):
        v = ifd.get(_TAGS[name]) or ifd0.get(_TAGS[name])
        return v if v is not None else default

    black_tag = tag0("BlackLevel")
    black = float(np.mean(black_tag)) if black_tag is not None else None
    white = float(tag0("WhiteLevel", [(1 << bits) - 1])[0])

    if sensor_info is not None and data.ndim == 2:
        # Canon SensorInfo: [_, w, h, _, _, left, top, right, bottom, ...];
        # the masked region left of `left` is the optical-black pedestal.
        left, top, right, bottom = sensor_info[5:9]
        if 0 <= top < bottom < data.shape[0] and 0 <= left < right < data.shape[1]:
            if black is None and left >= 8:
                black = float(np.median(data[top : bottom + 1, : left - 2]))
            # Even Bayer phase: start the crop on an even coordinate.
            left += left % 2
            top += top % 2
            data = data[top : bottom + 1, left : right + 1]
            meta["EXIF:SensorLeftBorder"] = left
            meta["EXIF:SensorTopBorder"] = top
    if black is None:
        make = str(meta.get("EXIF:Make", "")).upper()
        black = next(
            (v for k, v in _MAKE_BLACK_DEFAULTS.items() if k in make), 0.0
        )
    cm = tag0("ColorMatrix1")
    color_matrix = (
        np.asarray(cm, np.float64).reshape(3, 3) if cm is not None and len(cm) == 9 else None
    )
    asn = tag0("AsShotNeutral")
    return RawImage(
        data=data,
        cfa_pattern=cfa,
        black_level=black,
        white_level=white,
        color_matrix=color_matrix,
        as_shot_neutral=np.asarray(asn, np.float64) if asn else None,
        metadata=meta,
    )


# ------------------------------------------------------------------ writer


def _entry(endian, tag, typ, values, heap, heap_base):
    if typ == 2:
        raw = values.encode("ascii") + b"\0"
        n = len(raw)
    elif typ in (5, 10):
        fmt = "II" if typ == 5 else "ii"
        raw = b"".join(struct.pack(endian + fmt, *v) for v in values)
        n = len(values)
    else:
        fmt = {1: "B", 3: "H", 4: "I", 11: "f", 12: "d"}[typ]
        raw = struct.pack(endian + fmt * len(values), *values)
        n = len(values)
    if len(raw) <= 4:
        inline = raw + b"\0" * (4 - len(raw))
        return struct.pack(endian + "HHI", tag, typ, n) + inline
    ptr = heap_base + len(heap)
    heap += raw if len(raw) % 2 == 0 else raw + b"\0"
    return struct.pack(endian + "HHI", tag, typ, n) + struct.pack(endian + "I", ptr)


def write_dng(
    path: str,
    mosaic: np.ndarray,
    cfa_pattern: str = "RGGB",
    black_level: int = 0,
    white_level: int = 65535,
    color_matrix: np.ndarray | None = None,
    iso: int = 100,
    exposure_time: float = 1 / 125,
    f_number: float = 4.0,
    make: str = "raw2film-tpu",
    model: str = "synthetic",
    compression: int = 1,
    orientation: int | None = None,
) -> None:
    """Write a minimal 16-bit CFA DNG (test fixtures). ``compression``:
    1 = none, 7 = lossless JPEG (SOF3, via io.ljpeg)."""
    endian = "<"
    h, w = mosaic.shape
    pixels = np.clip(np.asarray(mosaic), 0, white_level).astype(np.uint16)
    if compression == 7:
        from raw2film_tpu_torch.io.ljpeg import encode_ljpeg

        data = encode_ljpeg(pixels)
    else:
        data = pixels.astype("<u2").tobytes()
    code = {"R": 0, "G": 1, "B": 2}
    cfa_bytes = [code[c] for c in cfa_pattern]
    if color_matrix is None:
        # XYZ(D65) -> sRGB-primaries camera: the standard matrix, so that
        # inverse-decoding returns honest XYZ.
        from raw2film_tpu_torch.data import XYZ_TO_REC709

        color_matrix = XYZ_TO_REC709

    # Layout: [header][IFD0][EXIF IFD][heap][pixel data]
    header_size = 8
    n_ifd0 = 19 + (1 if orientation is not None else 0)
    n_exif = 3
    ifd0_size = 2 + n_ifd0 * 12 + 4
    exif_size = 2 + n_exif * 12 + 4
    heap_base = header_size + ifd0_size + exif_size
    exif_offset = header_size + ifd0_size
    heap = bytearray()
    entries = []

    def E(tag, typ, values):
        entries.append(_entry(endian, tag, typ, values, heap, heap_base))

    # NOTE: entries must be ascending by tag id.
    E(254, 4, [0])
    E(256, 4, [w])
    E(257, 4, [h])
    E(258, 3, [16])
    E(259, 3, [compression])
    E(262, 3, [32803])
    E(271, 2, make)
    E(272, 2, model)
    strip_entry_index = len(entries)
    E(273, 4, [0])
    if orientation is not None:
        E(274, 3, [orientation])
    E(277, 3, [1])
    E(278, 4, [h])
    E(279, 4, [len(data)])
    E(33421, 3, [2, 2])
    E(33422, 1, cfa_bytes)
    E(34665, 4, [exif_offset])
    E(50706, 1, [1, 4, 0, 0])
    E(50714, 3, [black_level])
    E(50717, 3, [white_level])
    cm = np.asarray(color_matrix, np.float64).ravel()
    E(50721, 10, [(int(round(x * 10000)), 10000) for x in cm])
    assert len(entries) == n_ifd0, len(entries)

    exif_entries = []

    def EX(tag, typ, values):
        exif_entries.append(_entry(endian, tag, typ, values, heap, heap_base))

    EX(33434, 5, [(int(exposure_time * 1_000_000), 1_000_000)])
    EX(33437, 5, [(int(f_number * 100), 100)])
    EX(34855, 3, [iso])
    assert len(exif_entries) == n_exif

    data_offset = heap_base + len(heap)
    entries[strip_entry_index] = struct.pack(endian + "HHI", 273, 4, 1) + struct.pack(
        endian + "I", data_offset
    )

    out = bytearray()
    out += b"II" + struct.pack(endian + "HI", 42, header_size)
    out += struct.pack(endian + "H", n_ifd0)
    out += b"".join(entries)
    out += struct.pack(endian + "I", 0)
    out += struct.pack(endian + "H", n_exif)
    out += b"".join(exif_entries)
    out += struct.pack(endian + "I", 0)
    out += heap
    out += data
    with open(path, "wb") as f:
        f.write(out)
