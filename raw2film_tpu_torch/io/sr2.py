"""Sony SR2Private decrypt — the cRAW/ARW2 tone curve.

ARW2's 11-bit block codes expand through a decompanding curve whose knots
live in the ENCRYPTED SR2 private region (the LibRaw/dcraw/exiftool
``sony_decrypt`` scheme): the Sony MakerNote carries SR2SubIFDOffset
(0x7200), SR2SubIFDLength (0x7201) and SR2SubIFDKey (0x7221); the region
decrypts with a 127-word pad seeded by ``key = key * 48828125 + 1`` and the
shift-register recurrence ``pad[i] = (pad[i-4]^pad[i-2]) << 1 |
(pad[i-3]^pad[i-1]) >> 31``, XORed over big-endian u32 words with the
rolling update ``pad[i & 127] = pad[(i+1) & 127] ^ pad[(i+65) & 127]``.
Inside the decrypted SR2SubIFD, tag 0x7010 holds four u16 knots
(each ``>> 2 & 0xfff``); the curve is piecewise linear with slope ``1 << i``
over segment i of [0, k1, k2, k3, k4, 4095].

Every step validates structurally (IFD entry counts, knot monotonicity);
anything unexpected falls back to the linear no-curve expansion the ARW2
decoder already uses — so a decrypt mismatch can never make files decode
WORSE than before, only tone-correct when it matches.
"""

from __future__ import annotations

import struct

import numpy as np


def sony_decrypt(data: bytes, key: int) -> bytes:
    """Decrypt an SR2 region (len rounded down to whole u32 words)."""
    words = len(data) // 4
    if words == 0:
        return data
    pad = np.zeros(128, np.uint64)
    k = np.uint64(key & 0xFFFFFFFF)
    mul = np.uint64(48828125)
    one = np.uint64(1)
    m32 = np.uint64(0xFFFFFFFF)
    for i in range(4):
        k = (k * mul + one) & m32
        pad[i] = k
    pad[3] = (pad[3] << one | ((pad[0] ^ pad[2]) >> np.uint64(31))) & m32
    for i in range(4, 127):
        pad[i] = (
            (pad[i - 4] ^ pad[i - 2]) << one
            | ((pad[i - 3] ^ pad[i - 1]) >> np.uint64(31))
        ) & m32
    pad = pad.astype(np.uint32)

    arr = np.frombuffer(data[: words * 4], ">u4").copy()
    out = np.empty_like(arr)
    idx = 127
    for j in range(words):
        pad[idx & 127] = pad[(idx + 1) & 127] ^ pad[(idx + 65) & 127]
        out[j] = arr[j] ^ pad[idx & 127]
        idx += 1
    return out.astype(">u4").tobytes() + data[words * 4 :]


def _makernote_inline_u32(mn: bytes, want: set[int], endian: str = "<") -> dict:
    """Inline u32 tag values from a Sony MakerNote ("SONY DSC " header +
    IFD; out-of-line offsets are file-absolute and not needed here)."""
    out: dict = {}
    for prefix in (b"SONY DSC \x00\x00\x00", b"SONY CAM \x00\x00\x00", b"SONY MOBILE"):
        if mn.startswith(prefix[:9]):
            base = 12
            break
    else:
        return out
    try:
        (count,) = struct.unpack_from(endian + "H", mn, base)
        pos = base + 2
        for _ in range(min(count, 512)):
            tag, typ, n = struct.unpack_from(endian + "HHI", mn, pos)
            if tag in want and n == 1:
                (v,) = struct.unpack_from(endian + "I", mn, pos + 8)
                out[tag] = v
            pos += 12
    except struct.error:
        pass
    return out


def build_sony_curve(knots: list[int]) -> np.ndarray:
    """4096-entry decompanding LUT from the four 0x7010 knots: piecewise
    slopes 1,2,4,8,16 over [0, k1, k2, k3, k4, 4095]."""
    pts = [0, *knots, 4095]
    curve = np.arange(4096, dtype=np.uint32)
    for i in range(5):
        lo, hi = pts[i], pts[i + 1]
        if hi > lo:
            curve[lo + 1 : hi + 1] = curve[lo] + np.arange(
                1, hi - lo + 1, dtype=np.uint32
            ) * (1 << i)
    if curve.max() > 0xFFFF:
        raise ValueError("SR2 curve overflow")
    return curve.astype(np.uint16)


def try_read_arw2_curve(buf: bytes, makernote: bytes | None):
    """-> (curve uint16[4096], white_level) or None (fall back linear)."""
    if not makernote:
        return None
    tags = _makernote_inline_u32(makernote, {0x7200, 0x7201, 0x7221})
    off, length, key = (
        tags.get(0x7200),
        tags.get(0x7201),
        tags.get(0x7221),
    )
    if not off or not length or key is None:
        return None
    if off + length > len(buf) or length > 1 << 24:
        return None
    try:
        dec = sony_decrypt(buf[off : off + length], key)
        # SR2SubIFD value offsets are file-absolute but point inside the
        # decrypted region: a zero prefix up to `off` suffices (no need to
        # rebuild the whole file buffer).
        patched = bytes(off) + dec
        from raw2film_tpu_torch.io.dng import _read_ifd

        ifd, _ = _read_ifd(patched, off, "<")
        if len(ifd) > 512 or 0x7010 not in ifd:
            return None
        vals = ifd[0x7010]
        if not isinstance(vals, list) or len(vals) < 4:
            return None
        knots = [(int(v) >> 2) & 0xFFF for v in vals[:4]]
        if knots != sorted(knots) or knots[-1] > 4095:
            return None
        curve = build_sony_curve(knots)
        return curve, float(int(curve[4094]) >> 2)
    except Exception:
        return None
