"""Lossless JPEG (ITU T.81 process 14 / SOF3) encoder.

Host-side encoder used to produce compressed DNG test fixtures for the
native C++ decoder and for writing compressed DNGs. Predictor 1, one huffman
table shared by all components (optimal tables are unnecessary for
fixtures; the format is what matters).
"""

from __future__ import annotations

import numpy as np


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, nbits: int):
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            byte = (self.acc >> (self.nbits - 8)) & 0xFF
            self.buf.append(byte)
            if byte == 0xFF:
                self.buf.append(0x00)  # byte stuffing
            self.nbits -= 8
            self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)  # pad with 1s per JPEG convention


# A fixed huffman table for ssss categories 0..16: code length = max(2, ssss)
# won't be canonical-complete; instead use length (ssss+1) codes 0..: build a
# simple canonical table: counts per length chosen so categories 0-16 each get
# one code with increasing length.
_COUNTS = [0] * 16
_VALUES = list(range(17))
# lengths: cat0 -> 2 bits, cat1 -> 3 bits, ..., cat14 -> 16 bits; cats 15,16
# also 16 bits (three codes of length 16).
_LENGTHS = [2] + [min(i + 2, 16) for i in range(1, 17)]
for L in _LENGTHS:
    _COUNTS[L - 1] += 1


def _build_codes():
    # canonical codes from (length, order-of-appearance)
    pairs = sorted(zip(_LENGTHS, _VALUES))
    codes = {}
    code = 0
    prev_len = pairs[0][0]
    for length, val in pairs:
        code <<= length - prev_len
        prev_len = length
        codes[val] = (code, length)
        code += 1
    return codes


_CODES = _build_codes()


def _category(diff: int) -> tuple[int, int]:
    """-> (ssss, extra-bits value) per T.81 H.1.2.2."""
    if diff == 0:
        return 0, 0
    mag = abs(diff)
    ssss = mag.bit_length()
    if diff > 0:
        return ssss, diff
    return ssss, diff + (1 << ssss) - 1


def encode_ljpeg(img: np.ndarray, precision: int = 16) -> bytes:
    """img (H, W) or (H, W, C) uint16 -> lossless JPEG byte stream."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, ncomp = img.shape
    img = img.astype(np.int64)

    out = bytearray()
    out += b"\xff\xd8"  # SOI
    # SOF3
    sof = bytearray()
    sof += precision.to_bytes(1, "big")
    sof += h.to_bytes(2, "big") + w.to_bytes(2, "big")
    sof += ncomp.to_bytes(1, "big")
    for c in range(ncomp):
        sof += bytes([c + 1, 0x11, 0])
    out += b"\xff\xc3" + (len(sof) + 2).to_bytes(2, "big") + sof
    # DHT (table 0)
    dht = bytearray([0x00]) + bytes(_COUNTS) + bytes(_VALUES)
    out += b"\xff\xc4" + (len(dht) + 2).to_bytes(2, "big") + dht
    # SOS
    sos = bytearray([ncomp])
    for c in range(ncomp):
        sos += bytes([c + 1, 0x00])
    sos += bytes([1, 0, 0])  # predictor 1, Se=0, pt=0
    out += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos

    bw = _BitWriter()
    default_pred = 1 << (precision - 1)
    for y in range(h):
        for x in range(w):
            for c in range(ncomp):
                if y == 0 and x == 0:
                    pred = default_pred
                elif x == 0:
                    pred = img[y - 1, 0, c]
                elif y == 0:
                    pred = img[0, x - 1, c]
                else:
                    pred = img[y, x - 1, c]  # predictor 1
                diff = int(img[y, x, c] - pred)
                # wrap to 16-bit signed domain
                diff = ((diff + 32768) & 0xFFFF) - 32768
                ssss, extra = _category(diff)
                if ssss > 16:
                    raise ValueError("diff out of range")
                code, length = _CODES[ssss]
                bw.put(code, length)
                if ssss == 16:
                    pass  # no extra bits
                else:
                    bw.put(extra, ssss)
    bw.flush()
    out += bw.buf
    out += b"\xff\xd9"  # EOI
    return bytes(out)
