"""Canon CR3 raw payload (CRX codec): decode to a sensor mosaic.

The reference ingests CR3 through LibRaw (reference:
src/raw2film/raw_conversion.py:36-48; extension list src/raw2film/
data.py:87-102). CRX is Canon's wavelet/Rice hybrid introduced with the
EOS M50/R generation; the public reverse-engineering (LibRaw's crx decoder,
Laurent Clevy's canon_cr3 notes) pins the ARCHITECTURE this module
implements:

* the CR3 container is ISO-BMFF; the raw lives in a ``CRAW`` sample entry
  whose ``CMP1`` child box carries the codec parameters (frame/tile dims,
  bit depth, plane count, CFA layout, encoding type, wavelet level count,
  mdat header size);
* the mdat payload opens with a run of tile/plane/subband records
  (``0xFF01``/``0xFF02``/``0xFF03`` tags) declaring per-band compressed
  sizes, followed by the entropy payloads in record order;
* a Bayer frame is coded as four half-resolution CFA subplanes; each plane
  is either coded directly (``imageLevels == 0``, the lossless "RAW"
  setting) or through an integer LeGall 5/3 wavelet with ``imageLevels``
  decomposition levels whose subbands are coded independently;
* the lossy "CRAW" setting quantizes the detail subbands: each 0xFF03
  record carries a qparam selecting a geometric step (six steps per
  octave — see ``q_num``/``dequantize``); the LL band stays exact;
* subband entropy coding is adaptive Golomb-Rice (unary zero prefix with
  an escape to a 21-bit raw value, per-sample K adaptation) with a
  zero-run mode for the sparse high-frequency bands; the LL band / level-0
  plane codes top-line-predicted residuals.

Within that architecture the exact bit-level choices below (K-adaptation
increments, run-mode context, record field packing) are r2f's
reconstruction from format knowledge — byte-exact compatibility with
camera files is NOT yet verified (zero-egress build environment; no real
CR3 sample available). The decode therefore guards every step: record
walks are bounds-checked, Rice escapes are capped, DPCM values must stay
inside the declared bit depth, and each band must consume exactly its
declared payload — a mismatching real-camera stream aborts with a clear
NotImplementedError (remedy: convert to DNG) instead of returning garbage.
The synthetic-encoder round trips in tests/test_raw_formats.py pin the
implemented structure end to end (container -> records -> Rice/run
bitstreams -> wavelet reconstruction -> mosaic).

Entropy-coding rules shared by this decoder and the test encoder
(tests/raw_fixtures.py), normative for the r2f bitstream:

* Rice(u; k): q = count of 0 bits before a 1. q <= 40: u = q<<k | next k
  bits. q >= 41 (encoder writes exactly 41): u = next 21 bits raw.
* K adaptation after every coded u (also for the run-length S parameter):
  k += ((u>>k) > 2) + ((u>>k) > 5) - (2u < (1<<k)), clamped to [0, 21].
* DPCM bands (LL / level-0 plane), values v in [0, 2^nBits): line 0
  predicts from the left neighbour (first sample: 2^(nBits-1)); later
  lines predict from the row above. Residuals are zigzag-mapped
  (u = (e<<1) ^ (e>>31)). No run mode. Initial k = 4.
* HF bands: signed coefficients, zigzag-mapped. Run mode engages when the
  previously decoded coefficient (raster order; band start counts as
  zero) is 0: a Rice(s)-coded zero-run (bounded by the line end) follows,
  then — if the line is not exhausted — one interrupting nonzero
  coefficient coded as zigzag(c)-1. Initial k = 1, s = 1.
"""

from __future__ import annotations

import struct

import numpy as np

from raw2film_tpu_torch.io.cr3 import _find_box, _walk_boxes


# ------------------------------------------------------------------ container


def find_craw_track(buf: bytes):
    """Locate the CRAW sample entry: returns (cmp1_bytes, sample_offset,
    sample_size, width, height) or None if the file carries no raw track."""
    moov = _find_box(buf, 0, len(buf), [(b"moov", None)])
    if moov is None:
        return None
    for btype, _, t0, t1 in _walk_boxes(buf, *moov):
        if btype != b"trak":
            continue
        stbl = _find_box(
            buf, t0, t1, [(b"mdia", None), (b"minf", None), (b"stbl", None)]
        )
        if stbl is None:
            continue
        stsd = _find_box(buf, *stbl, [(b"stsd", None)])
        if stsd is None:
            continue
        s0, s1 = stsd
        # stsd payload: u32 version/flags, u32 entry_count, then entries.
        entry = None
        for btype2, _, e0, e1 in _walk_boxes(buf, s0 + 8, s1):
            if btype2 == b"CRAW":
                entry = (e0, e1)
                break
        if entry is None:
            continue
        e0, e1 = entry
        # Visual sample entry: 6 reserved + u16 data_ref_idx + 16 predefined
        # + u16 width + u16 height + 50 more bytes = 78, then child boxes.
        if e1 - e0 < 82:
            continue
        width, height = struct.unpack_from(">HH", buf, e0 + 24)
        cmp1 = None
        for btype3, _, c0, c1 in _walk_boxes(buf, e0 + 78, e1):
            if btype3 == b"CMP1":
                cmp1 = buf[c0:c1]
                break
        if cmp1 is None:
            continue
        # Sample location: co64/stco + stsz inside the same stbl.
        off = size = None
        for btype4, _, b0, b1 in _walk_boxes(buf, *stbl):
            # co64/stco payload: u32 version/flags, u32 entry_count, then
            # the first chunk offset (u64 / u32).
            if btype4 == b"co64" and b1 - b0 >= 16:
                (off,) = struct.unpack_from(">Q", buf, b0 + 8)
            elif btype4 == b"stco" and b1 - b0 >= 12:
                (off32,) = struct.unpack_from(">I", buf, b0 + 8)
                off = int(off32)
            elif btype4 == b"stsz" and b1 - b0 >= 12:
                (fixed,) = struct.unpack_from(">I", buf, b0 + 4)
                if fixed:
                    size = int(fixed)
                elif b1 - b0 >= 16:
                    (size,) = struct.unpack_from(">I", buf, b0 + 12)
        if off is None or size is None or off + size > len(buf):
            continue
        return cmp1, int(off), int(size), int(width), int(height)
    return None


class Cmp1:
    """Parsed CMP1 codec parameters (big-endian layout per the published
    reverse-engineering; offsets relative to the box payload)."""

    def __init__(self, raw: bytes):
        if len(raw) < 32:
            raise ValueError("CMP1 box too short")
        self.version = struct.unpack_from(">H", raw, 4)[0]
        self.f_width = struct.unpack_from(">I", raw, 8)[0]
        self.f_height = struct.unpack_from(">I", raw, 12)[0]
        self.tile_width = struct.unpack_from(">I", raw, 16)[0]
        self.tile_height = struct.unpack_from(">I", raw, 20)[0]
        self.n_bits = raw[24]
        self.n_planes = raw[25] >> 4
        self.cfa_layout = raw[25] & 0xF
        self.enc_type = raw[26] >> 4
        self.image_levels = raw[26] & 0xF
        self.has_tile_cols = raw[27] >> 7
        self.has_tile_rows = (raw[27] >> 6) & 1
        self.mdat_hdr_size = struct.unpack_from(">I", raw, 28)[0]
        if not (
            0 < self.f_width <= 65536
            and 0 < self.f_height <= 65536
            and 0 < self.tile_width <= 65536
            and 0 < self.tile_height <= 65536
            and 8 <= self.n_bits <= 16
            and self.n_planes in (1, 4)
            and self.image_levels <= 3
        ):
            raise ValueError("CMP1: implausible codec parameters")


def parse_mdat_records(buf: bytes, start: int, end: int):
    """Walk the 0xFF01/02/03 record run: returns a list of
    (tag, data_size, index, qparam) in file order."""
    out = []
    pos = start
    while pos + 4 <= end:
        tag, hdr_len = struct.unpack_from(">HH", buf, pos)
        if tag not in (0xFF01, 0xFF02, 0xFF03):
            break
        if hdr_len < 8 or pos + hdr_len > end:
            raise ValueError("CRX: malformed mdat record header")
        data_size, idx = struct.unpack_from(">IH", buf, pos + 4)
        qparam = buf[pos + 10] if hdr_len >= 11 else 0
        out.append((tag, int(data_size), int(idx), int(qparam)))
        pos += hdr_len
        if len(out) > 4096:
            raise ValueError("CRX: runaway mdat record run")
    return out


# ------------------------------------------------------------------ wavelet


def _idwt53_1d(s: np.ndarray, d: np.ndarray, axis: int, n: int) -> np.ndarray:
    """Inverse integer LeGall 5/3 along ``axis``: low band ``s``
    (ceil(n/2)) + high band ``d`` (floor(n/2)) -> length-n signal.
    Symmetric (whole-sample) extension, JPEG2000 lifting:
      x[2i]   = s[i] - floor((d[i-1] + d[i] + 2) / 4)
      x[2i+1] = d[i] + floor((x[2i] + x[2i+2]) / 2)
    """
    s = np.moveaxis(s, axis, 0).astype(np.int64)
    d = np.moveaxis(d, axis, 0).astype(np.int64)
    ns, nd = s.shape[0], d.shape[0]
    if n == 1:
        return np.moveaxis(s, 0, axis)
    dl = d[np.clip(np.arange(ns) - 1, 0, nd - 1)]
    dr = d[np.clip(np.arange(ns), 0, nd - 1)]
    even = s - ((dl + dr + 2) >> 2)
    el = even[np.clip(np.arange(nd), 0, ns - 1)]
    er = even[np.clip(np.arange(nd) + 1, 0, ns - 1)]
    odd = d + ((el + er) >> 1)
    x = np.empty((n,) + s.shape[1:], np.int64)
    x[0::2] = even[: (n + 1) // 2]
    x[1::2] = odd[: n // 2]
    return np.moveaxis(x, 0, axis)


# Quantizer for lossy (CRAW) subbands: six geometric steps per octave
# (ratio 2^(1/6)) in fixed point over denominator 40 — the step layout the
# public CRX reverse engineering reports for Canon's CRAW quantizer
# (numerators 0x28 0x2D 0x33 0x39 0x40 0x48). The step for a record's
# qparam is num(qp)/40 with num(qp) = _Q_TBL[qp % 6] << (qp // 6), so
# qp=0 -> exact, qp=6 -> x2, qp=12 -> x4. Signed rounding rules (shared
# with the synthetic encoder in tests/raw_fixtures.py, r2f-normative —
# as with the rest of this module, real-camera validation is pending):
#   encode: c  = sign(v) * ((|v| * 40 + num // 2) // num)
#   decode: v' = sign(c) * ((|c| * num + 20) // 40)
_Q_TBL = (40, 45, 51, 57, 64, 72)
_Q_DEN = 40


def q_num(qp: int) -> int:
    """Fixed-point quantizer-step numerator (denominator _Q_DEN)."""
    if qp <= 0:
        return _Q_DEN
    return _Q_TBL[qp % 6] << (qp // 6)


def dequantize(band, qp: int):
    """Dequantize a decoded subband (int array) per the scheme above."""
    if qp <= 0:
        return band
    num = q_num(qp)
    mag = (np.abs(band) * num + _Q_DEN // 2) // _Q_DEN
    return np.sign(band) * mag


def _band_dims(h: int, w: int, levels: int):
    """Per-level (h, w) of the LL input at each decomposition step."""
    dims = [(h, w)]
    for _ in range(levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        dims.append((h, w))
    return dims


# ------------------------------------------------------------------ decode


def _decode_band_native(data: bytes, w: int, h: int, n_bits: int, dpcm: bool):
    from raw2film_tpu_torch import native

    out = native.decode_crx_band(data, w, h, n_bits, dpcm)
    return out


_CFA_LAYOUTS = {0: "RGGB", 1: "GRBG", 2: "GBRG", 3: "BGGR"}


def read_raw_payload(buf: bytes, path: str):
    """Decode the CR3 CRX raw payload -> RawImage (CFA mosaic)."""
    from raw2film_tpu_torch.io.cr3 import extract_metadata
    from raw2film_tpu_torch.io.dng import RawImage

    track = find_craw_track(buf)
    if track is None:
        raise NotImplementedError(
            f"{path}: no CRAW raw track found in the CR3 container; embedded "
            "previews + EXIF still serve browsing (io/cr3.py)"
        )
    cmp1_raw, off, size, _, _ = track
    cmp1 = Cmp1(cmp1_raw)
    if cmp1.enc_type not in (0,):
        raise NotImplementedError(
            f"{path}: CRX encType {cmp1.enc_type} is not supported — only "
            "the baseline wavelet/Rice codec (encType 0) decodes; convert "
            "to DNG"
        )
    sample = buf[off : off + size]
    records = parse_mdat_records(sample, 0, min(cmp1.mdat_hdr_size, len(sample)))
    bands_per_plane = 3 * cmp1.image_levels + 1

    # Tile grid (high-MP bodies split the frame into column tiles; the
    # record run carries one 0xFF01 per tile, each followed by its planes'
    # 0xFF02/0xFF03 records, tiles in raster order).
    n_tx = -(-cmp1.f_width // cmp1.tile_width)
    n_ty = -(-cmp1.f_height // cmp1.tile_height)
    n_tiles = n_tx * n_ty
    tile_runs: list[list] = []
    for rec in records:
        if rec[0] == 0xFF01:
            # Reassembly below assumes raster order; a real camera writing
            # tile records out of order would otherwise place every tile at
            # the wrong (row, col) and return a silently scrambled mosaic.
            # The 0xFF01 header carries the tile index — verify, don't trust.
            if rec[2] != len(tile_runs):
                raise NotImplementedError(
                    f"{path}: CRX tile record #{len(tile_runs)} declares "
                    f"index {rec[2]} (non-raster tile order is not "
                    "supported) — convert to DNG"
                )
            tile_runs.append([])
        elif rec[0] == 0xFF03 and tile_runs:
            tile_runs[-1].append(rec)
    plane_recs = [r for r in records if r[0] == 0xFF02]
    if cmp1.image_levels == 0 and all(not t for t in tile_runs):
        # Level-0 streams may declare planes only: the plane record IS the
        # single band (single-tile layout only).
        if n_tiles == 1 and len(tile_runs) == 1:
            tile_runs = [plane_recs]
    if len(tile_runs) != n_tiles or any(
        len(t) != cmp1.n_planes * bands_per_plane for t in tile_runs
    ):
        raise NotImplementedError(
            f"{path}: CRX record run declares {len(tile_runs)} tiles / "
            f"{[len(t) for t in tile_runs]} subbands, expected {n_tiles} "
            f"tiles x {cmp1.n_planes} planes x {bands_per_plane}; this "
            "layout variant is not supported — convert to DNG"
        )
    lossy = any(q for t in tile_runs for (_, _, _, q) in t)
    if lossy and cmp1.image_levels == 0:
        # Level-0 streams DPCM-code sample values, not wavelet
        # coefficients; a quantized DPCM band has no published analog.
        raise NotImplementedError(
            f"{path}: quantized level-0 CRX planes are not supported; "
            "convert to DNG"
        )

    if cmp1.n_planes != 4:
        # Single-plane CRX (monochrome CRM-style): decode as a CFA-less
        # mosaic is NOT meaningful downstream (RawImage's linear branch
        # expects (H, W, C)); no stills camera writes it, so error clearly.
        raise NotImplementedError(
            f"{path}: single-plane CRX streams are not supported"
        )
    if cmp1.f_height % 2 or cmp1.f_width % 2:
        raise NotImplementedError(
            f"{path}: CRX 4-plane frames with odd dimensions are not "
            "supported — convert to DNG"
        )
    # Wavelet LL bands carry a +2^(nBits+1) bias and 4 bits of headroom
    # (the integer 5/3 lowpass overshoots [0, 2^nBits) slightly); the
    # reconstructed plane is range-checked against nBits below.
    ll_bits = cmp1.n_bits + 4 if cmp1.image_levels else cmp1.n_bits
    ll_bias = (1 << (cmp1.n_bits + 1)) if cmp1.image_levels else 0

    mosaic = np.zeros((cmp1.f_height, cmp1.f_width), np.uint16)

    # Pass 1 (host, trivial): walk the record run computing every band's
    # byte span and geometry. The stream is strictly sequential, so all
    # offsets are known BEFORE any entropy decode — which makes the bands
    # independent decode jobs. Pass 2 fans them out over a thread pool
    # (the native Rice/DPCM kernel runs with the GIL released via ctypes),
    # so a many-core host decodes a CR3 near-linearly in cores, matching
    # the threaded Fuji-strip / remap design in native/r2f_native.cc.
    pos = cmp1.mdat_hdr_size
    tile_geoms = []  # (y0, x0, th_t, tw_t, ph, pw, dims)
    band_jobs = []  # flat, record order: (pos, dsz, w, h, bits, dpcm, qp)
    for ti, band_recs in enumerate(tile_runs):
        t_row, t_col = divmod(ti, n_tx)
        y0, x0 = t_row * cmp1.tile_height, t_col * cmp1.tile_width
        th_t = min(cmp1.tile_height, cmp1.f_height - y0)
        tw_t = min(cmp1.tile_width, cmp1.f_width - x0)
        if th_t % 2 or tw_t % 2:
            raise NotImplementedError(
                f"{path}: CRX tile grid splits the CFA phase (tile at "
                f"({t_row},{t_col}) is {th_t}x{tw_t}) — convert to DNG"
            )
        ph, pw = th_t // 2, tw_t // 2
        dims = _band_dims(ph, pw, cmp1.image_levels)
        tile_geoms.append((y0, x0, th_t, tw_t, ph, pw, dims))
        ri = 0
        for _p in range(cmp1.n_planes):
            # Band order: LL (coarsest), then (hl, lh, hh) coarsest ->
            # finest.
            _, dsz, _, llq = band_recs[ri]
            if llq:
                # Keeping DC exact: a quantized DPCM-coded LL band has no
                # published analog (CRAW quantizes the detail bands).
                raise NotImplementedError(
                    f"{path}: quantized CRX LL bands are not supported; "
                    "convert to DNG"
                )
            llh, llw = dims[-1]
            band_jobs.append((pos, dsz, llw, llh, ll_bits, True, 0))
            pos += dsz
            ri += 1
            for lvl in range(cmp1.image_levels):
                # Subband shapes at this level (see _reconstruct for the
                # split order): the W split gives lw low / tw-lw high
                # columns; the H split then gives (th+1)//2 low /
                # th-(th+1)//2 high rows.
                th, tw = dims[cmp1.image_levels - 1 - lvl]
                lw = (tw + 1) // 2
                for bh, bw in (
                    ((th + 1) // 2, tw - lw),
                    (th - (th + 1) // 2, lw),
                    (th - (th + 1) // 2, tw - lw),
                ):
                    _, dsz, _, bq = band_recs[ri]
                    band_jobs.append(
                        (pos, dsz, bw, bh, cmp1.n_bits, False, bq)
                    )
                    pos += dsz
                    ri += 1

    def _decode_job(job):
        jpos, jdsz, jw, jh, jbits, jdpcm, jq = job
        if jh == 0 or jw == 0:
            return np.zeros((jh, jw), np.int64)
        band = _decode_band_native(
            sample[jpos : jpos + jdsz], jw, jh, jbits, jdpcm
        ).astype(np.int64)
        if jdpcm:  # LL band: bias removal instead of dequantization
            return band - ll_bias
        return dequantize(band, jq)

    from raw2film_tpu_torch.utils.workers import decode_workers

    nworkers = decode_workers(len(band_jobs))
    if nworkers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nworkers) as ex:
            bands = list(ex.map(_decode_job, band_jobs))
    else:
        bands = [_decode_job(j) for j in band_jobs]

    bi = iter(bands)
    for y0, x0, th_t, tw_t, ph, pw, dims in tile_geoms:
        planes = []
        for _p in range(cmp1.n_planes):
            ll = next(bi)
            highs = []
            for _lvl in range(cmp1.image_levels):
                highs.append((next(bi), next(bi), next(bi)))
            if cmp1.image_levels:
                plane = _reconstruct(ll, highs, ph, pw)
            else:
                plane = ll
            if plane.shape != (ph, pw):
                raise ValueError("CRX: reconstructed plane shape mismatch")
            lo, hi = int(plane.min()), int(plane.max())
            top = 1 << cmp1.n_bits
            if lossy and -top <= lo and hi < 2 * top:
                # Quantization error can push the reconstruction slightly
                # past the sensor range (the encoder saw in-range values):
                # clip, but keep the mis-parse guard for egregious
                # overshoot below.
                plane = np.clip(plane, 0, top - 1)
            elif lo < 0 or hi >= top:
                raise NotImplementedError(
                    f"{path}: CRX bitstream did not decode cleanly (values "
                    f"[{lo}, {hi}] outside {cmp1.n_bits}-bit range); the "
                    "entropy-coding constants are reconstructed from "
                    "format knowledge and this file may use a variant — "
                    "convert to DNG"
                )
            planes.append(plane.astype(np.uint16))

        tile = mosaic[y0 : y0 + th_t, x0 : x0 + tw_t]
        tile[0::2, 0::2] = planes[0]
        tile[0::2, 1::2] = planes[1]
        tile[1::2, 0::2] = planes[2]
        tile[1::2, 1::2] = planes[3]
    cfa = _CFA_LAYOUTS.get(cmp1.cfa_layout, "RGGB")
    meta = extract_metadata(buf)
    meta.setdefault("EXIF:Make", "Canon")
    return RawImage(
        data=mosaic,
        cfa_pattern=cfa,
        black_level=0.0,
        white_level=float((1 << cmp1.n_bits) - 1),
        color_matrix=None,
        as_shot_neutral=None,
        metadata=meta,
    )


def _reconstruct(ll: np.ndarray, highs: list, h: int, w: int) -> np.ndarray:
    """Inverse wavelet: ``highs`` is [(hl, lh, hh)] coarsest -> finest.

    Encoder split order (normative): along W first (low | high columns),
    then along H on each half (low | high rows). Bands per level:
    ll = (low W, low H), hl = (high W, low H), lh = (low W, high H),
    hh = (high W, high H). Inverse: merge H on each W-half, then merge W.
    """
    dims = _band_dims(h, w, len(highs))
    cur = ll
    for lvl, (hl, lh, hh) in enumerate(highs):
        th, tw = dims[len(highs) - 1 - lvl]
        lw = (tw + 1) // 2
        low_w = _idwt53_1d(cur, lh, 0, th)  # (th, lw)
        high_w = _idwt53_1d(hl, hh, 0, th)  # (th, tw - lw)
        cur = _idwt53_1d(low_w, high_w, 1, tw)
    return cur
