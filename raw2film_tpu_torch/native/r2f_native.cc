// raw2film-tpu native host kernels.
//
// The reference delegates RAW unpacking to LibRaw (C++ via rawpy,
// reference: src/raw2film/raw_conversion.py:36-48). This library owns the
// equivalent byte-crunching host path:
//   * lossless JPEG (ITU T.81 process 14 / SOF3) decode — the compression
//     used by most real-world DNGs (Compression=7),
//   * fast 16-bit strip unpack with black/white normalization.
//
// Exposed with a plain C ABI for ctypes. Build: see Makefile (g++ -O3
// -shared -fPIC).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t bits = 0;
  int nbits = 0;
  bool ok = true;

  BitReader(const uint8_t* data, size_t len) : p(data), end(data + len) {}

  // JPEG entropy stream: 0xFF is followed by a 0x00 stuffing byte.
  inline int fill() {
    while (nbits <= 24) {
      if (p >= end) {
        // Pad with zeros at the end (valid for the final code).
        bits |= 0;
        nbits += 8;
        continue;
      }
      uint8_t b = *p++;
      if (b == 0xFF) {
        if (p < end && *p == 0x00) {
          ++p;
        } else {
          // Marker hit: behave as end of stream.
          --p;
          bits |= 0;
          nbits += 8;
          continue;
        }
      }
      bits |= uint32_t(b) << (24 - nbits);
      nbits += 8;
    }
    return 0;
  }

  inline uint32_t peek(int n) {
    fill();
    return bits >> (32 - n);
  }

  inline void consume(int n) {
    bits <<= n;
    nbits -= n;
  }
};

struct Huff {
  // code lengths 1..16 -> symbols; decoded via canonical code ranges.
  int32_t maxcode[17];
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t values[256];
  // First-level lookup: lut[peek8] = (symbol << 5) | code_length for codes
  // of <= 8 bits (almost every symbol in a typical SOF3 ssss table), -1 for
  // longer codes. Turns the per-symbol decode from up to 16 peek/consume
  // round trips into one table hit.
  int16_t lut[256];
  bool valid = false;

  void build(const uint8_t counts[16], const uint8_t* vals, int nvals) {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = code - 1;
      code <<= 1;
      if (counts[l - 1] == 0) maxcode[l] = -1;
    }
    std::memset(values, 0, sizeof(values));  // counts > nvals pad symbol 0
    std::memcpy(values, vals, size_t(nvals) < sizeof(values) ? nvals : sizeof(values));
    for (int i = 0; i < 256; ++i) lut[i] = -1;
    code = 0;
    k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int c = 0; c < counts[l - 1]; ++c, ++k, ++code) {
        // code < (1<<l) bounds base+span to lut[256]: an over-subscribed
        // table (sum(counts) <= 256 but too many codes for a length, from
        // untrusted file data) would otherwise shift past the array — the
        // canonical-invalid codes simply stay at lut=-1 / maxcode misses
        // and decode returns -1, which callers treat as corrupt input.
        if (l <= 8 && k < int(sizeof(values)) && code < (1 << l)) {
          int base = code << (8 - l);
          int span = 1 << (8 - l);
          for (int f = 0; f < span; ++f)
            lut[base + f] = int16_t((int(values[k]) << 5) | l);
        }
      }
      code <<= 1;
    }
    valid = true;
  }

  inline int decode(BitReader& br) const {
    int16_t e = lut[br.peek(8)];
    if (e >= 0) {
      br.consume(e & 31);
      return e >> 5;
    }
    // Long code (> 8 bits): canonical-range walk over the 16-bit window —
    // identical consumption to the historical bit-by-bit loop.
    uint32_t pk = br.peek(16);
    for (int l = 9; l <= 16; ++l) {
      int cand = int(pk >> (16 - l));
      if (maxcode[l] >= 0 && cand <= maxcode[l]) {
        br.consume(l);
        return values[valptr[l] + cand - mincode[l]];
      }
    }
    br.consume(16);
    return -1;
  }
};

inline int extend(int v, int ssss) {
  // T.81 F.2.2.1 sign extension.
  if (ssss == 0) return 0;
  if (ssss == 16) return 32768;
  if (v < (1 << (ssss - 1))) return v - (1 << ssss) + 1;
  return v;
}

inline int receive(BitReader& br, int ssss) {
  if (ssss == 0) return 0;
  if (ssss == 16) return 0;  // no extra bits for 16
  uint32_t v = br.peek(ssss);
  br.consume(ssss);
  return int(v);
}

}  // namespace

extern "C" {

// Decode a lossless JPEG (SOF3) buffer into interleaved uint16 output.
// Returns 0 on success; negative error codes otherwise. Caller provides
// out sized >= max_out_samples; actual dims written to w/h/comps.
int r2f_decode_ljpeg(const uint8_t* src, long len, uint16_t* out,
                     long max_out_samples, int* out_w, int* out_h,
                     int* out_comps) {
  const uint8_t* p = src;
  const uint8_t* end = src + len;
  if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return -1;  // SOI
  p += 2;

  int precision = 0, height = 0, width = 0, ncomp = 0;
  int comp_id[4] = {0}, comp_tbl[4] = {0};
  Huff tables[4];
  int predictor = 1, pt = 0;
  int nscan = 0;
  const uint8_t* entropy = nullptr;

  while (p + 4 <= end) {
    if (p[0] != 0xFF) return -2;
    int marker = p[1];
    p += 2;
    if (marker == 0xD8) continue;
    int seglen = (p[0] << 8) | p[1];
    if (seglen < 2 || p + seglen > end) return -3;
    const uint8_t* seg = p + 2;
    const uint8_t* seg_end = p + seglen;  // seglen counts its own 2 bytes

    if (marker == 0xC3) {  // SOF3
      if (seg + 6 > seg_end) return -3;
      precision = seg[0];
      height = (seg[1] << 8) | seg[2];
      width = (seg[3] << 8) | seg[4];
      ncomp = seg[5];
      if (ncomp > 4) return -4;
      if (seg + 6 + 3 * ncomp > seg_end) return -3;
      for (int i = 0; i < ncomp; ++i) {
        comp_id[i] = seg[6 + 3 * i];
        // sampling factors seg[7+3i] assumed 0x11 (true for DNG LJPEG)
      }
    } else if (marker == 0xC4) {  // DHT
      const uint8_t* q = seg;
      while (q < seg_end) {
        int tc_th = *q++;
        int th = tc_th & 0x0F;
        if (th > 3) return -5;
        if (q + 16 > seg_end) return -3;
        uint8_t counts[16];
        int nvals = 0;
        for (int i = 0; i < 16; ++i) {
          counts[i] = q[i];
          nvals += q[i];
        }
        q += 16;
        if (nvals > 256 || q + nvals > seg_end) return -3;
        tables[th].build(counts, q, nvals);
        q += nvals;
      }
    } else if (marker == 0xDD) {  // DRI: restart intervals
      if (seg + 2 > seg_end) return -3;
      int interval = (seg[0] << 8) | seg[1];
      // Restart markers would need predictor/bit-reader resynchronization;
      // the zero-padding BitReader would silently corrupt everything after
      // the first RSTn instead — error out loudly. (No DNG writer we know
      // of emits DRI for lossless strips.)
      if (interval != 0) return -10;
    } else if (marker == 0xDA) {  // SOS
      if (seg + 1 > seg_end) return -3;
      nscan = seg[0];
      if (nscan > 4 || seg + 4 + 2 * nscan > seg_end) return -3;
      for (int i = 0; i < nscan; ++i) {
        int cid = seg[1 + 2 * i];
        int tbl = (seg[2 + 2 * i] >> 4) & 0x0F;
        if (tbl > 3) return -5;
        for (int c = 0; c < ncomp; ++c) {
          if (comp_id[c] == cid) comp_tbl[c] = tbl;
        }
      }
      predictor = seg[1 + 2 * nscan];
      pt = seg[3 + 2 * nscan] & 0x0F;
      entropy = p + seglen;
      break;
    } else if (marker == 0xD9) {
      break;
    }
    p += seglen;
  }

  if (!entropy || width <= 0 || height <= 0 || ncomp <= 0) return -6;
  if (precision < 2 || precision > 16 || pt < 0 || pt >= precision) return -6;
  long total = long(width) * height * ncomp;
  if (total > max_out_samples) return -7;

  BitReader br(entropy, size_t(end - entropy));
  std::vector<int32_t> prev_row(size_t(width) * ncomp);
  std::vector<int32_t> cur_row(size_t(width) * ncomp);
  int default_pred = 1 << (precision - pt - 1);

  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      for (int c = 0; c < ncomp; ++c) {
        const Huff& h = tables[comp_tbl[c]];
        if (!h.valid) return -8;
        int ssss = h.decode(br);
        if (ssss < 0) return -9;
        int diff = extend(receive(br, ssss), ssss);
        if (ssss == 16) diff = 32768;

        int32_t pred;
        int32_t a = x > 0 ? cur_row[size_t(x - 1) * ncomp + c] : 0;
        int32_t b = y > 0 ? prev_row[size_t(x) * ncomp + c] : 0;
        int32_t cc = (x > 0 && y > 0) ? prev_row[size_t(x - 1) * ncomp + c] : 0;
        if (y == 0 && x == 0) {
          pred = default_pred;
        } else if (y == 0) {
          pred = a;
        } else if (x == 0) {
          pred = b;
        } else {
          switch (predictor) {
            case 1: pred = a; break;
            case 2: pred = b; break;
            case 3: pred = cc; break;
            case 4: pred = a + b - cc; break;
            case 5: pred = a + ((b - cc) >> 1); break;
            case 6: pred = b + ((a - cc) >> 1); break;
            case 7: pred = (a + b) >> 1; break;
            default: pred = a; break;
          }
        }
        int32_t val = (pred + diff) & 0xFFFF;
        cur_row[size_t(x) * ncomp + c] = val;
        out[(size_t(y) * width + x) * ncomp + c] = uint16_t(val);
      }
    }
    std::swap(prev_row, cur_row);
  }

  *out_w = width;
  *out_h = height;
  *out_comps = ncomp;
  return 0;
}

// Decode a Nikon-compressed NEF bitstream (Compression 34713, the scheme
// LibRaw/dcraw call nikon_load_raw). The entropy stream is a Huffman-coded
// predictor residual stream — LJPEG-style categories but with Nikon's FIXED
// Huffman trees (passed in as JPEG-canonical counts/values, they are format
// constants), a two-column predictor state seeded from the MakerNote's
// vpred[2][2], and an optional linearization curve. Unlike JPEG entropy
// data there is NO 0xFF byte stuffing. `split_row` switches to the second
// tree mid-image (lossy "split" variants); pass 0 when absent. Symbol
// values carry an optional shift in the high nibble (len = v & 15,
// shl = v >> 4), used by the lossy-after-split trees; for the lossless
// trees shl is always 0 and the residual coding reduces to T.81 extend.
int r2f_decode_nef(const uint8_t* src, long len, const uint8_t* counts1,
                   const uint8_t* values1, int nvals1, const uint8_t* counts2,
                   const uint8_t* values2, int nvals2, int split_row,
                   const uint16_t* vpred_in, const uint16_t* curve,
                   long curve_len, int width, int height, uint16_t* out) {
  if (width <= 0 || height <= 0 || curve_len <= 0) return -1;
  // Full 16-bit decode LUTs: entry = (code_length << 8) | symbol, 0xffff =
  // invalid prefix. One table hit per symbol instead of the canonical
  // bit-by-bit walk (128 KB/table, built once per frame).
  auto build_lut16 = [](const uint8_t counts[16], const uint8_t* vals,
                        int nvals, std::vector<uint16_t>& t) {
    t.assign(65536, 0xffff);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int c = 0; c < counts[l - 1]; ++c, ++k, ++code) {
        // Counts outnumbering the listed values pad with symbol 0: the
        // dcraw nikon_tree rows rely on their trailing zero bytes (the
        // 12-bit lossy tree lists 13 values for 14 codes).
        uint8_t v = k < nvals ? vals[k] : 0;
        uint32_t base = uint32_t(code) << (16 - l);
        uint32_t span = 1u << (16 - l);
        for (uint32_t f = 0; f < span; ++f)
          t[base + f] = uint16_t((l << 8) | v);
      }
      code <<= 1;
    }
  };
  std::vector<uint16_t> lut[2];
  build_lut16(counts1, values1, nvals1, lut[0]);
  if (split_row > 0 && counts2 && values2) {
    build_lut16(counts2, values2, nvals2, lut[1]);
  }

  // Plain MSB-first bit reader (no JPEG stuffing, no markers).
  const uint8_t* p = src;
  const uint8_t* end = src + len;
  uint32_t bits = 0;
  int nbits = 0;
  auto fill = [&]() {
    while (nbits <= 24) {
      uint8_t b = p < end ? *p++ : 0;
      bits |= uint32_t(b) << (24 - nbits);
      nbits += 8;
    }
  };
  auto getbits = [&](int n) -> int {
    if (n <= 0) return 0;
    fill();
    uint32_t v = bits >> (32 - n);
    bits <<= n;
    nbits -= n;
    return int(v);
  };
  auto gethuff = [&](const std::vector<uint16_t>& t) -> int {
    fill();
    uint16_t e = t[size_t(bits >> 16)];
    if (e == 0xffff) return -1;
    bits <<= (e >> 8);
    nbits -= (e >> 8);
    return e & 0xff;
  };

  int32_t vpred[2][2] = {
      {int32_t(vpred_in[0]), int32_t(vpred_in[1])},
      {int32_t(vpred_in[2]), int32_t(vpred_in[3])}};
  int32_t hpred[2] = {0, 0};
  const std::vector<uint16_t>* h = &lut[0];
  for (int row = 0; row < height; ++row) {
    if (split_row > 0 && row == split_row) h = &lut[1];
    for (int col = 0; col < width; ++col) {
      int sym = gethuff(*h);
      if (sym < 0) return -9;
      int len = sym & 15, shl = sym >> 4;
      int diff = ((getbits(len - shl) << 1) + 1) << shl >> 1;
      if (len > 0 && (diff & (1 << (len - 1))) == 0) {
        diff -= (1 << len) - (shl ? 0 : 1);
      }
      if (col < 2) {
        hpred[col] = vpred[row & 1][col] += diff;
      } else {
        hpred[col & 1] += diff;
      }
      int32_t v = hpred[col & 1];
      if (v < 0) v = 0;
      if (v >= curve_len) v = int32_t(curve_len - 1);
      out[size_t(row) * width + col] = curve[v];
    }
  }
  return 0;
}

// Decode a Panasonic RW2 v4 bitstream (RawFormat 4, 12-bit — the scheme
// LibRaw/dcraw call panasonic_load_raw and rawspeed's
// PanasonicDecompressorV4). Layout: the stream is split into 0x4000-byte
// sections whose first 0x1ff8 bytes are stored LAST (section rotation,
// dcraw load_flags 0x2008); each section holds 1024 fixed-size 16-byte
// packets of 14 pixels, packet k at bytes [16k, 16(k+1)) in FORWARD order
// (dcraw's pana_bits byte index is `vbits >> 3 ^ 0x3ff0`: the XOR flips
// only the within-packet byte order, not the packet sequence). Within a
// packet, with v = 128 - p bits remaining after a read of n ends at
// bit-position p, the value is ((pk[v>>3] | pk[(v>>3)+1]<<8) >> (v&7)) &
// mask — each byte consumed from its high bits down, spanning reads borrow
// the NEXT byte's low bits; this packs the per-packet read sequence (two
// 12-bit lane seeds, 2-bit shift tokens before every third pixel, 8-bit
// deltas) bijectively into exactly 128 bits. Per 14-pixel packet: two
// interleaved predictor lanes; deltas are signed in units of 1<<sh with a
// reseed quirk at sh==4.
int r2f_decode_rw2_v4(const uint8_t* src, long len, int width, int height,
                      uint16_t* out) {
  if (width <= 0 || height <= 0 || width % 14 != 0) return -1;
  const long SECTION = 0x4000;
  const long SPLIT = 0x1ff8;  // bytes of each section stored at the end
  const long PPS = (SECTION / 16) * 14;  // pixels per section
  long npix = long(width) * height;
  long n_sections = (npix + PPS - 1) / PPS;

  // Sections are self-contained (per-packet predictor state): decode them
  // in parallel.
  auto section_worker = [&](long s0, long s1) {
  std::vector<uint8_t> sec(SECTION + 2, 0);
  for (long s = s0; s < s1; ++s) {
    long sec_base = s * SECTION;
    long pix = s * PPS;
    // Un-rotate: buffer = file[split:SECTION] + file[0:split].
    for (long i = 0; i < SECTION; ++i) {
      long fo = sec_base + ((i < SECTION - SPLIT) ? (SPLIT + i)
                                                  : (i - (SECTION - SPLIT)));
      sec[size_t(i)] = fo < len ? src[fo] : 0;
    }
    sec[SECTION] = sec[SECTION + 1] = 0;

    long sec_pixels = npix - pix < PPS ? npix - pix : PPS;
    for (long pk = 0; pk * 14 < sec_pixels; ++pk) {
      const uint8_t* buf = sec.data() + 16 * pk;
      int p = 0;  // bits consumed within this packet
      auto bits = [&](int n) -> int {
        p += n;
        int v = 128 - p;  // bits remaining
        return ((buf[v >> 3] | (buf[(v >> 3) + 1] << 8)) >> (v & 7)) &
               ((1 << n) - 1);
      };
      int pred[2] = {0, 0}, nonz[2] = {0, 0}, sh = 0;
      for (int i = 0; i < 14; ++i) {
        if (i % 3 == 2) sh = 4 >> (3 - bits(2));
        if (nonz[i & 1]) {
          int j = bits(8);
          if (j) {
            pred[i & 1] -= 0x80 << sh;
            if (pred[i & 1] < 0 || sh == 4) pred[i & 1] &= ~(-1 << sh);
            pred[i & 1] += j << sh;
          }
        } else {
          nonz[i & 1] = bits(8);
          if (nonz[i & 1] || i > 11) {
            pred[i & 1] = (nonz[i & 1] << 4) | bits(4);
          }
        }
        long idx = pix + pk * 14 + i;
        if (idx < npix) out[idx] = uint16_t(pred[i & 1] & 0xffff);
      }
    }
  }
  };
  int nthreads = int(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  if (nthreads == 1 || n_sections < 2) {
    section_worker(0, n_sections);
  } else {
    std::vector<std::thread> threads;
    long per = (n_sections + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      long s0 = t * per;
      long s1 = s0 + per < n_sections ? s0 + per : n_sections;
      if (s0 >= s1) break;
      threads.emplace_back(section_worker, s0, s1);
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}

// Decode a Pentax-Huffman PEF stream (Compression 65535 — the scheme
// LibRaw/dcraw call pentax_load_raw). The Huffman table comes from
// MakerNote tag 0x0220 as per-symbol (left-aligned 12-bit code start,
// code length) pairs; symbol value = storage index = the T.81 ssss
// category of the following signed residual. Predictors are the NEF
// two-column scheme with zero-initialized vpred. Plain MSB-first
// bitstream, no byte stuffing.
int r2f_decode_pef(const uint8_t* src, long len, const uint16_t* starts,
                   const uint8_t* lens, int nsym, int width, int height,
                   uint16_t* out) {
  if (width <= 0 || height <= 0 || nsym <= 0 || nsym > 16) return -1;
  // 12-bit peek lookup: table[peek] = (len << 8) | symbol.
  std::vector<uint16_t> table(4096, 0xffff);
  for (int c = 0; c < nsym; ++c) {
    int L = lens[c];
    if (L < 1 || L > 12) return -3;
    int range = 4096 >> L;
    int s = starts[c] & 4095;
    for (int i = 0; i < range; ++i) table[(s + i) & 4095] = uint16_t((L << 8) | c);
  }

  const uint8_t* p = src;
  const uint8_t* end = src + len;
  uint32_t bits = 0;
  int nbits = 0;
  auto fill = [&]() {
    while (nbits <= 24) {
      uint8_t b = p < end ? *p++ : 0;
      bits |= uint32_t(b) << (24 - nbits);
      nbits += 8;
    }
  };
  auto peek12 = [&]() -> int {
    fill();
    return int(bits >> 20);
  };
  auto consume = [&](int n) {
    bits <<= n;
    nbits -= n;
  };
  auto getbits = [&](int n) -> int {
    if (n <= 0) return 0;
    fill();
    uint32_t v = bits >> (32 - n);
    consume(n);
    return int(v);
  };

  int32_t vpred[2][2] = {{0, 0}, {0, 0}};
  int32_t hpred[2] = {0, 0};
  for (int row = 0; row < height; ++row) {
    for (int col = 0; col < width; ++col) {
      uint16_t t = table[size_t(peek12())];
      if (t == 0xffff) return -9;
      consume(t >> 8);
      int ssss = t & 0xff;
      int diff = ssss == 16 ? 32768 : extend(getbits(ssss), ssss);
      if (col < 2) {
        hpred[col] = vpred[row & 1][col] += diff;
      } else {
        hpred[col & 1] += diff;
      }
      out[size_t(row) * width + col] = uint16_t(hpred[col & 1] & 0xffff);
    }
  }
  return 0;
}

// Decode an Olympus-compressed ORF stream (the scheme LibRaw/dcraw call
// olympus_load_raw). Per pixel: a 3-bit (sign, low2) group, a Huffman-coded
// "high" magnitude with a FIXED canonical table (symbol s in 0..11 has
// length s+1; the all-zeros 12-bit code is the escape: high then arrives
// as getbits(16-nbits)>>1), and nbits low bits — with an adaptive nbits
// driven by a per-column-parity carry filter. Prediction is a w/n/nw
// gradient selector over the two-column lattice. Values are
// pred + (diff << 2 | low). Plain MSB bitstream; the payload's first 7
// bytes are skipped (format constant).
int r2f_decode_orf(const uint8_t* src, long len, int width, int height,
                   uint16_t* out) {
  if (width <= 0 || height <= 0) return -1;
  const uint8_t* p = src + 7 < src + len ? src + 7 : src + len;
  const uint8_t* end = src + len;
  uint32_t bits = 0;
  int nb = 0;
  auto fill = [&]() {
    while (nb <= 24) {
      uint8_t b = p < end ? *p++ : 0;
      bits |= uint32_t(b) << (24 - nb);
      nb += 8;
    }
  };
  auto getbits = [&](int n) -> int {
    if (n <= 0) return 0;
    fill();
    uint32_t v = bits >> (32 - n);
    bits <<= n;
    nb -= n;
    return int(v);
  };
  auto peek12 = [&]() -> int {
    fill();
    return int(bits >> 20);
  };
  auto consume = [&](int n) {
    bits <<= n;
    nb -= n;
  };

  auto raw = [&](int r, int c) -> int32_t {
    return int32_t(out[size_t(r) * width + c]);
  };

  int32_t acarry[2][3];
  for (int row = 0; row < height; ++row) {
    std::memset(acarry, 0, sizeof acarry);
    for (int col = 0; col < width; ++col) {
      int32_t* carry = acarry[col & 1];
      int i = 2 * (carry[2] < 3);
      int nbits;
      for (nbits = 2 + i; (uint16_t(carry[0]) >> (nbits + i)) != 0; ++nbits) {
      }
      int sl = getbits(3);
      int low = sl & 3;
      int32_t sign = (sl & 4) ? -1 : 0;
      // Fixed Huffman: symbol s (0..11) = s+1 leading... canonical table
      // where the peek's leading-zero count selects the symbol; peek 0 is
      // the 12-bit escape (symbol 12).
      int pk = peek12();
      int high;
      if (pk == 0) {
        consume(12);
        high = getbits(16 - nbits) >> 1;
      } else {
        // Leading zeros in the 12-bit window: symbol s has code
        // 0^s 1 (length s+1), s in 0..11.
        int s = 0;
        while (((pk >> (11 - s)) & 1) == 0) ++s;
        consume(s + 1);
        high = s;
      }
      carry[0] = (high << nbits) | getbits(nbits);
      int diff = (carry[0] ^ sign) + carry[1];
      carry[1] = (diff * 3 + carry[1]) >> 5;
      carry[2] = carry[0] > 16 ? 0 : carry[2] + 1;

      int32_t pred;
      if (row < 2 && col < 2) {
        pred = 0;
      } else if (row < 2) {
        pred = raw(row, col - 2);
      } else if (col < 2) {
        pred = raw(row - 2, col);
      } else {
        int32_t w = raw(row, col - 2);
        int32_t n = raw(row - 2, col);
        int32_t nw = raw(row - 2, col - 2);
        if ((w < nw && nw < n) || (n < nw && nw < w)) {
          if (std::abs(w - nw) > 32 || std::abs(n - nw) > 32) {
            pred = w + n - nw;
          } else {
            pred = (w + n) >> 1;
          }
        } else {
          pred = std::abs(w - nw) > std::abs(n - nw) ? w : n;
        }
      }
      out[size_t(row) * width + col] =
          uint16_t((pred + ((diff << 2) | low)) & 0xffff);
    }
  }
  return 0;
}

// Decode a Sony cRAW / ARW2 stream (Compression 32767 — the scheme
// LibRaw/dcraw call sony_arw2_load_raw). Each row is `width` BYTES; every
// 16-byte block codes 16 pixels of one Bayer phase (blocks alternate
// even/odd columns: after a block the column cursor advances by 1 for an
// odd phase, or jumps back 31 to interleave). Block layout (little
// endian): bits 0..10 max, 11..21 min, 22..25 imax, 26..29 imin, then
// fourteen 7-bit deltas from bit 30; delta shift sh is the smallest s in
// 0..4 with (0x80 << s) > max - min. Decoded 11-bit values expand through
// `curve` (4096 entries -> linear sensor units; identity<<2 when the SR2
// tone curve is unavailable, dcraw's no-tag default).
int r2f_decode_arw2(const uint8_t* src, long len, int width, int height,
                    const uint16_t* curve, uint16_t* out) {
  if (width <= 0 || height <= 0) return -1;
  if (long(width) * height > len) return -2;  // one byte per pixel
  // Rows carry no cross-row state: decode them in parallel (the whole
  // call already runs outside the GIL via ctypes).
  int nthreads = int(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  auto rows_worker = [&](int r0, int r1) {
  // Row copy with a guard byte: the final 7-bit delta read of a block
  // touches dp[16] (masked out), which for the last block of the last row
  // is one past the payload.
  std::vector<uint8_t> rowbuf(size_t(width) + 2, 0);
  for (int row = r0; row < r1; ++row) {
    std::memcpy(rowbuf.data(), src + long(row) * width, size_t(width));
    const uint8_t* data = rowbuf.data();
    int col = 0;
    for (const uint8_t* dp = data; col < width - 30; dp += 16) {
      uint32_t val = uint32_t(dp[0]) | (uint32_t(dp[1]) << 8) |
                     (uint32_t(dp[2]) << 16) | (uint32_t(dp[3]) << 24);
      int max = val & 0x7ff;
      int min = (val >> 11) & 0x7ff;
      int imax = (val >> 22) & 0x0f;
      int imin = (val >> 26) & 0x0f;
      int sh;
      for (sh = 0; sh < 4 && (0x80 << sh) <= max - min; ++sh) {
      }
      uint16_t pix[16];
      int bit = 30;
      for (int i = 0; i < 16; ++i) {
        if (i == imax) {
          pix[i] = uint16_t(max);
        } else if (i == imin) {
          pix[i] = uint16_t(min);
        } else {
          int word = (dp[bit >> 3] | (dp[(bit >> 3) + 1] << 8));
          int v = (((word >> (bit & 7)) & 0x7f) << sh) + min;
          pix[i] = uint16_t(v > 0x7ff ? 0x7ff : v);
          bit += 7;
        }
      }
      for (int i = 0; i < 16; ++i, col += 2) {
        out[size_t(row) * width + col] = curve[(pix[i] << 1) & 0xfff] >> 2;
      }
      col -= (col & 1) ? 1 : 31;
    }
  }
  };
  if (nthreads == 1 || height < 2 * nthreads) {
    rows_worker(0, height);
  } else {
    std::vector<std::thread> threads;
    int rows_per = (height + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      int r0 = t * rows_per;
      int r1 = r0 + rows_per < height ? r0 + rows_per : height;
      if (r0 >= r1) break;
      threads.emplace_back(rows_worker, r0, r1);
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}

// Fast strip unpack: 16-bit (little/big endian) or 8-bit source to float32
// with black-level subtraction and normalization.
void r2f_unpack_normalize(const uint8_t* src, long n_samples, int bits,
                          int big_endian, float black, float inv_range,
                          float* dst) {
  if (bits == 16) {
    const uint8_t* q = src;
    for (long i = 0; i < n_samples; ++i, q += 2) {
      uint16_t v = big_endian ? uint16_t((q[0] << 8) | q[1])
                              : uint16_t(q[0] | (q[1] << 8));
      float f = (float(v) - black) * inv_range;
      dst[i] = f < 0.f ? 0.f : (f > 1.f ? 1.f : f);
    }
  } else {
    for (long i = 0; i < n_samples; ++i) {
      float f = (float(src[i]) - black) * inv_range;
      dst[i] = f < 0.f ? 0.f : (f > 1.f ? 1.f : f);
    }
  }
}

// Threaded bilinear remap (clamp-to-edge): the lens-distortion resample.
// Measured at 24MP x3 channels: scipy map_coordinates needs ~3.1 s
// (single-thread float64) and a naive XLA:TPU gather ~4.2 s — scattered
// gathers don't map to the TPU's tiled memory at all — so this stage
// belongs on host, done properly: float32, threads over row blocks.
// coords are (2, H, W): source y then source x per output pixel, shared
// across channels (the radial map is channel-independent).
void r2f_remap_bilinear(const float* src, int channels, int h, int w,
                        const float* coords_y, const float* coords_x,
                        float* dst) {
  int nthreads = int(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 32) nthreads = 32;
  auto worker = [&](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      for (int x = 0; x < w; ++x) {
        float fy = coords_y[size_t(y) * w + x];
        float fx = coords_x[size_t(y) * w + x];
        if (fy < 0.f) fy = 0.f;
        if (fy > float(h - 1)) fy = float(h - 1);
        if (fx < 0.f) fx = 0.f;
        if (fx > float(w - 1)) fx = float(w - 1);
        int iy = int(fy);
        int ix = int(fx);
        int iy1 = iy + 1 < h ? iy + 1 : iy;
        int ix1 = ix + 1 < w ? ix + 1 : ix;
        float wy = fy - float(iy);
        float wx = fx - float(ix);
        for (int c = 0; c < channels; ++c) {
          const float* plane = src + size_t(c) * h * w;
          float v00 = plane[size_t(iy) * w + ix];
          float v01 = plane[size_t(iy) * w + ix1];
          float v10 = plane[size_t(iy1) * w + ix];
          float v11 = plane[size_t(iy1) * w + ix1];
          float top = v00 + (v01 - v00) * wx;
          float bot = v10 + (v11 - v10) * wx;
          dst[size_t(c) * h * w + size_t(y) * w + x] = top + (bot - top) * wy;
        }
      }
    }
  };
  std::vector<std::thread> threads;
  int rows_per = (h + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int y0 = t * rows_per;
    int y1 = y0 + rows_per < h ? y0 + rows_per : h;
    if (y0 >= y1) break;
    threads.emplace_back(worker, y0, y1);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Fuji lossless-compressed RAF (the scheme modern X/GFX bodies write by
// default; the reference ingests it through LibRaw, reference:
// src/raw2film/raw_conversion.py:36-48). Reimplemented from the format's
// public structure — a JPEG-LS-style predictor/Golomb coder over
// per-color "lines":
//
//   * The raw frame is cut into vertical strips of `block_size` columns
//     (768 on real bodies), each compressed independently (threaded here).
//   * Each strip is coded six mosaic rows at a time into subsampled color
//     lines (2 samples per 3 columns for X-Trans, 1 per 2 for Bayer):
//     R/B get one line per two rows, G one line per row. Line cells that
//     no sensor pixel maps to are not coded — the decoder fills them with
//     the same neighbor interpolation the coded path predicts with.
//   * Samples are coded even positions first (running eight ahead), then
//     odd; pairs of lines interleave per pass in the fixed order
//     (R2,G2)(G3,B2)(R3,G4)(G5,B3)(R4,G6)(G7,B4) with three gradient
//     context sets cycling across passes.
//   * A code is unary zero-count + adaptive-width remainder (width from a
//     per-gradient (sum,count) pair, LOCO-I style), with a raw escape
//     after max_bits-raw_bits-1 zeros; values fold sign via zig-zag and
//     wrap modulo the sample range.
//
// COMPATIBILITY NOTE: reconstructed from format knowledge and validated
// by round-trips against this repo's own spec-based encoder
// (tests/raw_fixtures.py::fuji_compress) plus the geometric
// cross-check that interpolated cells are exactly the cells unused by
// the CFA layout. Not yet verified against camera-written files; any
// mismatch aborts cleanly (code-range guard, unary-run cap, and a
// bitstream-consumption check per strip) instead of returning garbage.

namespace fuji {

struct Params {
  int q1, q2, q3;    // gradient quantizer thresholds (0x12, 0x43, 0x114)
  int max_value;     // (1 << raw_bits) - 1
  int total_values;  // max_value + 1
  int raw_bits;
  int max_bits;      // 4 * raw_bits (unary escape threshold basis)
  int min_value;     // 0x40: gradient-context renormalization point
  int max_diff;      // initial gradient sum: max(2, (total+0x20) >> 6)
};

struct Grad {
  int v1;  // accumulated |error|
  int v2;  // count
};

struct BitIn {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  long consumed_bits = 0;
  bool fail = false;

  BitIn(const uint8_t* data, long len) : p(data), end(data + len) {}

  inline void fill() {
    if (n > 55) return;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (end - p >= 8) {
      // Bulk path: one unaligned 64-bit load replaces up to seven
      // byte-at-a-time bound checks (the decode hot loop refills every
      // code). Only whole bytes the cursor actually advances over are
      // OR'd in; the tail (<8 bytes left) falls back to the byte loop.
      uint64_t chunk;
      std::memcpy(&chunk, p, 8);
      chunk = __builtin_bswap64(chunk);
      int bytes = (63 - n) >> 3;
      acc |= (chunk & (~0ULL << (64 - 8 * bytes))) >> n;
      p += bytes;
      n += 8 * bytes;
      return;
    }
#endif
    while (n <= 55) {
      uint64_t b = p < end ? *p++ : 0;  // zero padding past the end is
      acc |= b << (56 - n);             // caught by the consumption check
      n += 8;
    }
  }

  inline uint32_t get(int k) {
    if (k <= 0) return 0;
    fill();
    uint32_t v = uint32_t(acc >> (64 - k));
    acc <<= k;
    n -= k;
    consumed_bits += k;
    return v;
  }

  // Count zero bits up to and excluding the terminating one-bit (which is
  // consumed). Runs longer than 64 mean a desynced/corrupt stream.
  inline int zeros_until_one() {
    int count = 0;
    for (;;) {
      fill();
      if (acc == 0) {
        consumed_bits += n;
        count += n;
        n = 0;
        if (p >= end || count > 64) {
          fail = true;
          return count;
        }
        continue;
      }
      int lz = __builtin_clzll(acc);
      count += lz;
      acc <<= lz + 1;
      n -= lz + 1;
      consumed_bits += lz + 1;
      if (count > 64) fail = true;
      return count;
    }
  }
};

// Line-buffer plane layout: 18 rows of (line_width + 2) cells — R0..R4,
// G0..G7, B0..B4 with one pad column each side. Two context rows per
// plane; the other rows are decoded per six-row set.
enum Line {
  R0 = 0, R1, R2, R3, R4,
  G0, G1, G2, G3, G4, G5, G6, G7,
  B0, B1, B2, B3, B4,
  LTOTAL
};

inline int iabs(int v) { return v < 0 ? -v : v; }

struct StripDecoder {
  Params P;
  BitIn in;
  int lw;  // line width (samples per coded line)
  std::vector<uint16_t> buf;
  Grad grad_even[3][41];
  Grad grad_odd[3][41];
  int errcnt = 0;

  StripDecoder(const Params& params, const uint8_t* data, long len, int line_width)
      : P(params), in(data, len), lw(line_width), buf(size_t(LTOTAL) * (line_width + 2), 0) {
    for (int s = 0; s < 3; ++s)
      for (int g = 0; g < 41; ++g) {
        grad_even[s][g] = {P.max_diff, 1};
        grad_odd[s][g] = {P.max_diff, 1};
      }
  }

  inline uint16_t* cell(int line, int c) { return &buf[size_t(line) * (lw + 2) + c]; }

  inline int qclass(int d) const {
    int a = iabs(d);
    int c;
    if (a >= P.q3) c = 4;
    else if (a >= P.q2) c = 3;
    else if (a >= P.q1) c = 2;
    else if (a > 0) c = 1;
    else c = 0;
    return d < 0 ? -c : c;
  }

  static inline int bit_diff(int v1, int v2) {
    int k = 0;
    if (v2 < v1)
      while (k <= 12 && (v2 << ++k) < v1) {
      }
    return k;
  }

  // One coded residual: unary + adaptive remainder, zig-zag unfold,
  // gradient-context update. Returns the signed error.
  inline int read_code(Grad& g) {
    int zeros = in.zeros_until_one();
    int k;
    if (zeros < P.max_bits - P.raw_bits - 1) {
      int db = bit_diff(g.v1, g.v2);
      k = (zeros << db) | int(in.get(db));
    } else {
      k = int(in.get(P.raw_bits)) + 1;
    }
    if (k < 0 || k >= P.total_values) ++errcnt;
    int c = (k & 1) ? (-1 - k / 2) : (k / 2);
    g.v1 += iabs(c);
    if (g.v2 == P.min_value) {
      g.v1 >>= 1;
      g.v2 >>= 1;
    }
    g.v2 += 1;
    return c;
  }

  inline void store(int line, int c, int val) {
    if (val < 0) val += P.total_values;
    else if (val > P.max_value) val -= P.total_values;
    if (val < 0) val = 0;
    else if (val > P.max_value) val = P.max_value;
    *cell(line, c) = uint16_t(val);
  }

  // Even positions predict from the previous lines only (upper row of
  // the same color plane); the gradient context is (above-above2,
  // aboveleft-above).
  inline int interp_even_val(int l, int c) {
    int Rb = *cell(l - 1, c);
    int Rc = *cell(l - 1, c - 1);
    int Rd = *cell(l - 1, c + 1);
    int Rf = *cell(l - 2, c);
    int dC = iabs(Rc - Rb), dF = iabs(Rf - Rb), dD = iabs(Rd - Rb);
    if (dC > dF && dC > dD) return Rf + Rd + 2 * Rb;
    if (dD > dC && dD > dF) return Rf + Rc + 2 * Rb;
    return Rd + Rc + 2 * Rb;
  }

  inline void dec_even(int l, int pos, Grad* gs) {
    int c = pos + 1;
    int Rb = *cell(l - 1, c);
    int Rc = *cell(l - 1, c - 1);
    int Rf = *cell(l - 2, c);
    int grad = 9 * qclass(Rb - Rf) + qclass(Rc - Rb);
    int interp = interp_even_val(l, c);
    int code = read_code(gs[iabs(grad)]);
    store(l, c, grad < 0 ? (interp >> 2) - code : (interp >> 2) + code);
  }

  inline void fill_even(int l, int pos) {
    int c = pos + 1;
    *cell(l, c) = uint16_t(interp_even_val(l, c) >> 2);
  }

  // Odd positions see both horizontal neighbors (the even pass runs
  // ahead); context is (above-aboveleft, aboveleft-left).
  inline void dec_odd(int l, int pos, Grad* gs) {
    int c = pos + 1;
    int Ra = *cell(l, c - 1);
    int Rb = *cell(l - 1, c);
    int Rc = *cell(l - 1, c - 1);
    int Rd = *cell(l - 1, c + 1);
    int Rg = *cell(l, c + 1);
    int grad = 9 * qclass(Rb - Rc) + qclass(Rc - Ra);
    int interp;
    if ((Rb > Rc && Rb > Rd) || (Rb < Rc && Rb < Rd))
      interp = (Rg + Ra + 2 * Rb) >> 2;
    else
      interp = (Ra + Rg) >> 1;
    int code = read_code(gs[iabs(grad)]);
    store(l, c, grad < 0 ? interp - code : interp + code);
  }

  // fa/fb: even-position fill rule per line — -1 all coded, 4 all evens
  // filled, 0/2 evens with pos%4 == fa filled (derived from the CFA
  // layout: exactly the cells no sensor pixel maps to).
  void pass(int la, int lb, int gs, int fa, int fb) {
    // Pads of the lines being decoded come from the line above: left pad
    // = its first sample, right pad = its last (read as Ra/Rg at the
    // line ends).
    for (int l : {la, lb}) {
      *cell(l, 0) = *cell(l - 1, 1);
      *cell(l, lw + 1) = *cell(l - 1, lw);
    }
    int ae = 0, ao = 1, be = 0, bo = 1;
    while (be < lw || bo < lw) {
      if (be < lw) {
        if (fa == 4 || (fa >= 0 && (ae & 3) == fa)) fill_even(la, ae);
        else dec_even(la, ae, grad_even[gs]);
        ae += 2;
        if (fb == 4 || (fb >= 0 && (be & 3) == fb)) fill_even(lb, be);
        else dec_even(lb, be, grad_even[gs]);
        be += 2;
      }
      if ((be > 8 || be >= lw) && bo < lw) {
        dec_odd(la, ao, grad_odd[gs]);
        ao += 2;
        dec_odd(lb, bo, grad_odd[gs]);
        bo += 2;
      }
    }
  }

  void decode_set(const int fill_rule[6]) {
    pass(R2, G2, 0, fill_rule[0], -1);
    pass(G3, B2, 1, -1, fill_rule[1]);
    pass(R3, G4, 2, fill_rule[2], -1);
    pass(G5, B3, 0, -1, fill_rule[3]);
    pass(R4, G6, 1, fill_rule[4], -1);
    pass(G7, B4, 2, fill_rule[5], -1);
  }

  void rotate() {
    size_t row = size_t(lw) + 2;
    std::memcpy(cell(R0, 0), cell(R3, 0), row * sizeof(uint16_t));
    std::memcpy(cell(R1, 0), cell(R4, 0), row * sizeof(uint16_t));
    std::memcpy(cell(G0, 0), cell(G6, 0), row * sizeof(uint16_t));
    std::memcpy(cell(G1, 0), cell(G7, 0), row * sizeof(uint16_t));
    std::memcpy(cell(B0, 0), cell(B3, 0), row * sizeof(uint16_t));
    std::memcpy(cell(B1, 0), cell(B4, 0), row * sizeof(uint16_t));
  }
};

// Map a block-local column to its coded-line cell: 2 cells per 3 columns
// (X-Trans) or 1 per 2 (Bayer).
inline int xtrans_cell_index(int p) {
  return (((p * 2 / 3) & ~1) | ((p % 3) & 1)) + ((p % 3) >> 1);
}

// Derive per-line even-fill rules from the CFA layout: for each R/B line
// (a pair of mosaic rows), the even cells no sensor pixel maps to are
// interpolated rather than coded. Returns false for layouts this coder
// cannot represent (an unused odd cell).
inline bool xtrans_fill_rules(const uint8_t* pat, int rules[6]) {
  // rules order matches decode_set: R2, B2, R3, B3, R4, B4.
  const int line_color[6] = {0, 2, 0, 2, 0, 2};
  const int line_rows[6][2] = {{0, 1}, {0, 1}, {2, 3}, {2, 3}, {4, 5}, {4, 5}};
  for (int i = 0; i < 6; ++i) {
    bool used[4] = {false, false, false, false};
    for (int r = 0; r < 2; ++r) {
      int row = line_rows[i][r];
      for (int p = 0; p < 12; ++p) {  // two 6-col periods cover idx mod 4
        if (pat[row * 6 + (p % 6)] == line_color[i])
          used[xtrans_cell_index(p) & 3] = true;
      }
    }
    if (!used[1] || !used[3]) return false;  // unused odd cell: no fill path
    if (!used[0] && !used[2]) rules[i] = 4;
    else if (!used[0]) rules[i] = 0;
    else if (!used[2]) rules[i] = 2;
    else rules[i] = -1;
  }
  return true;
}

}  // namespace fuji

// Decode a Fuji lossless-compressed payload (see the block comment above).
// `src` points at the strip-data region (after the 16-byte header and the
// 16-byte-aligned strip size table, which the Python caller parses);
// `strip_sizes` are the table's per-strip byte counts. `pattern` is 36
// CFA codes (X-Trans) or 4 (Bayer), 0=R 1=G 2=B, aligned to the frame
// origin. Output is the height x width mosaic.
int r2f_decode_fuji(const uint8_t* src, long len, int raw_bits, int is_xtrans,
                    int width, int height, int rounded_width, int block_size,
                    int blocks_in_row, int total_lines,
                    const uint32_t* strip_sizes, const uint8_t* pattern,
                    uint16_t* out) {
  if (width <= 0 || height <= 0 || blocks_in_row <= 0 || total_lines <= 0)
    return -1;
  if (raw_bits != 12 && raw_bits != 14 && raw_bits != 16) return -1;
  if (rounded_width < width || height % 6 != 0 || total_lines != height / 6)
    return -1;
  if (block_size <= 0 || block_size % 12 != 0) return -1;
  if (long(blocks_in_row - 1) * block_size >= rounded_width ||
      long(blocks_in_row) * block_size < rounded_width)
    return -1;
  long total = 0;
  for (int b = 0; b < blocks_in_row; ++b) {
    if (strip_sizes[b] > uint32_t(len)) return -1;
    total += strip_sizes[b];
  }
  if (total > len) return -1;

  fuji::Params P;
  P.q1 = 0x12;
  P.q2 = 0x43;
  P.q3 = 0x114;
  P.max_value = (1 << raw_bits) - 1;
  P.total_values = P.max_value + 1;
  P.raw_bits = raw_bits;
  P.max_bits = 4 * raw_bits;
  P.min_value = 0x40;
  P.max_diff = (P.total_values + 0x20) >> 6;
  if (P.max_diff < 2) P.max_diff = 2;

  int fill_rules[6];
  if (is_xtrans) {
    if (!fuji::xtrans_fill_rules(pattern, fill_rules)) return -2;
  } else {
    for (int i = 0; i < 6; ++i) fill_rules[i] = -1;
  }

  std::vector<long> strip_offsets(blocks_in_row);
  {
    long off = 0;
    for (int b = 0; b < blocks_in_row; ++b) {
      strip_offsets[b] = off;
      off += strip_sizes[b];
    }
  }

  std::vector<int> rcs(blocks_in_row, 0);
  auto decode_strip = [&](int b) {
    int col0 = b * block_size;
    int cols = (b + 1 == blocks_in_row) ? rounded_width - col0 : block_size;
    int lw = is_xtrans ? cols * 2 / 3 : cols / 2;
    if (is_xtrans ? (cols % 6 != 0) : (cols % 2 != 0)) {
      rcs[b] = -3;
      return;
    }
    fuji::StripDecoder dec(P, src + strip_offsets[b], strip_sizes[b], lw);
    for (int ls = 0; ls < total_lines; ++ls) {
      dec.decode_set(fill_rules);
      if (dec.errcnt || dec.in.fail) {
        rcs[b] = 1;  // corrupt / unrecognized bitstream variant
        return;
      }
      // Copy the six decoded mosaic rows out.
      for (int r = 0; r < 6; ++r) {
        int row = ls * 6 + r;
        if (row >= height) break;
        for (int p = 0; p < cols; ++p) {
          int col = col0 + p;
          if (col >= width) break;
          int line, idx;
          uint8_t code = is_xtrans ? pattern[(row % 6) * 6 + (col % 6)]
                                   : pattern[(row % 2) * 2 + (col % 2)];
          if (is_xtrans) idx = fuji::xtrans_cell_index(p);
          else idx = p >> 1;
          if (code == 0) line = fuji::R2 + r / 2;
          else if (code == 1) line = fuji::G2 + r;
          else line = fuji::B2 + r / 2;
          out[size_t(row) * width + col] = *dec.cell(line, idx + 1);
        }
      }
      dec.rotate();
    }
    // Consumption check: a wrong schedule reads the wrong number of bits.
    long consumed = (dec.in.consumed_bits + 7) / 8;
    long size = strip_sizes[b];
    if (consumed > size || size - consumed > 512) rcs[b] = 2;
  };

  int nthreads = int(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > blocks_in_row) nthreads = blocks_in_row;
  if (nthreads > 16) nthreads = 16;
  if (nthreads <= 1) {
    for (int b = 0; b < blocks_in_row; ++b) decode_strip(b);
  } else {
    std::vector<std::thread> threads;
    std::atomic<int> next{0};
    for (int t = 0; t < nthreads; ++t)
      threads.emplace_back([&]() {
        for (;;) {
          int b = next.fetch_add(1);
          if (b >= blocks_in_row) return;
          decode_strip(b);
        }
      });
    for (auto& th : threads) th.join();
  }
  for (int b = 0; b < blocks_in_row; ++b)
    if (rcs[b] != 0) return rcs[b];
  return 0;
}

// ---------------------------------------------------------------------------
// Canon CRW (CIFF) compressed raw: the pre-CR2 10-bit Huffman codec.
//
// The reference ingests CRW via LibRaw (reference:
// src/raw2film/raw_conversion.py:36-48; extension list src/raw2film/
// data.py:87-102). Semantics mirror dcraw's canon_compressed_load_raw:
// 64-pixel blocks of Huffman-coded differences (first symbol from a DC
// tree, the rest from an AC tree; symbol = run<<4 | ssss, 0x00 = end of
// block, 0xff = no-op), a DC carry that chains across every block of the
// image, per-row base[2] accumulators reset to 512 at each row start
// (even/odd pixel interleave), and an optional 2-bit low-bits plane that
// widens 10-bit values to 12. The three fixed code tables are published
// dcraw constants (selected by CIFF DecoderTable tag 0x1835), reproduced
// from format knowledge; the synthetic-encoder round trips in
// tests/test_raw_formats.py pin the codec structure, and decode aborts on
// 10-bit overflows (the signal a wrong table produces immediately).
namespace {

// Direct-lookup Huffman decoder matching dcraw's make_decoder: canonical
// codes assigned in (length, order-of-appearance) order, materialized as a
// 2^max table of (len<<8 | value) entries. Codes past the 2^max space are
// silently dropped (the published tables overfill length 16; real streams
// never use the dropped tail).
struct CrwHuff {
  std::vector<uint16_t> lut;  // (len << 8) | value; 0 = invalid
  int maxlen = 0;

  void build(const uint8_t* counts16, const uint8_t* vals) {
    int max = 16;
    while (max && !counts16[max - 1]) --max;
    maxlen = max;
    lut.assign(size_t(1) << max, 0);
    size_t h = 0;
    const uint8_t* v = vals;
    for (int len = 1; len <= max; ++len)
      for (int i = 0; i < counts16[len - 1]; ++i, ++v)
        for (int j = 0; j < (1 << (max - len)); ++j)
          if (h < lut.size()) lut[h++] = uint16_t(len << 8 | *v);
  }

  // Returns the symbol, or -1 on an invalid code.
  inline int decode(BitReader& br) const {
    uint16_t e = lut[br.peek(maxlen)];
    if (!(e >> 8)) return -1;
    br.consume(e >> 8);
    return e & 0xff;
  }
};

// dcraw crw_init_tables constants: {counts[16], values...}; the values
// are run<<4|ssss symbols, 0x00 = EOB, 0xff = no-op.
static const uint8_t kCrwFirstTree[3][29] = {
    {0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0x04, 0x03, 0x05, 0x06, 0x02, 0x07, 0x01, 0x08, 0x09, 0x00, 0x0a, 0x0b,
     0xff},
    {0, 2, 2, 3, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0, 0,
     0x03, 0x02, 0x04, 0x01, 0x05, 0x00, 0x06, 0x07, 0x09, 0x08, 0x0a, 0x0b,
     0xff},
    {0, 0, 6, 3, 1, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0x06, 0x05, 0x07, 0x04, 0x08, 0x03, 0x09, 0x02, 0x00, 0x0a, 0x01, 0x0b,
     0xff},
};

static const uint8_t kCrwSecondTree[3][180] = {
    {0, 2, 2, 2, 1, 4, 2, 1, 2, 5, 1, 1, 0, 0, 0, 139,
     0x03, 0x04, 0x02, 0x05, 0x01, 0x06, 0x07, 0x08,
     0x12, 0x13, 0x11, 0x14, 0x09, 0x15, 0x22, 0x00, 0x21, 0x16, 0x0a, 0xf0,
     0x23, 0x17, 0x24, 0x31, 0x32, 0x18, 0x19, 0x33, 0x25, 0x41, 0x34, 0x42,
     0x35, 0x51, 0x36, 0x37, 0x38, 0x29, 0x79, 0x26, 0x1a, 0x39, 0x56, 0x57,
     0x28, 0x27, 0x52, 0x55, 0x58, 0x43, 0x76, 0x59, 0x77, 0x54, 0x61, 0xf9,
     0x71, 0x78, 0x75, 0x96, 0x97, 0x49, 0xb7, 0x53, 0xd7, 0x74, 0xb6, 0x98,
     0x47, 0x48, 0x95, 0x69, 0x99, 0x91, 0xfa, 0xb8, 0x68, 0xb5, 0xb9, 0xd6,
     0xf7, 0xd8, 0x67, 0x46, 0x45, 0x94, 0x89, 0xf8, 0x81, 0xd5, 0xf6, 0xb4,
     0x88, 0xb1, 0x2a, 0x44, 0x72, 0xd9, 0x87, 0x66, 0xd4, 0xf5, 0x3a, 0xa7,
     0x73, 0xa9, 0xa8, 0x86, 0x62, 0xc7, 0x65, 0xc8, 0xc9, 0xa1, 0xf4, 0xd1,
     0xe9, 0x5a, 0x92, 0x85, 0xa6, 0xe7, 0x93, 0xe8, 0xc1, 0xc6, 0x7a, 0x64,
     0xe1, 0x4a, 0x6a, 0xe6, 0xb3, 0xf1, 0xd3, 0xa5, 0x8a, 0xb2, 0x9a, 0xba,
     0x84, 0xa4, 0x63, 0xe5, 0xc5, 0xf3, 0xd2, 0xc4, 0x82, 0xaa, 0xda, 0xe4,
     0xf2, 0xca, 0x83, 0xa3, 0xa2, 0xc3, 0xea, 0xc2, 0xe2, 0xe3, 0xff, 0xff},
    {0, 2, 2, 1, 4, 1, 4, 1, 3, 3, 1, 0, 0, 0, 0, 140,
     0x02, 0x03, 0x01, 0x04, 0x05, 0x12, 0x11, 0x06,
     0x13, 0x07, 0x08, 0x14, 0x22, 0x09, 0x21, 0x00, 0x23, 0x15, 0x31, 0x32,
     0x0a, 0x16, 0xf0, 0x24, 0x33, 0x41, 0x42, 0x19, 0x17, 0x25, 0x18, 0x51,
     0x34, 0x43, 0x52, 0x29, 0x35, 0x61, 0x39, 0x71, 0x62, 0x36, 0x53, 0x26,
     0x38, 0x1a, 0x37, 0x81, 0x27, 0x91, 0x79, 0x55, 0x45, 0x28, 0x72, 0x59,
     0xa1, 0xb1, 0x44, 0x69, 0x54, 0x58, 0xd1, 0xfa, 0x57, 0xe1, 0xf1, 0xb9,
     0x49, 0x47, 0x63, 0x6a, 0xf9, 0x56, 0x46, 0xa8, 0x2a, 0x4a, 0x78, 0x99,
     0x3a, 0x75, 0x74, 0x86, 0x65, 0xc1, 0x76, 0xb6, 0x96, 0xd6, 0x89, 0x85,
     0xc9, 0xf5, 0x95, 0xb4, 0xc7, 0xf7, 0x8a, 0x97, 0xb8, 0x73, 0xb7, 0xd8,
     0xd9, 0x87, 0xa7, 0x7a, 0x48, 0x82, 0x84, 0xea, 0xf4, 0xa6, 0xc5, 0x5a,
     0x94, 0xa4, 0xc6, 0x92, 0xc3, 0x68, 0xb5, 0xc8, 0xe4, 0xe5, 0xe6, 0xe9,
     0xa2, 0xa3, 0xe3, 0xc2, 0x66, 0x67, 0x93, 0xaa, 0xd4, 0xd5, 0xe7, 0xf8,
     0x88, 0x9a, 0xd7, 0x77, 0xc4, 0x64, 0xe2, 0x98, 0xa5, 0xca, 0xda, 0xe8,
     0xf3, 0xf6, 0xa9, 0xb2, 0xb3, 0xf2, 0xd2, 0x83, 0xba, 0xd3, 0xff, 0xff},
    {0, 0, 6, 2, 1, 3, 3, 2, 5, 1, 2, 2, 8, 10, 0, 117,
     0x04, 0x05, 0x03, 0x06, 0x02, 0x07, 0x01, 0x08,
     0x09, 0x12, 0x13, 0x14, 0x11, 0x15, 0x0a, 0x16, 0x17, 0xf0, 0x00, 0x22,
     0x21, 0x18, 0x23, 0x19, 0x24, 0x32, 0x31, 0x25, 0x33, 0x38, 0x37, 0x34,
     0x35, 0x36, 0x39, 0x79, 0x57, 0x58, 0x59, 0x28, 0x56, 0x78, 0x27, 0x41,
     0x29, 0x77, 0x26, 0x42, 0x76, 0x99, 0x1a, 0x55, 0x98, 0x97, 0xf9, 0x48,
     0x54, 0x96, 0x89, 0x47, 0xb7, 0x49, 0xfa, 0x75, 0x68, 0xb6, 0x67, 0x69,
     0xb9, 0xb8, 0xd8, 0x52, 0xd7, 0x88, 0xb5, 0x74, 0x51, 0x46, 0xd9, 0xf8,
     0x3a, 0xd6, 0x87, 0x45, 0x7a, 0x95, 0xd5, 0xf6, 0x86, 0xb4, 0xa9, 0x94,
     0x53, 0x2a, 0xa8, 0x43, 0xf5, 0xf7, 0xd4, 0x66, 0xa7, 0x5a, 0x44, 0x8a,
     0xc9, 0xe8, 0xc8, 0xe7, 0x9a, 0x6a, 0x73, 0x4a, 0x61, 0xc7, 0xf4, 0xc6,
     0x65, 0xe9, 0x72, 0xe6, 0x71, 0x91, 0x93, 0xa6, 0xda, 0x92, 0x85, 0x62,
     0xf3, 0xc5, 0xb2, 0xa4, 0x84, 0xba, 0x64, 0xa5, 0xb3, 0xd2, 0x81, 0xe5,
     0xd3, 0xaa, 0xc4, 0xca, 0xf2, 0xb1, 0xe4, 0xd1, 0x83, 0x63, 0xea, 0xc3,
     0xe2, 0x82, 0xf1, 0xa3, 0xc2, 0xa1, 0xc1, 0xe3, 0xa2, 0xe1, 0xff, 0xff},
};

}  // namespace

// Decode the CRW compressed raw payload. `stream`: the Huffman bitstream
// (file offset 540 + lowbits*H*W/4 onward); `lowbits`: the 2-bit plane at
// file offset 26 (NULL when the file has no low-bits section); `table`:
// CIFF DecoderTable index (clamped to 0..2). Output is `height*width`
// uint16 sensor values (12-bit with lowbits, 10-bit without). Returns 0,
// or <0 on malformed input: -1 bad args, -2 invalid Huffman code, -3
// value overflow (wrong table / corrupt stream), -4 lowbits plane short.
int r2f_decode_crw(const uint8_t* stream, long stream_len,
                   const uint8_t* lowbits, long lowbits_len, int table,
                   int width, int height, uint16_t* out) {
  if (!stream || !out || width <= 0 || height <= 0 || width % 8 ||
      stream_len <= 0)
    return -1;
  if (lowbits && lowbits_len < long(width) * height / 4) return -4;
  if (table < 0) table = 0;
  if (table > 2) table = 2;

  CrwHuff first, second;
  first.build(kCrwFirstTree[table], kCrwFirstTree[table] + 16);
  second.build(kCrwSecondTree[table], kCrwSecondTree[table] + 16);

  BitReader br(stream, size_t(stream_len));
  int carry = 0;
  long pnum = 0;
  int base[2] = {0, 0};
  long overflows = 0;
  for (int row = 0; row < height; row += 8) {
    uint16_t* pixel = out + long(row) * width;
    long nblocks = long(std::min(8, height - row)) * width >> 6;
    for (long block = 0; block < nblocks; ++block) {
      int diffbuf[64] = {0};
      for (int i = 0; i < 64; ++i) {
        int leaf = (i ? second : first).decode(br);
        if (leaf < 0) return -2;
        if (leaf == 0 && i) break;
        if (leaf == 0xff) continue;
        i += leaf >> 4;
        int len = leaf & 15;
        if (len == 0) continue;
        int diff = int(br.peek(len));
        br.consume(len);
        if ((diff & (1 << (len - 1))) == 0) diff -= (1 << len) - 1;
        if (i < 64) diffbuf[i] = diff;
      }
      diffbuf[0] += carry;
      carry = diffbuf[0];
      for (int i = 0; i < 64; ++i) {
        if (pnum++ % width == 0) base[0] = base[1] = 512;
        int val = (base[i & 1] += diffbuf[i]);
        pixel[(block << 6) + i] = uint16_t(val);
        if (val >> 10) ++overflows;
      }
    }
  }
  // A handful of overflows can be sensor hot pixels in a genuine stream;
  // a wrong Huffman table overflows almost everywhere immediately.
  if (overflows > long(width) * height / 64) return -3;

  if (lowbits) {
    long n = long(width) * height;
    for (long j = 0; j < n; ++j) {
      int val = (out[j] << 2) | ((lowbits[j >> 2] >> ((j & 3) * 2)) & 3);
      // dcraw's canon_compressed_load_raw quirk for the 2672-wide sensor.
      if (width == 2672 && val < 512) val += 2;
      out[j] = uint16_t(val);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Canon CR3 (CRX codec) subband entropy decode.
//
// The reference ingests CR3 via LibRaw (reference:
// src/raw2film/raw_conversion.py:36-48; src/raw2film/data.py:92). The CRX
// architecture (subplane decomposition, optional LeGall 5/3 wavelet,
// adaptive Golomb-Rice with a zero-run mode) follows the public
// reverse-engineering; the exact bit-level constants here are r2f's
// reconstruction — see raw2film_tpu/io/crx.py for the normative rules this
// decoder shares with the synthetic test encoder, and the guards that turn
// any mismatch with a real camera stream into a clean abort:
//   * unary prefixes are capped at 41 (the escape length) — longer is -2;
//   * reading more than 8 bytes past the record is -2;
//   * DPCM samples outside [0, 2^nBits) are -2;
//   * the caller cross-checks consumed bytes against the record size.
// Returns consumed bytes (>= 0) or a negative error.

namespace {

struct CrxIn {
  const uint8_t* base;
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  long pad = 0;  // zero bytes synthesized past the record end

  CrxIn(const uint8_t* d, size_t len) : base(d), p(d), end(d + len) {}

  inline void fill() {
    if (n > 56) return;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (n <= 55 && end - p >= 8) {
      // Bulk path (see fuji::BitIn::fill): one unaligned load per refill
      // while at least 8 in-record bytes remain; past-end zero padding
      // stays on the byte loop so `pad` accounting is exact. (n <= 55
      // keeps bytes >= 1 below — at n == 56 the mask shift would be 64.)
      uint64_t chunk;
      std::memcpy(&chunk, p, 8);
      chunk = __builtin_bswap64(chunk);
      int bytes = (63 - n) >> 3;
      acc |= (chunk & (~0ULL << (64 - 8 * bytes))) >> n;
      p += bytes;
      n += 8 * bytes;
      if (n > 56) return;
    }
#endif
    while (n <= 56) {
      uint8_t b = 0;
      if (p < end) {
        b = *p++;
      } else {
        ++pad;
        ++p;  // keep the consumed-bytes accounting uniform
      }
      acc |= uint64_t(b) << (56 - n);
      n += 8;
    }
  }

  inline uint32_t get(int k) {
    if (!k) return 0;
    fill();
    uint32_t v = uint32_t(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }

  // Count of 0 bits before (and consuming) the terminating 1. Returns
  // cap+1 as the corrupt-stream signal if no 1 arrives in time.
  inline int unary(int cap) {
    int q = 0;
    for (;;) {
      fill();
      if (acc == 0) {
        q += n;
        n = 0;
        if (q > cap) return cap + 1;
        continue;
      }
      int lead = __builtin_clzll(acc);
      if (lead >= n) {
        q += n;
        acc = 0;
        n = 0;
        if (q > cap) return cap + 1;
        continue;
      }
      q += lead;
      acc <<= lead + 1;
      n -= lead + 1;
      return q <= cap ? q : cap + 1;
    }
  }

  inline long consumed_bytes() const {
    long bits = long(p - base) * 8 - n;
    return (bits + 7) / 8;
  }
};

static inline int crx_adapt(int k, uint32_t u) {
  k += int((u >> k) > 2) + int((u >> k) > 5) - int((2ull * u) < (1ull << k));
  if (k < 0) k = 0;
  if (k > 21) k = 21;
  return k;
}

// Rice(u; k) with the 41-zeros escape to a 21-bit raw value; adapts k.
static inline long crx_rice(CrxIn& in, int* k, bool* ok) {
  int q = in.unary(41);
  if (q > 41) {
    *ok = false;
    return 0;
  }
  uint32_t u;
  if (q == 41) {
    u = in.get(21);
  } else {
    u = (uint32_t(q) << *k) | in.get(*k);
  }
  *k = crx_adapt(*k, u);
  return long(u);
}

}  // namespace

// DPCM band (LL / level-0 plane): values in [0, 2^nbits), line 0 left-
// predicted, later lines top-predicted, zigzag residuals, k0 = 4.
// HF band (dpcm == 0): signed coefficients, zigzag, zero-run mode, k0 = 1,
// s0 = 1.
int r2f_decode_crx_band(const uint8_t* data, long len, int width, int height,
                        int nbits, int dpcm, int32_t* out) {
  // nbits up to 20: wavelet LL bands carry 4 bits of headroom + a bias
  // over the sensor depth (io/crx.py).
  if (width <= 0 || height <= 0 || nbits < 8 || nbits > 20 || len < 0)
    return -1;
  CrxIn in(data, size_t(len));
  bool ok = true;
  if (dpcm) {
    int k = 4;
    const long maxv = (1L << nbits) - 1;
    for (int y = 0; y < height; ++y) {
      int32_t* row = out + long(y) * width;
      const int32_t* top = row - width;
      for (int x = 0; x < width; ++x) {
        long pred = y ? top[x] : (x ? row[x - 1] : (1L << (nbits - 1)));
        long u = crx_rice(in, &k, &ok);
        long e = (u >> 1) ^ -(u & 1);
        long v = pred + e;
        if (!ok || v < 0 || v > maxv) return -2;
        row[x] = int32_t(v);
      }
      if (in.pad > 8) return -2;
    }
  } else {
    int k = 1, s = 1;
    bool prev_zero = true;  // band start counts as a zero context
    for (int y = 0; y < height; ++y) {
      int32_t* row = out + long(y) * width;
      int x = 0;
      while (x < width) {
        if (prev_zero) {
          long r = crx_rice(in, &s, &ok);
          if (!ok || r > width - x) return -2;
          for (long i = 0; i < r; ++i) row[x++] = 0;
          if (x < width) {
            long u = crx_rice(in, &k, &ok) + 1;
            if (!ok) return -2;
            long c = (u >> 1) ^ -(u & 1);
            row[x++] = int32_t(c);
            prev_zero = false;
          } else {
            prev_zero = true;  // the run reached the line end
          }
        } else {
          long u = crx_rice(in, &k, &ok);
          if (!ok) return -2;
          long c = (u >> 1) ^ -(u & 1);
          row[x++] = int32_t(c);
          prev_zero = (c == 0);
        }
      }
      if (in.pad > 8) return -2;
    }
  }
  if (in.pad > 8) return -2;
  long used = in.consumed_bytes();
  return used > len ? len : used;
}

int r2f_abi_version() { return 12; }

}  // extern "C"
