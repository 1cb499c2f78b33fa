// JPEG decoder of the port's host engine: the bytes PIL's Image.open gives
// for a JPEG file, without a library. PIL decodes with libjpeg-turbo at
// libjpeg's defaults; this file follows libjpeg's rules where they decide
// bytes:
//
// - entropy decoding: baseline / extended sequential Huffman (jdhuff.c) and
//   progressive Huffman (jdphuff.c: DC first / refine, AC first / refine,
//   EOB runs, spectral selection), restart intervals (DRI / RSTn);
// - dequantisation and the accurate integer IDCT (jidctint.c
//   jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2), its output through the
//   range-limit table (jdmaster.c prepare_range_limit_table, indexed
//   & RANGE_MASK);
// - fancy upsampling of chroma (jdsample.c h2v1 / h1v2 / h2v2, plain
//   replication where a component is 2 samples wide or less), the component's first and last real rows repeated
//   as context above and below (jdmainct.c);
// - YCbCr -> RGB by jdcolor.c's tables (SCALEBITS 16), the colour space
//   chosen as jdapimin.c default_decompress_parms chooses it (JFIF marker,
//   Adobe transform, component ids).
//
// No block smoothing: a progressive file is decoded after its last scan,
// and one whose scans leave one of coefficients 0-9 of a component unsent
// or unrefined (where libjpeg would smooth) raises "not ported", as do 4
// components, arithmetic coding, 12-bit, lossless and hierarchical files,
// DNL and sampling ratios other than 1x1, 2x1, 1x2 and 2x2. A truncated or corrupt file raises;
// no partial image is returned. Integer arithmetic only.
//
// Built with the engine's other sources into one library (data/native.py);
// C ABI.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index, with libjpeg's 16 extra
// entries so that a corrupt run past 63 lands on 63
constexpr int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Status { kOk = 0, kUnported = 1, kBroken = 2 };

struct Failure {
  int status;
  std::string what;
};

[[noreturn]] void unported(const std::string& what) { throw Failure{kUnported, what}; }
[[noreturn]] void broken(const std::string& what) { throw Failure{kBroken, what}; }

constexpr int kFastBits = 9;

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];    // largest code of each length, -1 where none
  int32_t valoffset[18];  // index into vals of a code of that length, minus the code
  uint8_t vals[256];
  uint16_t fast[1 << kFastBits];  // (length << 8) | value for codes of <= kFastBits bits
};

// jpeg_make_d_derived_tbl's checks: at most 256 codes, no code of all ones
// (made before a length's codes are written, so none lands past the
// table), DC symbols at most 15
void build_huffman(Huffman& t, const uint8_t* bits, const uint8_t* vals, int count, bool dc) {
  if (count > 256) broken("bad Huffman table (more than 256 codes)");
  if (dc)
    for (int i = 0; i < count; ++i)
      if (vals[i] > 15) broken("bad Huffman table (a DC symbol above 15)");
  t = Huffman();
  t.defined = true;
  std::memcpy(t.vals, vals, count);
  int32_t code = 0;
  int p = 0;
  for (int len = 1; len <= 16; ++len) {
    const int n = bits[len - 1];
    if (code + n >= (1 << len)) broken("bad Huffman table (code overflow)");
    t.valoffset[len] = p - code;
    for (int i = 0; i < n; ++i, ++p, ++code) {
      if (len <= kFastBits) {
        const int shift = kFastBits - len;
        for (int f = 0; f < (1 << shift); ++f)
          t.fast[(code << shift) | f] = static_cast<uint16_t>((len << 8) | vals[p]);
      }
    }
    t.maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = INT32_MAX;
}

// Bits of one entropy-coded segment, stuffed bytes removed. At a marker (or
// the file's end) it feeds zero bits, as libjpeg does; consuming one of
// them means the segment ended early, which raises.
struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos;           // next byte to load
  uint64_t buf = 0;     // bits, left aligned
  int bits = 0;         // bits in buf
  int pad = 0;          // of which zero bits fed past the segment's end
  int marker = 0;       // the marker that ended the segment, -1 at end of file
  size_t after = 0;     // position after that marker's code byte

  BitReader(const uint8_t* d, size_t len, size_t start) : data(d), n(len), pos(start) {}

  void fill() {
    while (bits <= 56) {
      int c;
      if (marker != 0) {
        c = 0;
        pad += 8;
      } else if (pos >= n) {
        marker = -1;
        continue;
      } else if (data[pos] != 0xFF) {
        c = data[pos++];
      } else {
        size_t q = pos + 1;
        while (q < n && data[q] == 0xFF) ++q;  // fill bytes before a marker
        if (q >= n) {
          marker = -1;
          continue;
        }
        if (data[q] == 0) {
          c = 0xFF;
          pos = q + 1;
        } else {
          marker = data[q];
          after = q + 1;
          continue;
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }
  void ensure(int k) {
    if (bits < k) fill();
  }
  uint32_t peek(int k) const { return static_cast<uint32_t>(buf >> (64 - k)); }
  void skip(int k) {
    buf <<= k;
    bits -= k;
    if (bits < pad) broken(marker == -1 ? "truncated JPEG file" : "premature end of JPEG data");
  }
  int get(int k) {  // k in 1..16
    ensure(k);
    const int v = static_cast<int>(peek(k));
    skip(k);
    return v;
  }
  int decode(const Huffman& t) {
    ensure(16);
    const uint16_t e = t.fast[peek(kFastBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    const int32_t c16 = static_cast<int32_t>(peek(16));
    for (int len = kFastBits + 1; len <= 16; ++len) {
      const int32_t code = c16 >> (16 - len);
      if (code <= t.maxcode[len]) {
        skip(len);
        return t.vals[t.valoffset[len] + code];
      }
    }
    broken("corrupt JPEG data: bad Huffman code");
  }
  // Drop the bits left and find the next marker (skipping any garbage);
  // returns its code and leaves pos after it.
  int next_marker() {
    if (marker == 0) {
      for (;;) {
        while (pos < n && data[pos] != 0xFF) ++pos;
        size_t q = pos + 1;
        while (q < n && data[q] == 0xFF) ++q;
        if (q >= n) {
          marker = -1;
          break;
        }
        if (data[q] == 0) {
          pos = q + 1;
          continue;
        }
        marker = data[q];
        after = q + 1;
        break;
      }
    }
    if (marker == -1) broken("truncated JPEG file");
    const int m = marker;
    pos = after;
    buf = 0;
    bits = pad = 0;
    marker = 0;
    return m;
  }
};

// HUFF_EXTEND: an s-bit magnitude category's bits -> the signed value
inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // width / height in blocks (libjpeg's width_in_blocks)
  int bw_pad = 0, bh_pad = 0;  // rounded up to whole MCUs
  int dw = 0, dh = 0;          // downsampled width / height
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
  bool quant_latched = false;
  uint16_t quant[64];          // natural order
  int coef_bits[64];           // progressive: Al of the last scan, -1 before any
  bool scanned = false;
  std::vector<int16_t> coef;   // bh_pad * bw_pad blocks of 64, natural order
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * bw_pad + bx) * 64;
  }
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, frame = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int restart_interval = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  Component comp[4];
  bool qdefined[4] = {false, false, false, false};
  uint16_t qtable[4][64];
  Huffman dc_tbl[4], ac_tbl[4];

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int byte() {
    if (pos >= n) broken("truncated JPEG file");
    return data[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  // The next marker's code, skipping garbage and fill bytes (next_marker).
  int read_marker() {
    for (;;) {
      int c = byte();
      if (c != 0xFF) continue;
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  // A segment's body: [pos, end), checked to lie in the file.
  size_t segment() {
    const int len = word();
    if (len < 2) broken("bad JPEG marker length");
    const size_t end = pos + len - 2;
    if (end > n) broken("truncated JPEG file");
    return end;
  }

  void read_sof(int marker) {
    if (frame) broken("two frame headers in one JPEG file");
    switch (marker) {
      case 0xC0: case 0xC1: break;
      case 0xC2: progressive = true; break;
      case 0xC3: unported("lossless JPEG is not ported");
      case 0xC5: case 0xC6: case 0xC7: unported("hierarchical JPEG is not ported");
      case 0xC8: unported("JPEG extensions (SOF marker 0xC8) are not ported");
      default: unported("arithmetic-coded JPEG is not ported");
    }
    const size_t end = segment();
    const int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision != 8) unported(std::to_string(precision) + "-bit JPEG is not ported");
    if (height == 0) unported("JPEG with a DNL-defined height is not ported");
    if (width == 0 || ncomp == 0) broken("empty JPEG image");
    if (ncomp == 4) unported("4-component (CMYK / YCCK) JPEG is not ported");
    if (ncomp != 1 && ncomp != 3)
      unported(std::to_string(ncomp) + "-component JPEG is not ported");
    if (end - pos != static_cast<size_t>(ncomp) * 3) broken("bad JPEG frame header length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) broken("bad JPEG sampling factors");
      if (c.tq > 3) broken("bad JPEG quantisation table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v || hmax / c.h > 2 || vmax / c.v > 2)
        unported("JPEG sampling ratio " + std::to_string(hmax) + "/" + std::to_string(c.h) +
                 " x " + std::to_string(vmax) + "/" + std::to_string(c.v) +
                 " (other than 1x1, 2x1, 1x2, 2x2) is not ported");
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.bw = static_cast<int>((static_cast<int64_t>(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.bh = static_cast<int>((static_cast<int64_t>(height) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.bw_pad = mcus_x * c.h;
      c.bh_pad = mcus_y * c.v;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    frame = true;
    pos = end;
  }

  void read_dqt() {
    const size_t end = segment();
    while (pos < end) {
      const int pq = byte();
      const int tq = pq & 15;
      if (tq > 3) broken("bad JPEG quantisation table index");
      for (int k = 0; k < 64; ++k)
        qtable[tq][kNatural[k]] = static_cast<uint16_t>((pq >> 4) ? word() : byte());
      qdefined[tq] = true;
    }
    if (pos != end) broken("bad JPEG DQT length");
  }

  void read_dht() {
    const size_t end = segment();
    while (pos < end) {
      const int tc = byte();
      const int th = tc & 15;
      if ((tc >> 4) > 1 || th > 3) broken("bad JPEG Huffman table class or index");
      uint8_t bits[16];
      int count = 0;
      for (int i = 0; i < 16; ++i) {
        bits[i] = static_cast<uint8_t>(byte());
        count += bits[i];
      }
      if (count > 256 || pos + count > end) broken("bad JPEG Huffman table");
      build_huffman((tc >> 4) ? ac_tbl[th] : dc_tbl[th], bits, data + pos, count,
                    (tc >> 4) == 0);
      pos += count;
    }
    if (pos != end) broken("bad JPEG DHT length");
  }

  void read_app(int marker) {
    const size_t end = segment();
    const size_t len = end - pos;
    const uint8_t* p = data + pos;
    if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  // One scan: its header, then its entropy-coded data up to the marker that
  // follows it; returns that marker.
  int read_scan() {
    if (!frame) broken("JPEG scan before the frame header");
    const size_t end = segment();
    const int ns = byte();
    if (ns < 1 || ns > 4 || end - pos != static_cast<size_t>(ns) * 2 + 3)
      broken("bad JPEG scan header");
    Component* sc[4];
    int prev = -1;
    for (int i = 0; i < ns; ++i) {
      const int id = byte();
      const int t = byte();
      int ci = -1;
      for (int k = 0; k < ncomp; ++k)
        if (comp[k].id == id) ci = k;
      if (ci < 0 || ci <= prev) broken("bad JPEG scan component");
      prev = ci;
      sc[i] = &comp[ci];
      sc[i]->dc_tbl = t >> 4;
      sc[i]->ac_tbl = t & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) broken("bad JPEG Huffman table index");
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    pos = end;

    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += ns > 1 ? sc[i]->h * sc[i]->v : 1;
    if (blocks > 10) broken("bad JPEG MCU size");
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.quant_latched) {  // latch_quant_tables: the table as it stands at the first scan
        if (!qdefined[c.tq]) broken("JPEG quantisation table not defined");
        std::memcpy(c.quant, qtable[c.tq], sizeof c.quant);
        c.quant_latched = true;
      }
      if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.bw_pad) * c.bh_pad * 64, 0);
      c.scanned = true;
      c.last_dc = 0;
    }

    enum { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind = kSeq;
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) broken("bad JPEG progression parameters");
      for (int i = 0; i < ns; ++i) {
        int* cb = sc[i]->coef_bits;
        if (ss != 0 && cb[0] < 0) broken("bad JPEG progression (AC before DC)");
        for (int k = ss; k <= se; ++k) {
          if (ah != (cb[k] < 0 ? 0 : cb[k])) broken("bad JPEG progression");
          cb[k] = al;
        }
      }
      kind = ss == 0 ? (ah == 0 ? kDcFirst : kDcRefine) : (ah == 0 ? kAcFirst : kAcRefine);
    }
    for (int i = 0; i < ns; ++i) {
      const bool need_dc = kind == kSeq || kind == kDcFirst;
      const bool need_ac = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
      if ((need_dc && !dc_tbl[sc[i]->dc_tbl].defined) ||
          (need_ac && !ac_tbl[sc[i]->ac_tbl].defined))
        unported("a JPEG scan without its Huffman tables (Motion-JPEG) is not ported");
    }

    // the MCU grid: interleaved scans walk MCUs of h x v blocks a
    // component, a one-component scan walks that component's real blocks
    const int units_x = ns > 1 ? mcus_x : sc[0]->bw;
    const int units_y = ns > 1 ? mcus_y : sc[0]->bh;
    BitReader br(data, n, pos);
    int eobrun = 0;
    int next_rst = 0;
    const int64_t total = static_cast<int64_t>(units_x) * units_y;
    for (int64_t u = 0; u < total; ++u) {
      if (restart_interval && u > 0 && u % restart_interval == 0) {
        const int m = br.next_marker();
        if (m != 0xD0 + next_rst) broken("corrupt JPEG data: missing restart marker");
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
        eobrun = 0;
      }
      const int uy = static_cast<int>(u / units_x), ux = static_cast<int>(u % units_x);
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        const int ny = ns > 1 ? c.v : 1, nx = ns > 1 ? c.h : 1;
        for (int y = 0; y < ny; ++y) {
          for (int x = 0; x < nx; ++x) {
            int16_t* blk = ns > 1 ? c.block(uy * c.v + y, ux * c.h + x) : c.block(uy, ux);
            switch (kind) {
              case kSeq: decode_sequential(br, c, blk); break;
              case kDcFirst: {
                int s = br.decode(dc_tbl[c.dc_tbl]);
                if (s) s = extend(br.get(s), s);
                c.last_dc += s;
                blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.last_dc) << al);
                break;
              }
              case kDcRefine:
                if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
                break;
              case kAcFirst: decode_ac_first(br, c, blk, ss, se, al, eobrun); break;
              case kAcRefine: decode_ac_refine(br, c, blk, ss, se, al, eobrun); break;
            }
          }
        }
      }
    }
    const int m = br.next_marker();
    pos = br.pos;
    return m;
  }

  void decode_sequential(BitReader& br, Component& c, int16_t* blk) {
    int s = br.decode(dc_tbl[c.dc_tbl]);
    if (s) s = extend(br.get(s), s);
    c.last_dc += s;
    blk[0] = static_cast<int16_t>(c.last_dc);
    const Huffman& ac = ac_tbl[c.ac_tbl];
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al,
                       int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& ac = ac_tbl[c.ac_tbl];
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(ac);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        const int v = extend(br.get(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al,
                        int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Huffman& ac = ac_tbl[c.ac_tbl];
    auto correct = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(ac);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          if (s != 1) broken("corrupt JPEG data: bad refinement code");
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void parse() {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) broken("not a JPEG file (no SOI)");
    pos = 2;
    int m = read_marker();
    for (;;) {
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
        read_sof(m);
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        unported("arithmetic-coded JPEG is not ported");
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        const size_t end = segment();
        if (end - pos != 2) broken("bad JPEG DRI length");
        restart_interval = word();
      } else if (m == 0xDA) {
        m = read_scan();
        continue;
      } else if (m == 0xD9) {
        break;
      } else if (m == 0xDC) {
        unported("JPEG with a DNL marker is not ported");
      } else if (m == 0xDE || m == 0xDF) {
        unported("hierarchical JPEG is not ported");
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xFE) {
        pos = segment();
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn and TEM outside a scan carry nothing (jdmarker.c read_markers)
      } else if (m == 0xD8) {
        broken("a second SOI in a JPEG file");
      } else if (m >= 0xF0 && m <= 0xFD) {
        unported("JPEG extension markers (JPGn, e.g. JPEG-LS) are not ported");
      } else {
        broken("corrupt JPEG data: unexpected marker");
      }
      m = read_marker();
    }
    if (!frame) broken("JPEG file without a frame");
    for (int i = 0; i < ncomp; ++i)
      if (!comp[i].scanned) broken("a JPEG component that no scan carries");
    if (progressive) {
      // smoothing_ok: libjpeg smooths blocks where coefficients 1-9 are
      // not fully refined, unless a component lacks its DC
      bool useful = false;
      for (int i = 0; i < ncomp; ++i) {
        if (comp[i].coef_bits[0] < 0) {
          useful = false;
          break;
        }
        for (int k = 1; k <= 9; ++k)
          if (comp[i].coef_bits[k] != 0) useful = true;
      }
      if (useful)
        unported("progressive JPEG that ends with coefficients 1-9 unrefined "
                 "(libjpeg's block smoothing) is not ported");
    }
  }
};

// ------------------------------------------------------------------ IDCT

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t kFix_0_298631336 = 2446;
constexpr int32_t kFix_0_390180644 = 3196;
constexpr int32_t kFix_0_541196100 = 4433;
constexpr int32_t kFix_0_765366865 = 6270;
constexpr int32_t kFix_0_899976223 = 7373;
constexpr int32_t kFix_1_175875602 = 9633;
constexpr int32_t kFix_1_501321110 = 12299;
constexpr int32_t kFix_1_847759065 = 15137;
constexpr int32_t kFix_1_961570560 = 16069;
constexpr int32_t kFix_2_053119869 = 16819;
constexpr int32_t kFix_2_562915447 = 20995;
constexpr int32_t kFix_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit, indexed by (x & 1023) for a value x
// centred on 0: x + 128 clamped to [0, 255] for -512 <= x < 512, wrapping
// beyond.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = i < 128 ? static_cast<uint8_t>(i + 128) : i < 512 ? 255 : i < 896 ? 0
                                                        : static_cast<uint8_t>(i - 896);
  }
};
const RangeLimit kIdctLimit;

// jpeg_idct_islow of one block into 8 rows of `out` (stride `stride`).
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
  int64_t ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int64_t* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      const int64_t dc = static_cast<int64_t>(ip[0]) * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * kFix_0_541196100;
    int64_t tmp2 = z1 + z3 * -kFix_1_847759065;
    int64_t tmp3 = z1 + z2 * kFix_0_765366865;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * kFix_1_175875602;
    tmp0 *= kFix_0_298631336;
    tmp1 *= kFix_2_053119869;
    tmp2 *= kFix_3_072711026;
    tmp3 *= kFix_1_501321110;
    z1 *= -kFix_0_899976223;
    z2 *= -kFix_2_562915447;
    z3 *= -kFix_1_961570560;
    z4 *= -kFix_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int32_t>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int32_t>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int32_t>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int32_t>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int32_t>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int32_t>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int32_t>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int32_t>(descale(tmp13 - tmp0, sh));
  }
  const uint8_t* lim = kIdctLimit.t;
  constexpr int sh2 = kConstBits + kPass1Bits + 3;
  for (int row = 0; row < 8; ++row) {
    const int64_t* wp = ws + row * 8;
    uint8_t* op = out + row * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      const uint8_t dc = lim[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * kFix_0_541196100;
    int64_t tmp2 = z1 + z3 * -kFix_1_847759065;
    int64_t tmp3 = z1 + z2 * kFix_0_765366865;
    int64_t tmp0 = (wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (wp[0] - wp[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * kFix_1_175875602;
    tmp0 *= kFix_0_298631336;
    tmp1 *= kFix_2_053119869;
    tmp2 *= kFix_3_072711026;
    tmp3 *= kFix_1_501321110;
    z1 *= -kFix_0_899976223;
    z2 *= -kFix_2_562915447;
    z3 *= -kFix_1_961570560;
    z4 *= -kFix_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = lim[static_cast<int>(descale(tmp10 + tmp3, sh2)) & 1023];
    op[7] = lim[static_cast<int>(descale(tmp10 - tmp3, sh2)) & 1023];
    op[1] = lim[static_cast<int>(descale(tmp11 + tmp2, sh2)) & 1023];
    op[6] = lim[static_cast<int>(descale(tmp11 - tmp2, sh2)) & 1023];
    op[2] = lim[static_cast<int>(descale(tmp12 + tmp1, sh2)) & 1023];
    op[5] = lim[static_cast<int>(descale(tmp12 - tmp1, sh2)) & 1023];
    op[3] = lim[static_cast<int>(descale(tmp13 + tmp0, sh2)) & 1023];
    op[4] = lim[static_cast<int>(descale(tmp13 - tmp0, sh2)) & 1023];
  }
}

// ------------------------------------------------------- upsampling, colour

// Component `c`'s samples (stride c.bw * 8) brought to the image's size
// (width x height) into `out` (stride width), by jdsample.c's method for
// its ratio.
void upsample(const Component& c, const uint8_t* in, int hmax, int vmax, int width, int height,
              uint8_t* out) {
  const size_t stride = static_cast<size_t>(c.bw) * 8;
  const int he = hmax / c.h, ve = vmax / c.v;
  const int dw = c.dw, last = c.dh - 1;
  std::vector<int> sums(dw);
  std::vector<uint8_t> wide(static_cast<size_t>(dw) * 2);
  auto row = [&](int r) { return in + static_cast<size_t>(r < 0 ? 0 : r > last ? last : r) * stride; };
  for (int y = 0; y < height; ++y) {
    uint8_t* op = out + static_cast<size_t>(y) * width;
    if (he == 1 && ve == 1) {
      std::memcpy(op, row(y), width);
    } else if (he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* ip = row(y);
      uint8_t* w = wide.data();
      w[0] = ip[0];
      w[1] = static_cast<uint8_t>((ip[0] * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        w[2 * x] = static_cast<uint8_t>((ip[x] * 3 + ip[x - 1] + 1) >> 2);
        w[2 * x + 1] = static_cast<uint8_t>((ip[x] * 3 + ip[x + 1] + 2) >> 2);
      }
      w[2 * dw - 2] = static_cast<uint8_t>((ip[dw - 1] * 3 + ip[dw - 2] + 1) >> 2);
      w[2 * dw - 1] = ip[dw - 1];
      std::memcpy(op, w, width);
    } else if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
      const int r = y / 2;
      const uint8_t* near = row(r);
      const uint8_t* far = row(y % 2 ? r + 1 : r - 1);
      const int bias = y % 2 ? 2 : 1;
      for (int x = 0; x < width; ++x)
        op[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
    } else if (he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy_upsample
      const int r = y / 2;
      const uint8_t* near = row(r);
      const uint8_t* far = row(y % 2 ? r + 1 : r - 1);
      for (int x = 0; x < dw; ++x) sums[x] = near[x] * 3 + far[x];
      uint8_t* w = wide.data();
      w[0] = static_cast<uint8_t>((sums[0] * 4 + 8) >> 4);
      w[1] = static_cast<uint8_t>((sums[0] * 3 + sums[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        w[2 * x] = static_cast<uint8_t>((sums[x] * 3 + sums[x - 1] + 8) >> 4);
        w[2 * x + 1] = static_cast<uint8_t>((sums[x] * 3 + sums[x + 1] + 7) >> 4);
      }
      w[2 * dw - 2] = static_cast<uint8_t>((sums[dw - 1] * 3 + sums[dw - 2] + 8) >> 4);
      w[2 * dw - 1] = static_cast<uint8_t>((sums[dw - 1] * 4 + 7) >> 4);
      std::memcpy(op, w, width);
    } else {  // h2v1_upsample, h2v2_upsample (2 samples wide or less): replication
      const uint8_t* ip = row(y / ve);
      for (int x = 0; x < width; ++x) op[x] = ip[x / he];
    }
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = int32_t{1} << (kScale - 1);
    auto fix = [](double v) { return static_cast<int32_t>(v * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kScale;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kScale;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

void decode(Decoder& d, uint8_t* out) {
  d.parse();
  const int w = d.width, h = d.height, nc = d.ncomp;
  const size_t plane = static_cast<size_t>(w) * h;
  std::vector<uint8_t> full(plane * nc);
  for (int i = 0; i < nc; ++i) {
    Component& c = d.comp[i];
    const size_t stride = static_cast<size_t>(c.bw) * 8;
    std::vector<uint8_t> samples(stride * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.block(by, bx), c.quant, samples.data() + by * 8 * stride + bx * 8, stride);
    c.coef.clear();
    c.coef.shrink_to_fit();
    upsample(c, samples.data(), d.hmax, d.vmax, w, h, full.data() + plane * i);
  }
  if (nc == 1) {
    std::memcpy(out, full.data(), plane);
    return;
  }
  // default_decompress_parms: JFIF means YCbCr, else Adobe's transform,
  // else component ids 'R', 'G', 'B' mean RGB; YCbCr otherwise
  bool rgb = false;
  if (!d.saw_jfif) {
    if (d.saw_adobe)
      rgb = d.adobe_transform == 0;
    else
      rgb = d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66;
  }
  const uint8_t* p0 = full.data();
  const uint8_t* p1 = p0 + plane;
  const uint8_t* p2 = p1 + plane;
  for (size_t i = 0; i < plane; ++i) {
    uint8_t* o = out + i * 3;
    if (rgb) {
      o[0] = p0[i];
      o[1] = p1[i];
      o[2] = p2[i];
      continue;
    }
    const int y = p0[i], cb = p1[i], cr = p2[i];
    o[0] = clamp255(y + kYcc.cr_r[cr]);
    o[1] = clamp255(y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
    o[2] = clamp255(y + kYcc.cb_b[cb]);
  }
}

int fail(const Failure& f, char* err, int errlen) {
  if (errlen > 0) {
    std::strncpy(err, f.what.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
  return f.status;
}

}  // namespace

extern "C" {

// The frame's height, width and component count (1 or 3), from the markers
// before the first scan. Returns 0, or 1 (not ported) / 2 (broken) with a
// message in `err`.
int sft_jpeg_header(const uint8_t* data, size_t n, int* height, int* width, int* comps,
                    char* err, int errlen) {
  try {
    Decoder d(data, n);
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) broken("not a JPEG file (no SOI)");
    d.pos = 2;
    for (;;) {
      const int m = d.read_marker();
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
        d.read_sof(m);
        break;
      }
      if (m == 0xCC) unported("arithmetic-coded JPEG is not ported");
      if (m == 0xDA || m == 0xD9 || m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01)
        broken("JPEG file without a frame header before its data");
      d.pos = d.segment();
    }
    *height = d.height;
    *width = d.width;
    *comps = d.ncomp;
    return kOk;
  } catch (const Failure& f) {
    return fail(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kBroken, "out of memory decoding a JPEG file"}, err, errlen);
  }
}

// The decoded samples into `out`: height x width x comps uint8, the sizes
// sft_jpeg_header gave. Same return values.
int sft_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen) {
  try {
    Decoder d(data, n);
    decode(d, out);
    return kOk;
  } catch (const Failure& f) {
    return fail(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return fail(Failure{kBroken, "out of memory decoding a JPEG file"}, err, errlen);
  }
}

}  // extern "C"
