// JBIG2 (ITU-T T.88) decoder for the built-in PDF rasterizer — the
// embedded-stream organization used by the PDF JBIG2Decode filter.
//
// The reference renders JBIG2-compressed scans via pdfium's C++ decoder
// (through pypdfium2); this is a from-scratch equivalent, the port's copy of
// yomitoku_tpu/native/jbig2.cpp, exposed to Python via ctypes (see
// native/__init__.py:jbig2_decode).
//
// Supports the segment types that appear in real scanned PDFs:
//   * generic regions (arithmetic templates 0-3 with AT pixels and TPGDON,
//     and MMR via the shared T.6 decoder in ccitt.cpp)
//   * symbol dictionaries + text regions (arithmetic coding, the jbig2enc
//     output class that dominates PDF JBIG2 in the wild), including
//     refinement/aggregation with generic refinement templates 0-1
//   * Huffman-coded symbol dictionaries + text regions (T.88 Annex B
//     standard tables B.1-B.15, type-53 custom tables, runcode symbol-ID
//     codes, uncompressed and MMR collective bitmaps) — the old
//     hardware-scanner output class
//   * pattern dictionaries + halftone regions (gray-coded bitplanes with
//     optional skip, arithmetic or MMR, skewed grid placement)
//   * page info / end-of-stripe assembly with all composition operators
//   * PDF /JBIG2Globals streams (shared symbol dictionaries)
//
// Fails loudly (negative return + jbig2_last_error) rather than guessing on
// the rare paths: Huffman-mode refinement/aggregation (no known encoder
// emits it), intermediate regions, and unknown-length segments.  The Python
// caller leaves the region blank and warns, matching the pre-existing
// behavior for undecodable streams.
//
// Output is one byte per pixel, 1 = black, like ccitt_decode.

#include "ccitt.cpp"  // extern "C" ccitt_decode (T.6 MMR shares the G4 code)

#include <cstdarg>
#include <cstdio>
#include <string>

namespace jbig2 {

// Error reporting is per-call: thread_local so concurrent decodes (pages
// rendered from a ThreadPoolExecutor) never race on the string or hand a
// dangling c_str() to another thread.
static thread_local std::string g_error;

struct Error {
  std::string msg;
};

static void fail(const char *fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error{buf};
}

// ---------------------------------------------------------------------------
// MQ arithmetic decoder (T.88 Annex E, software conventions).

struct QeEntry {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

static const QeEntry QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// A context is one byte: (index << 1) | MPS.
struct MQDecoder {
  const uint8_t *d = nullptr;
  long n = 0, bp = 0;
  uint32_t c = 0, a = 0;
  int ct = 0;

  inline uint8_t byte(long i) const { return i < n ? d[i] : 0xFF; }

  void init(const uint8_t *data, long len) {
    d = data;
    n = len;
    bp = 0;
    c = (uint32_t)byte(0) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  void bytein() {
    if (byte(bp) == 0xFF) {
      if (byte(bp + 1) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += (uint32_t)byte(bp) << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (uint32_t)byte(bp) << 8;
      ct = 8;
    }
  }

  int decode(uint8_t *cx) {
    int i = *cx >> 1, mps = *cx & 1;
    uint32_t qe = QE[i].qe;
    int bit;
    a -= qe;
    if (((c >> 16) & 0xFFFF) < qe) {
      // LPS path (with conditional exchange)
      if (a < qe) {
        bit = mps;
        i = QE[i].nmps;
      } else {
        bit = 1 - mps;
        if (QE[i].sw) mps = 1 - mps;
        i = QE[i].nlps;
      }
      a = qe;
      do {
        if (ct == 0) bytein();
        a <<= 1;
        c <<= 1;
        ct--;
      } while (!(a & 0x8000));
    } else {
      c -= (uint32_t)qe << 16;
      if (!(a & 0x8000)) {
        if (a < qe) {
          bit = 1 - mps;
          if (QE[i].sw) mps = 1 - mps;
          i = QE[i].nlps;
        } else {
          bit = mps;
          i = QE[i].nmps;
        }
        do {
          if (ct == 0) bytein();
          a <<= 1;
          c <<= 1;
          ct--;
        } while (!(a & 0x8000));
      } else {
        bit = mps;
      }
    }
    *cx = (uint8_t)((i << 1) | mps);
    return bit;
  }
};

// Arithmetic integer decoding (T.88 Annex A.2).  Each IAx procedure owns a
// 512-entry context bank.  Returns false on OOB.
struct IntCtx {
  uint8_t cx[512] = {0};
};

static bool decode_int(MQDecoder &mq, IntCtx &ia, int32_t *out) {
  int prev = 1;
  auto bit = [&]() {
    int b = mq.decode(&ia.cx[prev]);
    prev = prev < 256 ? ((prev << 1) | b)
                      : (((((prev << 1) | b)) & 511) | 256);
    return b;
  };
  auto bits = [&](int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) v = (v << 1) | (uint32_t)bit();
    return v;
  };
  int s = bit();
  int64_t v;
  if (!bit()) v = bits(2);
  else if (!bit()) v = (int64_t)bits(4) + 4;
  else if (!bit()) v = (int64_t)bits(6) + 20;
  else if (!bit()) v = (int64_t)bits(8) + 84;
  else if (!bit()) v = (int64_t)bits(12) + 340;
  else v = (int64_t)bits(32) + 4436;
  if (s && v == 0) return false;  // OOB
  *out = (int32_t)(s ? -v : v);
  return true;
}

// Symbol-ID decoding (T.88 A.3): codelen bits through a binary context tree.
static int decode_iaid(MQDecoder &mq, std::vector<uint8_t> &cx, int codelen) {
  int prev = 1;
  for (int i = 0; i < codelen; i++) prev = (prev << 1) | mq.decode(&cx[prev]);
  return prev - (1 << codelen);
}

// ---------------------------------------------------------------------------
// Huffman coding (T.88 Annex B).  Huffman-mode segment payloads are MSB-first
// bitstreams; collective bitmaps and MMR blocks inside them are byte-aligned.

struct BitReader {
  const uint8_t *d;
  long n, pos = 0;  // byte position
  int bit = 0;      // next bit within d[pos], 0 = MSB
  BitReader(const uint8_t *d, long n) : d(d), n(n) {}

  int read1() {
    if (pos >= n) fail("Huffman bitstream overrun");
    int b = (d[pos] >> (7 - bit)) & 1;
    if (++bit == 8) {
      bit = 0;
      pos++;
    }
    return b;
  }

  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) v = (v << 1) | (uint32_t)read1();
    return v;
  }

  void align() {
    if (bit) {
      bit = 0;
      pos++;
    }
  }

  const uint8_t *take_aligned(long k) {
    align();
    if (pos + k > n) fail("Huffman bitstream overrun");
    const uint8_t *r = d + pos;
    pos += k;
    return r;
  }
};

// One table line.  kind: 0 = normal value range, 1 = lower range (value =
// rangelow - 32-bit offset), 2 = OOB.  A normal line with rangelen 32 is the
// upper range (value = rangelow + 32-bit offset).
struct HuffLine {
  uint8_t preflen, rangelen, kind;
  int32_t rangelow;
};

struct HuffTable {
  std::vector<HuffLine> lines;
  std::vector<std::pair<int, uint32_t>> codes;  // per line: (len, code)

  // Canonical prefix-code assignment (T.88 B.3): lengths ascending, listed
  // order within a length.  preflen 0 lines get no code.
  void assign() {
    int maxlen = 0;
    for (auto &ln : lines) maxlen = std::max(maxlen, (int)ln.preflen);
    if (maxlen > 32) fail("Huffman prefix length %d out of range", maxlen);
    codes.assign(lines.size(), {0, 0});
    uint64_t cur = 0;
    for (int len = 1; len <= maxlen; len++) {
      for (size_t i = 0; i < lines.size(); i++) {
        if (lines[i].preflen == len) {
          if (cur >> len) fail("overfull Huffman table");
          codes[i] = {len, (uint32_t)cur++};
        }
      }
      cur <<= 1;
    }
  }

  // Returns false on OOB.
  bool decode(BitReader &br, int32_t *out) const {
    int len = 0;
    uint32_t code = 0;
    while (len < 32) {
      code = (code << 1) | (uint32_t)br.read1();
      len++;
      for (size_t i = 0; i < lines.size(); i++) {
        if (codes[i].first != len || codes[i].second != code) continue;
        const HuffLine &ln = lines[i];
        if (ln.kind == 2) return false;
        if (ln.kind == 1) {
          *out = (int32_t)((int64_t)ln.rangelow - (int64_t)br.read(32));
        } else if (ln.rangelen == 32) {
          *out = (int32_t)((int64_t)ln.rangelow + (int64_t)br.read(32));
        } else {
          *out = (int32_t)(ln.rangelow + (int32_t)br.read(ln.rangelen));
        }
        return true;
      }
    }
    fail("invalid Huffman code");
    return false;  // unreachable
  }
};

// Standard tables B.1-B.15, lines in the Annex's listed order (the order is
// part of the canonical code assignment).  Mirrored by the independent
// encoder in tests/jbig2_ref.py:STD_TABLES.
static HuffTable make_std_table(int which) {
  // {preflen, rangelen, kind, rangelow}
  static const HuffLine T1[] = {{1, 4, 0, 0}, {2, 8, 0, 16}, {3, 16, 0, 272},
                                {3, 32, 0, 65808}};
  static const HuffLine T2[] = {{1, 0, 0, 0},  {2, 0, 0, 1}, {3, 0, 0, 2},
                                {4, 3, 0, 3},  {5, 6, 0, 11}, {6, 32, 0, 75},
                                {6, 0, 2, 0}};
  static const HuffLine T3[] = {{8, 8, 0, -256}, {1, 0, 0, 0},  {2, 0, 0, 1},
                                {3, 0, 0, 2},    {4, 3, 0, 3},  {5, 6, 0, 11},
                                {8, 32, 1, -257}, {7, 32, 0, 75}, {6, 0, 2, 0}};
  static const HuffLine T4[] = {{1, 0, 0, 1}, {2, 0, 0, 2},  {3, 0, 0, 3},
                                {4, 3, 0, 4}, {5, 6, 0, 12}, {5, 32, 0, 76}};
  static const HuffLine T5[] = {{7, 8, 0, -255}, {1, 0, 0, 1}, {2, 0, 0, 2},
                                {3, 0, 0, 3},    {4, 3, 0, 4}, {5, 6, 0, 12},
                                {7, 32, 1, -256}, {6, 32, 0, 76}};
  static const HuffLine T6[] = {
      {5, 10, 0, -2048}, {4, 9, 0, -1024}, {4, 8, 0, -512}, {4, 7, 0, -256},
      {5, 6, 0, -128},   {5, 5, 0, -64},   {4, 5, 0, -32},  {2, 7, 0, 0},
      {3, 7, 0, 128},    {3, 8, 0, 256},   {4, 9, 0, 512},  {4, 10, 0, 1024},
      {6, 32, 1, -2049}, {6, 32, 0, 2048}};
  static const HuffLine T7[] = {
      {4, 9, 0, -1024}, {3, 8, 0, -512}, {4, 7, 0, -256}, {5, 6, 0, -128},
      {5, 5, 0, -64},   {4, 5, 0, -32},  {2, 9, 0, 0},    {3, 10, 0, 512},
      {3, 32, 1, -1025}, {3, 32, 0, 1536}};
  static const HuffLine T8[] = {
      {8, 3, 0, -15},  {9, 1, 0, -7},   {8, 1, 0, -5},   {9, 0, 0, -3},
      {7, 0, 0, -2},   {4, 0, 0, -1},   {2, 1, 0, 0},    {5, 0, 0, 2},
      {6, 0, 0, 3},    {3, 4, 0, 4},    {6, 1, 0, 20},   {4, 4, 0, 22},
      {4, 5, 0, 38},   {5, 6, 0, 70},   {5, 7, 0, 134},  {6, 7, 0, 262},
      {7, 8, 0, 390},  {6, 10, 0, 646}, {9, 32, 1, -16}, {9, 32, 0, 1670},
      {2, 0, 2, 0}};
  static const HuffLine T9[] = {
      {8, 4, 0, -31},  {9, 2, 0, -15},  {8, 2, 0, -11},  {9, 1, 0, -7},
      {7, 1, 0, -5},   {4, 1, 0, -3},   {3, 1, 0, -1},   {3, 1, 0, 1},
      {5, 1, 0, 3},    {6, 1, 0, 5},    {3, 5, 0, 7},    {6, 2, 0, 39},
      {4, 5, 0, 43},   {4, 6, 0, 75},   {5, 7, 0, 139},  {5, 8, 0, 267},
      {6, 8, 0, 523},  {7, 9, 0, 779},  {6, 11, 0, 1291}, {9, 32, 1, -32},
      {9, 32, 0, 3339}, {2, 0, 2, 0}};
  static const HuffLine T10[] = {
      {7, 4, 0, -21},  {8, 0, 0, -5},   {7, 0, 0, -4},   {5, 0, 0, -3},
      {2, 2, 0, -2},   {5, 0, 0, 2},    {6, 0, 0, 3},    {7, 0, 0, 4},
      {8, 0, 0, 5},    {2, 6, 0, 6},    {5, 5, 0, 70},   {6, 5, 0, 102},
      {7, 6, 0, 134},  {8, 7, 0, 198},  {8, 8, 0, 326},  {8, 9, 0, 582},
      {8, 10, 0, 1094}, {7, 11, 0, 2118}, {8, 32, 1, -22}, {8, 32, 0, 4166},
      {2, 0, 2, 0}};
  static const HuffLine T11[] = {
      {1, 0, 0, 1},  {2, 1, 0, 2},  {4, 0, 0, 4},  {4, 1, 0, 5},
      {5, 1, 0, 7},  {5, 2, 0, 9},  {6, 2, 0, 13}, {7, 2, 0, 17},
      {7, 3, 0, 21}, {7, 4, 0, 29}, {7, 5, 0, 45}, {7, 6, 0, 77},
      {7, 32, 0, 141}};
  static const HuffLine T12[] = {
      {1, 0, 0, 1},  {2, 0, 0, 2},  {3, 1, 0, 3},  {5, 0, 0, 5},
      {5, 1, 0, 6},  {6, 1, 0, 8},  {7, 0, 0, 10}, {7, 1, 0, 11},
      {7, 2, 0, 13}, {7, 3, 0, 17}, {7, 4, 0, 25}, {8, 5, 0, 41},
      {8, 32, 0, 73}};
  static const HuffLine T13[] = {
      {1, 0, 0, 1},  {3, 0, 0, 2},  {4, 0, 0, 3},  {5, 0, 0, 4},
      {4, 1, 0, 5},  {3, 3, 0, 7},  {6, 1, 0, 15}, {6, 2, 0, 17},
      {6, 3, 0, 21}, {6, 4, 0, 29}, {6, 5, 0, 45}, {7, 6, 0, 77},
      {7, 32, 0, 141}};
  static const HuffLine T14[] = {{3, 0, 0, -2}, {3, 0, 0, -1}, {1, 0, 0, 0},
                                 {3, 0, 0, 1},  {3, 0, 0, 2}};
  static const HuffLine T15[] = {
      {7, 4, 0, -24}, {6, 2, 0, -8}, {5, 1, 0, -4}, {4, 0, 0, -2},
      {3, 0, 0, -1},  {1, 0, 0, 0},  {3, 0, 0, 1},  {4, 0, 0, 2},
      {5, 1, 0, 3},   {6, 2, 0, 5},  {7, 4, 0, 9},  {7, 32, 1, -25},
      {7, 32, 0, 25}};
  struct Spec {
    const HuffLine *lines;
    size_t count;
  };
  static const Spec SPECS[15] = {
      {T1, 4},   {T2, 7},   {T3, 9},   {T4, 6},   {T5, 8},
      {T6, 14},  {T7, 10},  {T8, 21},  {T9, 22},  {T10, 21},
      {T11, 13}, {T12, 13}, {T13, 13}, {T14, 5},  {T15, 13}};
  if (which < 1 || which > 15) fail("no standard Huffman table B.%d", which);
  const Spec &s = SPECS[which - 1];
  HuffTable t;
  t.lines.assign(s.lines, s.lines + s.count);
  t.assign();
  return t;
}

// ---------------------------------------------------------------------------
// Bitmaps: one byte per pixel, 1 = black.  Out-of-bounds reads are 0.

struct J2Bitmap {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  J2Bitmap() = default;
  J2Bitmap(int w_, int h_, uint8_t fill = 0) : w(w_), h(h_) {
    if (w < 0 || h < 0 || (int64_t)w * h > (int64_t)1 << 30)
      fail("bitmap size %dx%d out of range", w_, h_);
    px.assign((size_t)w * h, fill);
  }
  inline uint8_t get(int x, int y) const {
    if ((unsigned)x >= (unsigned)w || (unsigned)y >= (unsigned)h) return 0;
    return px[(size_t)y * w + x];
  }
  inline void set(int x, int y, uint8_t v) {
    if ((unsigned)x >= (unsigned)w || (unsigned)y >= (unsigned)h) return;
    px[(size_t)y * w + x] = v;
  }
};

enum CombOp { OP_OR = 0, OP_AND = 1, OP_XOR = 2, OP_XNOR = 3, OP_REPLACE = 4 };

static void compose(J2Bitmap &dst, const J2Bitmap &src, int x0, int y0,
                    int op) {
  for (int y = 0; y < src.h; y++) {
    int dy = y0 + y;
    if (dy < 0 || dy >= dst.h) continue;
    for (int x = 0; x < src.w; x++) {
      int dx = x0 + x;
      if (dx < 0 || dx >= dst.w) continue;
      uint8_t s = src.px[(size_t)y * src.w + x];
      uint8_t &d = dst.px[(size_t)dy * dst.w + dx];
      switch (op) {
        case OP_OR: d |= s; break;
        case OP_AND: d &= s; break;
        case OP_XOR: d ^= s; break;
        case OP_XNOR: d = (uint8_t)(1 - (d ^ s)); break;
        default: d = s; break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Generic region decoding (T.88 6.2).  Context layouts follow the spec's
// template figures: bits are numbered with the AT slots at fixed positions
// (AT1..AT4), so custom AT coordinates keep their bit index.

struct GenericCtx {
  std::vector<uint8_t> cx;
  GenericCtx() : cx(1 << 16, 0) {}
};

static const uint16_t TPGDON_CTX[4] = {0x9B25, 0x0795, 0x00E5, 0x0195};

static void decode_generic(MQDecoder &mq, GenericCtx &gb, J2Bitmap &bm,
                           int tmpl, bool tpgdon, const int at[8],
                           const uint8_t *skip = nullptr) {
  int ltp = 0;
  for (int y = 0; y < bm.h; y++) {
    if (tpgdon) {
      ltp ^= mq.decode(&gb.cx[TPGDON_CTX[tmpl]]);
      if (ltp) {
        if (y > 0)
          memcpy(&bm.px[(size_t)y * bm.w], &bm.px[(size_t)(y - 1) * bm.w],
                 bm.w);
        continue;
      }
    }
    for (int x = 0; x < bm.w; x++) {
      if (skip && skip[(size_t)y * bm.w + x]) {
        bm.px[(size_t)y * bm.w + x] = 0;
        continue;
      }
      uint32_t ctx = 0;
      switch (tmpl) {
        case 0:
          ctx = (uint32_t)bm.get(x - 1, y) | ((uint32_t)bm.get(x - 2, y) << 1) |
                ((uint32_t)bm.get(x - 3, y) << 2) |
                ((uint32_t)bm.get(x - 4, y) << 3) |
                ((uint32_t)bm.get(x + at[0], y + at[1]) << 4) |
                ((uint32_t)bm.get(x + 2, y - 1) << 5) |
                ((uint32_t)bm.get(x + 1, y - 1) << 6) |
                ((uint32_t)bm.get(x, y - 1) << 7) |
                ((uint32_t)bm.get(x - 1, y - 1) << 8) |
                ((uint32_t)bm.get(x - 2, y - 1) << 9) |
                ((uint32_t)bm.get(x + at[2], y + at[3]) << 10) |
                ((uint32_t)bm.get(x + at[4], y + at[5]) << 11) |
                ((uint32_t)bm.get(x + 1, y - 2) << 12) |
                ((uint32_t)bm.get(x, y - 2) << 13) |
                ((uint32_t)bm.get(x - 1, y - 2) << 14) |
                ((uint32_t)bm.get(x + at[6], y + at[7]) << 15);
          break;
        case 1:
          ctx = (uint32_t)bm.get(x - 1, y) | ((uint32_t)bm.get(x - 2, y) << 1) |
                ((uint32_t)bm.get(x - 3, y) << 2) |
                ((uint32_t)bm.get(x + at[0], y + at[1]) << 3) |
                ((uint32_t)bm.get(x + 2, y - 1) << 4) |
                ((uint32_t)bm.get(x + 1, y - 1) << 5) |
                ((uint32_t)bm.get(x, y - 1) << 6) |
                ((uint32_t)bm.get(x - 1, y - 1) << 7) |
                ((uint32_t)bm.get(x - 2, y - 1) << 8) |
                ((uint32_t)bm.get(x + 2, y - 2) << 9) |
                ((uint32_t)bm.get(x + 1, y - 2) << 10) |
                ((uint32_t)bm.get(x, y - 2) << 11) |
                ((uint32_t)bm.get(x - 1, y - 2) << 12);
          break;
        case 2:
          ctx = (uint32_t)bm.get(x - 1, y) | ((uint32_t)bm.get(x - 2, y) << 1) |
                ((uint32_t)bm.get(x + at[0], y + at[1]) << 2) |
                ((uint32_t)bm.get(x + 1, y - 1) << 3) |
                ((uint32_t)bm.get(x, y - 1) << 4) |
                ((uint32_t)bm.get(x - 1, y - 1) << 5) |
                ((uint32_t)bm.get(x - 2, y - 1) << 6) |
                ((uint32_t)bm.get(x + 1, y - 2) << 7) |
                ((uint32_t)bm.get(x, y - 2) << 8) |
                ((uint32_t)bm.get(x - 1, y - 2) << 9);
          break;
        default:
          ctx = (uint32_t)bm.get(x - 1, y) | ((uint32_t)bm.get(x - 2, y) << 1) |
                ((uint32_t)bm.get(x - 3, y) << 2) |
                ((uint32_t)bm.get(x - 4, y) << 3) |
                ((uint32_t)bm.get(x + at[0], y + at[1]) << 4) |
                ((uint32_t)bm.get(x + 1, y - 1) << 5) |
                ((uint32_t)bm.get(x, y - 1) << 6) |
                ((uint32_t)bm.get(x - 1, y - 1) << 7) |
                ((uint32_t)bm.get(x - 2, y - 1) << 8) |
                ((uint32_t)bm.get(x - 3, y - 1) << 9);
          break;
      }
      bm.px[(size_t)y * bm.w + x] = (uint8_t)mq.decode(&gb.cx[ctx]);
    }
  }
}

// Generic refinement region decoding (T.88 6.3), templates 0-1, no TPGRON
// (typical-prediction refinement is unused by the PDF encoder population;
// streams that set it fail loudly at the call sites).
struct RefineCtx {
  std::vector<uint8_t> cx;
  RefineCtx() : cx(1 << 13, 0) {}
};

static void decode_refinement(MQDecoder &mq, RefineCtx &gr, J2Bitmap &bm,
                              const J2Bitmap &ref, int dx, int dy, int tmpl,
                              const int8_t at[4]) {
  for (int y = 0; y < bm.h; y++) {
    for (int x = 0; x < bm.w; x++) {
      int rx = x - dx, ry = y - dy;
      uint32_t ctx;
      if (tmpl == 0) {
        ctx = (uint32_t)bm.get(x - 1, y) |
              ((uint32_t)bm.get(x + 1, y - 1) << 1) |
              ((uint32_t)bm.get(x, y - 1) << 2) |
              ((uint32_t)bm.get(x + at[0], y + at[1]) << 3) |
              ((uint32_t)ref.get(rx + 1, ry + 1) << 4) |
              ((uint32_t)ref.get(rx, ry + 1) << 5) |
              ((uint32_t)ref.get(rx - 1, ry + 1) << 6) |
              ((uint32_t)ref.get(rx + at[2], ry + at[3]) << 7) |
              ((uint32_t)ref.get(rx + 1, ry) << 8) |
              ((uint32_t)ref.get(rx, ry) << 9) |
              ((uint32_t)ref.get(rx - 1, ry) << 10) |
              ((uint32_t)ref.get(rx + 1, ry - 1) << 11) |
              ((uint32_t)ref.get(rx, ry - 1) << 12);
      } else {
        ctx = (uint32_t)bm.get(x - 1, y) |
              ((uint32_t)bm.get(x + 1, y - 1) << 1) |
              ((uint32_t)bm.get(x, y - 1) << 2) |
              ((uint32_t)bm.get(x - 1, y - 1) << 3) |
              ((uint32_t)ref.get(rx + 1, ry + 1) << 4) |
              ((uint32_t)ref.get(rx, ry + 1) << 5) |
              ((uint32_t)ref.get(rx + 1, ry) << 6) |
              ((uint32_t)ref.get(rx, ry) << 7) |
              ((uint32_t)ref.get(rx - 1, ry) << 8) |
              ((uint32_t)ref.get(rx, ry - 1) << 9);
      }
      bm.px[(size_t)y * bm.w + x] = (uint8_t)mq.decode(&gr.cx[ctx]);
    }
  }
}

// ---------------------------------------------------------------------------
// Segment-stream reader.

struct Reader {
  const uint8_t *d;
  long n, p = 0;
  Reader(const uint8_t *d, long n) : d(d), n(n) {}
  bool eof() const { return p >= n; }
  uint8_t u8() {
    if (p >= n) fail("truncated segment stream");
    return d[p++];
  }
  uint16_t u16() {
    uint16_t v = (uint16_t)u8() << 8;
    return v | u8();
  }
  uint32_t u32() {
    uint32_t v = (uint32_t)u16() << 16;
    return v | u16();
  }
  int8_t s8() { return (int8_t)u8(); }
  const uint8_t *take(long k) {
    if (p + k > n) fail("truncated segment payload");
    const uint8_t *r = d + p;
    p += k;
    return r;
  }
};

struct SegmentHeader {
  uint32_t number = 0;
  int type = 0;
  std::vector<uint32_t> referred;
  uint32_t page = 0;
  uint32_t length = 0;
};

static SegmentHeader parse_segment_header(Reader &r) {
  SegmentHeader h;
  h.number = r.u32();
  uint8_t flags = r.u8();
  h.type = flags & 0x3F;
  bool page4 = flags & 0x40;
  uint8_t rts = r.u8();
  uint32_t count = rts >> 5;
  if (count == 7) {
    // long form: 29-bit count, then retain bits (ignored)
    r.p--;
    count = r.u32() & 0x1FFFFFFF;
    long retain_bytes = (count + 8) / 8;
    r.take(retain_bytes);
  }
  for (uint32_t i = 0; i < count; i++) {
    uint32_t ref;
    if (h.number <= 256) ref = r.u8();
    else if (h.number <= 65536) ref = r.u16();
    else ref = r.u32();
    h.referred.push_back(ref);
  }
  h.page = page4 ? r.u32() : r.u8();
  h.length = r.u32();
  return h;
}

// Region segment information field (T.88 7.4.1).
struct RegionInfo {
  uint32_t w, h, x, y;
  int combop;
};

static RegionInfo parse_region_info(Reader &r) {
  RegionInfo ri;
  ri.w = r.u32();
  ri.h = r.u32();
  ri.x = r.u32();
  ri.y = r.u32();
  ri.combop = r.u8() & 7;
  if (ri.w > (1u << 24) || ri.h > (1u << 24))
    fail("region %ux%u out of range", ri.w, ri.h);
  // Bound the placement too: ensure_page(ri.x + ri.w, ...) and compose's
  // int arithmetic must not wrap for hostile x/y near UINT32_MAX.
  if (ri.x > (1u << 24) || ri.y > (1u << 24))
    fail("region origin %u,%u out of range", ri.x, ri.y);
  return ri;
}

// ---------------------------------------------------------------------------
// Decoder state across segments.

struct Symbol {
  J2Bitmap bm;
};

struct Decoder {
  J2Bitmap page;
  bool page_started = false;
  uint8_t page_def_pixel = 0;
  int page_def_op = OP_OR;
  // symbol dictionaries by segment number
  std::vector<std::pair<uint32_t, std::vector<J2Bitmap>>> sym_dicts;
  // custom Huffman tables (type-53 segments) by segment number
  std::vector<std::pair<uint32_t, HuffTable>> huff_tables;
  // pattern dictionaries (type-16 segments) by segment number
  std::vector<std::pair<uint32_t, std::vector<J2Bitmap>>> pattern_dicts;

  std::vector<J2Bitmap> *find_dict(uint32_t seg) {
    for (auto &kv : sym_dicts)
      if (kv.first == seg) return &kv.second;
    return nullptr;
  }

  std::vector<const J2Bitmap *> gather_patterns(const SegmentHeader &h) {
    std::vector<const J2Bitmap *> out;
    for (uint32_t ref : h.referred)
      for (auto &kv : pattern_dicts)
        if (kv.first == ref)
          for (auto &b : kv.second) out.push_back(&b);
    return out;
  }

  // ---- pattern dictionary segment (type 16, T.88 6.7 / 7.4.4) ----
  void handle_pattern_dict(Reader &r, const SegmentHeader &h, long seg_end) {
    uint8_t flags = r.u8();
    bool mmr = flags & 1;
    int tmpl = (flags >> 1) & 3;
    int hdpw = r.u8();
    int hdph = r.u8();
    uint32_t graymax = r.u32();
    if (hdpw == 0 || hdph == 0) fail("empty halftone pattern");
    if (graymax > 0xFFFF) fail("implausible GRAYMAX %u", graymax);
    // one collective bitmap holding patterns 0..GRAYMAX side by side
    int collw = (int)(graymax + 1) * hdpw;
    J2Bitmap coll(collw, hdph);
    long payload = seg_end - r.p;
    if (payload < 0) fail("pattern dictionary payload underflow");
    if (mmr) {
      std::vector<uint8_t> out((size_t)collw * hdph, 0);
      int rows = ccitt_decode(r.d + r.p, payload, collw, /*k=*/-1,
                              /*byte_align=*/0, out.data(), hdph);
      if (rows < hdph)
        fail("MMR pattern dictionary decoded %d of %d rows", rows, hdph);
      memcpy(coll.px.data(), out.data(), out.size());
    } else {
      // fixed AT pixels (6.7.5): A1 = (-HDPW, 0) — the previous pattern's
      // corresponding pixel — A2..A4 nominal
      int at[8] = {-hdpw, 0, -3, -1, 2, -2, -2, -2};
      MQDecoder mq;
      mq.init(r.d + r.p, payload);
      GenericCtx gb;
      decode_generic(mq, gb, coll, tmpl, false, at);
    }
    std::vector<J2Bitmap> pats;
    pats.reserve(graymax + 1);
    for (uint32_t i = 0; i <= graymax; i++) {
      J2Bitmap bm(hdpw, hdph);
      for (int y = 0; y < hdph; y++)
        memcpy(&bm.px[(size_t)y * hdpw],
               &coll.px[(size_t)y * collw + (size_t)i * hdpw], hdpw);
      pats.push_back(std::move(bm));
    }
    r.p = seg_end;
    pattern_dicts.emplace_back(h.number, std::move(pats));
  }

  // ---- halftone region segment (types 20/22/23, T.88 6.6 + Annex C) ----
  void handle_halftone_region(Reader &r, const SegmentHeader &h, long seg_end,
                              bool immediate) {
    RegionInfo ri = parse_region_info(r);
    uint8_t flags = r.u8();
    bool mmr = flags & 1;
    int tmpl = (flags >> 1) & 3;
    bool enableskip = (flags >> 3) & 1;
    int hcombop = (flags >> 4) & 7;
    uint8_t defpixel = (flags >> 7) & 1;
    uint32_t hgw = r.u32();
    uint32_t hgh = r.u32();
    int32_t hgx = (int32_t)r.u32();
    int32_t hgy = (int32_t)r.u32();
    uint32_t hrx = r.u16();
    uint32_t hry = r.u16();
    if (hgw == 0 || hgh == 0 || (uint64_t)hgw * hgh > (uint64_t)1 << 26)
      fail("halftone grid %ux%u out of range", hgw, hgh);
    // grid coordinates are 8.8 fixed point; bound them so the int math in
    // cell placement cannot overflow
    if (hgx < -(1 << 28) || hgx > (1 << 28) || hgy < -(1 << 28) ||
        hgy > (1 << 28))
      fail("halftone grid origin out of range");

    std::vector<const J2Bitmap *> pats = gather_patterns(h);
    if (pats.empty()) fail("halftone region refers to no patterns");
    int hpw = pats[0]->w, hph = pats[0]->h;
    int bits = 1;
    while ((1u << bits) < pats.size()) bits++;  // GSBPP = ceil(log2(HNUMPATS))

    // cell top-left for grid position (m, n) — T.88 6.6.5.1
    auto cell_x = [&](int m, int n) {
      return (int)(((int64_t)hgx + (int64_t)m * (int32_t)hry +
                    (int64_t)n * (int32_t)hrx) >> 8);
    };
    auto cell_y = [&](int m, int n) {
      return (int)(((int64_t)hgy + (int64_t)m * (int32_t)hrx -
                    (int64_t)n * (int32_t)hry) >> 8);
    };

    std::vector<uint8_t> skip;
    if (enableskip && !mmr) {
      skip.assign((size_t)hgw * hgh, 0);
      for (uint32_t m = 0; m < hgh; m++)
        for (uint32_t n = 0; n < hgw; n++) {
          int x = cell_x(m, n), y = cell_y(m, n);
          if (x + hpw <= 0 || x >= (int)ri.w || y + hph <= 0 ||
              y >= (int)ri.h)
            skip[(size_t)m * hgw + n] = 1;
        }
    }

    // grayscale image (Annex C): gray-coded bitplanes MSB->LSB, one shared
    // generic-region context (arithmetic) or one continuous MMR stream
    long payload = seg_end - r.p;
    if (payload < 0) fail("halftone region payload underflow");
    std::vector<J2Bitmap> planes;
    planes.reserve(bits);
    if (mmr) {
      std::vector<uint8_t> out((size_t)hgw * hgh * bits, 0);
      int rows = ccitt_decode(r.d + r.p, payload, (int)hgw, /*k=*/-1,
                              /*byte_align=*/0, out.data(), (int)hgh * bits);
      if (rows < (int)hgh * bits)
        fail("MMR halftone planes decoded %d of %u rows", rows, hgh * bits);
      for (int j = 0; j < bits; j++) {
        J2Bitmap p((int)hgw, (int)hgh);
        memcpy(p.px.data(), out.data() + (size_t)j * hgw * hgh,
               (size_t)hgw * hgh);
        planes.push_back(std::move(p));
      }
    } else {
      // fixed AT pixels (C.5): A1 = (template <= 1 ? 3 : 2, -1)
      int at[8] = {tmpl <= 1 ? 3 : 2, -1, -3, -1, 2, -2, -2, -2};
      MQDecoder mq;
      mq.init(r.d + r.p, payload);
      GenericCtx gb;
      for (int j = 0; j < bits; j++) {
        J2Bitmap p((int)hgw, (int)hgh);
        decode_generic(mq, gb, p, tmpl, false, at,
                       skip.empty() ? nullptr : skip.data());
        planes.push_back(std::move(p));
      }
    }

    J2Bitmap region((int)ri.w, (int)ri.h, defpixel);
    for (uint32_t m = 0; m < hgh; m++) {
      for (uint32_t n = 0; n < hgw; n++) {
        // gray decode: b_J = plane_J (MSB); b_j = plane_j ^ b_{j+1}
        int b = 0, v = 0;
        for (int j = 0; j < bits; j++) {
          b ^= planes[j].px[(size_t)m * hgw + n];
          v = (v << 1) | b;
        }
        if ((size_t)v >= pats.size()) v = (int)pats.size() - 1;
        compose(region, *pats[v], cell_x(m, n), cell_y(m, n), hcombop);
      }
    }
    r.p = seg_end;
    if (immediate) {
      ensure_page(ri.x + ri.w, ri.y + ri.h);
      compose(page, region, (int)ri.x, (int)ri.y, ri.combop);
    } else {
      fail("intermediate halftone regions not supported");
    }
  }

  // Custom tables referred to by a region/dict segment, in referral order —
  // selector value "custom" consumes them in order of use (T.88 7.4.3.1.6).
  std::vector<const HuffTable *> gather_tables(const SegmentHeader &h) {
    std::vector<const HuffTable *> out;
    for (uint32_t ref : h.referred)
      for (auto &kv : huff_tables)
        if (kv.first == ref) out.push_back(&kv.second);
    return out;
  }

  // ---- table segment (type 53, T.88 B.2.4) ----
  void handle_table_segment(Reader &r, const SegmentHeader &h, long seg_end) {
    uint8_t tflags = r.u8();
    bool oob = tflags & 1;
    int htps = ((tflags >> 1) & 7) + 1;
    int htrs = ((tflags >> 4) & 7) + 1;
    int32_t low = (int32_t)r.u32();
    int32_t high = (int32_t)r.u32();
    // bound the span AND the endpoints: `low - 1` (the lower line) and the
    // per-line `cur + 2^rangelen` walk must not overflow on hostile input
    if (low < -(1 << 30) || high > (1 << 30) || (int64_t)high - low > (int64_t)1 << 31)
      fail("custom table range out of bounds");
    BitReader br(r.d + r.p, seg_end - r.p);
    HuffTable t;
    int64_t cur = low;
    while (cur < high) {
      uint8_t preflen = (uint8_t)br.read(htps);
      uint8_t rangelen = (uint8_t)br.read(htrs);
      if (rangelen > 32) fail("custom table range length %d", rangelen);
      t.lines.push_back({preflen, rangelen, 0, (int32_t)cur});
      cur += (int64_t)1 << rangelen;
      if (t.lines.size() > 4096) fail("custom table too large");
    }
    t.lines.push_back({(uint8_t)br.read(htps), 32, 1, low - 1});  // lower
    t.lines.push_back({(uint8_t)br.read(htps), 32, 0, high});     // upper
    if (oob) t.lines.push_back({(uint8_t)br.read(htps), 0, 2, 0});
    t.assign();
    r.p = seg_end;
    huff_tables.emplace_back(h.number, std::move(t));
  }

  void gather_input_symbols(const SegmentHeader &h,
                            std::vector<const J2Bitmap *> &out) {
    for (uint32_t ref : h.referred) {
      auto *d = find_dict(ref);
      if (!d) continue;  // referred segment may be a table/page segment
      for (auto &b : *d) out.push_back(&b);
    }
  }

  void ensure_page(uint32_t need_w, uint32_t need_h) {
    // PDF images always carry a page-info segment, but be forgiving: grow
    // or create the page buffer to cover the region being composed.
    if (!page_started) {
      page = J2Bitmap((int)need_w, (int)need_h, page_def_pixel);
      page_started = true;
      return;
    }
    if ((int)need_h > page.h || (int)need_w > page.w) {
      J2Bitmap bigger(std::max((int)need_w, page.w),
                      std::max((int)need_h, page.h), page_def_pixel);
      compose(bigger, page, 0, 0, OP_REPLACE);
      page = std::move(bigger);
    }
  }

  void handle_page_info(Reader &r) {
    uint32_t w = r.u32();
    uint32_t h = r.u32();
    r.u32();  // x resolution
    r.u32();  // y resolution
    uint8_t flags = r.u8();
    page_def_pixel = (flags >> 2) & 1;
    page_def_op = (flags >> 3) & 3;
    r.u16();  // striping information
    if (h == 0xFFFFFFFF) h = 0;  // unknown height: grow via regions
    page = J2Bitmap((int)w, (int)h, page_def_pixel);
    page_started = true;
  }

  // ---- generic region segment (types 36/38/39) ----
  void handle_generic_region(Reader &r, long seg_end) {
    RegionInfo ri = parse_region_info(r);
    uint8_t flags = r.u8();
    bool mmr = flags & 1;
    int tmpl = (flags >> 1) & 3;
    bool tpgdon = (flags >> 3) & 1;
    int at[8] = {0};
    if (!mmr) {
      int nat = tmpl == 0 ? 4 : 1;
      for (int i = 0; i < nat; i++) {
        at[2 * i] = r.s8();
        at[2 * i + 1] = r.s8();
      }
    }
    J2Bitmap bm((int)ri.w, (int)ri.h);
    long payload = seg_end - r.p;
    if (payload < 0) fail("generic region payload underflow");
    if (mmr) {
      // JBIG2 MMR is T.6 (pure 2-D) coding — shared with the CCITT decoder.
      std::vector<uint8_t> out((size_t)ri.w * ri.h, 0);
      int rows = ccitt_decode(r.d + r.p, payload, (int)ri.w, /*k=*/-1,
                              /*byte_align=*/0, out.data(), (int)ri.h);
      // Fail loudly on corrupt/truncated MMR payloads, matching the
      // arithmetic path's policy, instead of composing half-blank rows.
      if (rows < (int)ri.h)
        fail("MMR generic region decoded %d of %u rows", rows, ri.h);
      memcpy(bm.px.data(), out.data(), out.size());
    } else {
      MQDecoder mq;
      mq.init(r.d + r.p, payload);
      GenericCtx gb;
      decode_generic(mq, gb, bm, tmpl, tpgdon, at);
    }
    r.p = seg_end;
    ensure_page(ri.x + ri.w, ri.y + ri.h);
    compose(page, bm, (int)ri.x, (int)ri.y, ri.combop);
  }

  // Export-flag decoding (T.88 6.5.10): runs over (input ++ new) symbols
  // with an alternating flag.  Shared by the arithmetic and Huffman paths —
  // only the run-length read differs.
  template <typename ReadRun>
  std::vector<J2Bitmap> decode_exports(const std::vector<const J2Bitmap *> &input,
                                       std::vector<J2Bitmap> &newsyms,
                                       uint32_t numex, ReadRun read_run) {
    std::vector<J2Bitmap> exported;
    uint32_t numin = (uint32_t)input.size();
    uint32_t i = 0, total = numin + (uint32_t)newsyms.size();
    int curex = 0;
    while (i < total && exported.size() < numex) {
      int32_t run;
      if (!read_run(&run)) fail("OOB in EXFLAGS run");
      if (run < 0 || i + (uint32_t)run > total) fail("bad export run");
      if (curex) {
        for (int32_t k = 0; k < run; k++, i++) {
          if (i < numin) exported.push_back(*input[i]);
          else exported.push_back(newsyms[i - numin]);
        }
      } else {
        i += run;
      }
      curex ^= 1;
    }
    if (exported.size() != numex)
      fail("exported %zu symbols, expected %u", exported.size(), numex);
    return exported;
  }

  // ---- SDHUFF=1 symbol dictionary (T.88 6.5 Huffman paths) ----
  void handle_symbol_dict_huffman(Reader &r, const SegmentHeader &h,
                                  long seg_end, uint16_t flags) {
    bool sdrefagg = (flags >> 1) & 1;
    if (sdrefagg)
      fail("Huffman symbol dictionary with refinement/aggregation "
           "not supported");
    int sel_dh = (flags >> 2) & 3;
    int sel_dw = (flags >> 4) & 3;
    int sel_bm = (flags >> 6) & 1;
    // (SDHUFFAGGINST, bit 7, only applies with SDREFAGG — rejected above.)
    uint32_t numex = r.u32();
    uint32_t numnew = r.u32();
    if (numnew > 100000 || numex > 200000)
      fail("implausible symbol counts %u/%u", numnew, numex);

    std::vector<const J2Bitmap *> input;
    gather_input_symbols(h, input);
    std::vector<const HuffTable *> customs = gather_tables(h);
    size_t next_custom = 0;
    auto custom = [&]() -> const HuffTable * {
      if (next_custom >= customs.size())
        fail("symbol dictionary missing a referred custom table");
      return customs[next_custom++];
    };
    HuffTable std_dh, std_dw, std_bm, std_ex;
    const HuffTable *tdh, *tdw, *tbm;
    if (sel_dh == 3) tdh = custom();
    else if (sel_dh == 2) fail("invalid SDHUFFDH selector");
    else tdh = &(std_dh = make_std_table(sel_dh == 0 ? 4 : 5));
    if (sel_dw == 3) tdw = custom();
    else if (sel_dw == 2) fail("invalid SDHUFFDW selector");
    else tdw = &(std_dw = make_std_table(sel_dw == 0 ? 2 : 3));
    tbm = sel_bm ? custom() : &(std_bm = make_std_table(1));
    std_ex = make_std_table(1);  // EXFLAGS runs always use B.1

    BitReader br(r.d + r.p, seg_end - r.p);
    std::vector<J2Bitmap> newsyms;
    newsyms.reserve(numnew);
    int32_t hcheight = 0;
    while (newsyms.size() < numnew) {
      int32_t hcdh;
      if (!tdh->decode(br, &hcdh)) fail("OOB in DH");
      hcheight += hcdh;
      if (hcheight < 0 || hcheight > (1 << 20)) fail("bad height class");
      // Widths for the whole height class first (6.5.5), then one
      // byte-aligned collective bitmap covering all of them (6.5.9).
      std::vector<int32_t> widths;
      int32_t symwidth = 0;
      int64_t totwidth = 0;
      for (;;) {
        int32_t dw;
        if (!tdw->decode(br, &dw)) break;  // OOB ends the height class
        symwidth += dw;
        if (symwidth <= 0 || symwidth > (1 << 20)) fail("bad symbol width");
        if (newsyms.size() + widths.size() >= numnew)
          fail("too many symbols in dictionary");
        widths.push_back(symwidth);
        totwidth += symwidth;
      }
      if (totwidth > (1 << 24)) fail("height class too wide");
      int32_t bmsize;
      if (!tbm->decode(br, &bmsize)) fail("OOB in BMSIZE");
      if (bmsize < 0) fail("negative collective bitmap size");
      J2Bitmap coll((int)totwidth, hcheight);
      if (bmsize == 0) {
        // Uncompressed: rows padded to byte boundaries, MSB-first pixels.
        long rowbytes = (totwidth + 7) / 8;
        const uint8_t *data = br.take_aligned(rowbytes * hcheight);
        for (int y = 0; y < hcheight; y++)
          for (int64_t x = 0; x < totwidth; x++)
            coll.px[(size_t)y * coll.w + x] =
                (data[y * rowbytes + (x >> 3)] >> (7 - (x & 7))) & 1;
      } else {
        // MMR (T.6) coded, bmsize whole bytes.
        const uint8_t *data = br.take_aligned(bmsize);
        std::vector<uint8_t> out((size_t)totwidth * hcheight, 0);
        int rows = ccitt_decode(data, bmsize, (int)totwidth, /*k=*/-1,
                                /*byte_align=*/0, out.data(), hcheight);
        if (rows < hcheight)
          fail("MMR collective bitmap decoded %d of %d rows", rows, hcheight);
        memcpy(coll.px.data(), out.data(), out.size());
      }
      int32_t x0 = 0;
      for (int32_t wsym : widths) {
        J2Bitmap bm(wsym, hcheight);
        for (int y = 0; y < hcheight; y++)
          memcpy(&bm.px[(size_t)y * wsym], &coll.px[(size_t)y * coll.w + x0],
                 wsym);
        newsyms.push_back(std::move(bm));
        x0 += wsym;
      }
    }

    std::vector<J2Bitmap> exported = decode_exports(
        input, newsyms, numex,
        [&](int32_t *run) { return std_ex.decode(br, run); });
    r.p = seg_end;
    sym_dicts.emplace_back(h.number, std::move(exported));
  }

  // ---- symbol dictionary segment (type 0) ----
  void handle_symbol_dict(Reader &r, const SegmentHeader &h, long seg_end) {
    uint16_t flags = r.u16();
    bool sdhuff = flags & 1;
    bool sdrefagg = (flags >> 1) & 1;
    int sdtemplate = (flags >> 10) & 3;
    int sdrtemplate = (flags >> 12) & 1;
    bool ctx_used = (flags >> 8) & 1;
    if (ctx_used) fail("symbol dictionary context import not supported");
    if (sdhuff) {
      handle_symbol_dict_huffman(r, h, seg_end, flags);
      return;
    }
    int at[8] = {0};
    int nat = sdtemplate == 0 ? 4 : 1;
    for (int i = 0; i < nat; i++) {
      at[2 * i] = r.s8();
      at[2 * i + 1] = r.s8();
    }
    int8_t rat[4] = {0};
    if (sdrefagg && sdrtemplate == 0) {
      for (int i = 0; i < 4; i++) rat[i] = r.s8();
    }
    uint32_t numex = r.u32();
    uint32_t numnew = r.u32();
    if (numnew > 100000 || numex > 200000)
      fail("implausible symbol counts %u/%u", numnew, numex);

    std::vector<const J2Bitmap *> input;
    gather_input_symbols(h, input);
    uint32_t numin = (uint32_t)input.size();

    MQDecoder mq;
    mq.init(r.d + r.p, seg_end - r.p);
    GenericCtx gb;
    RefineCtx gr;
    IntCtx iadh, iadw, iaex, iaai, iardx, iardy;
    int codelen = 0;
    while ((1u << codelen) < numin + numnew) codelen++;
    if (codelen == 0) codelen = 1;
    std::vector<uint8_t> iaid_cx((size_t)1 << (codelen + 1), 0);

    std::vector<J2Bitmap> newsyms;
    newsyms.reserve(numnew);
    int32_t hcheight = 0;
    while (newsyms.size() < numnew) {
      int32_t hcdh;
      if (!decode_int(mq, iadh, &hcdh)) fail("OOB in IADH");
      hcheight += hcdh;
      if (hcheight < 0 || hcheight > (1 << 20)) fail("bad height class");
      int32_t symwidth = 0;
      for (;;) {
        int32_t dw;
        if (!decode_int(mq, iadw, &dw)) break;  // OOB ends the height class
        symwidth += dw;
        if (symwidth <= 0 || symwidth > (1 << 20)) fail("bad symbol width");
        if (newsyms.size() >= numnew) fail("too many symbols in dictionary");
        J2Bitmap bm(symwidth, hcheight);
        if (!sdrefagg) {
          decode_generic(mq, gb, bm, sdtemplate, false, at);
        } else {
          int32_t nrefs;
          if (!decode_int(mq, iaai, &nrefs)) fail("OOB in IAAI");
          if (nrefs != 1)
            fail("aggregate symbol coding (REFAGGNINST=%d) not supported",
                 nrefs);
          int id = decode_iaid(mq, iaid_cx, codelen);
          int32_t rdx, rdy;
          if (!decode_int(mq, iardx, &rdx)) fail("OOB in IARDX");
          if (!decode_int(mq, iardy, &rdy)) fail("OOB in IARDY");
          const J2Bitmap *ref = nullptr;
          if ((uint32_t)id < numin) ref = input[id];
          else if ((uint32_t)id < numin + newsyms.size())
            ref = &newsyms[id - numin];
          else fail("refinement reference id %d out of range", id);
          decode_refinement(mq, gr, bm, *ref, rdx, rdy, sdrtemplate, rat);
        }
        newsyms.push_back(std::move(bm));
      }
    }

    std::vector<J2Bitmap> exported = decode_exports(
        input, newsyms, numex,
        [&](int32_t *run) { return decode_int(mq, iaex, run); });
    r.p = seg_end;
    sym_dicts.emplace_back(h.number, std::move(exported));
  }

  // Symbol-ID code table for SBHUFF=1 text regions (T.88 7.4.3.1.7): 35
  // 4-bit runcode lengths, then per-symbol code lengths carried by the
  // runcode mechanism, then canonical assignment over symbol indices.
  HuffTable decode_symbol_id_table(BitReader &br, uint32_t numsyms) {
    HuffTable rct;
    for (int i = 0; i < 35; i++)
      rct.lines.push_back({(uint8_t)br.read(4), 0, 0, i});
    rct.assign();
    std::vector<uint8_t> codelens(numsyms, 0);
    uint32_t i = 0;
    int prev = 0;
    while (i < numsyms) {
      int32_t rc;
      if (!rct.decode(br, &rc)) fail("OOB in symbol ID runcodes");
      if (rc < 32) {
        codelens[i++] = (uint8_t)rc;
        prev = rc;
      } else {
        uint32_t rep;
        int fill;
        if (rc == 32) {
          if (i == 0) fail("runcode 32 with no previous length");
          rep = br.read(2) + 3;
          fill = prev;
        } else if (rc == 33) {
          rep = br.read(3) + 3;
          fill = 0;
        } else {
          rep = br.read(7) + 11;
          fill = 0;
        }
        if (i + rep > numsyms) fail("symbol ID runcode overruns table");
        while (rep--) codelens[i++] = (uint8_t)fill;
      }
    }
    br.align();
    HuffTable symt;
    for (uint32_t s = 0; s < numsyms; s++)
      symt.lines.push_back({codelens[s], 0, 0, (int32_t)s});
    symt.assign();
    return symt;
  }

  // ---- text region segment (types 4/6/7) ----
  void handle_text_region(Reader &r, const SegmentHeader &h, long seg_end,
                          bool immediate) {
    RegionInfo ri = parse_region_info(r);
    uint16_t flags = r.u16();
    bool sbhuff = flags & 1;
    bool sbrefine = (flags >> 1) & 1;
    int log2strips = (flags >> 2) & 3;
    int refcorner = (flags >> 4) & 3;
    bool transposed = (flags >> 6) & 1;
    int sbcombop = (flags >> 7) & 3;
    int sbdefpixel = (flags >> 9) & 1;
    int sbdsoffset = (flags >> 10) & 0x1F;
    if (sbdsoffset > 15) sbdsoffset -= 32;  // signed 5-bit
    int sbrtemplate = (flags >> 15) & 1;
    uint16_t hflags = 0;
    if (sbhuff) {
      if (sbrefine) fail("Huffman text region refinement not supported");
      hflags = r.u16();
    }
    int8_t rat[4] = {0};
    if (sbrefine && sbrtemplate == 0) {
      for (int i = 0; i < 4; i++) rat[i] = r.s8();
    }
    uint32_t numinstances = r.u32();
    // corrupt streams can claim billions of instances; each instance
    // covers >= 1 px, so region area bounds any plausible count
    // (area in 64-bit: w,h are each allowed up to 2^24, so the 32-bit
    // product could wrap and defeat this cap)
    if ((uint64_t)numinstances > (uint64_t)ri.w * ri.h + 1024)
      fail("implausible instance count %u for %ux%u region", numinstances,
           ri.w, ri.h);
    int sbstrips = 1 << log2strips;

    std::vector<const J2Bitmap *> syms;
    gather_input_symbols(h, syms);
    uint32_t numsyms = (uint32_t)syms.size();
    if (numsyms == 0) fail("text region refers to no symbols");

    J2Bitmap region((int)ri.w, (int)ri.h, (uint8_t)sbdefpixel);

    // Instance placement (T.88 6.4.5 step 3(c)(x)) — shared by both coding
    // modes.  S runs along x unless TRANSPOSED; left/right corner placement
    // differs only in when CURS advances, both resolve to edge = CURS.
    auto place = [&](const J2Bitmap &wi, int32_t &curs, int32_t ti) {
      int ws = wi.w - 1, hs = wi.h - 1;
      if (!transposed) {
        int x0 = curs;
        int y0 = (refcorner == 1 || refcorner == 3) ? ti : ti - hs;
        compose(region, wi, x0, y0, sbcombop);
        curs += ws;
      } else {
        int y0 = curs;
        int x0 = (refcorner == 0 || refcorner == 1) ? ti : ti - ws;
        compose(region, wi, x0, y0, sbcombop);
        curs += hs;
      }
    };

    if (sbhuff) {
      int sel_fs = hflags & 3;
      int sel_ds = (hflags >> 2) & 3;
      int sel_dt = (hflags >> 4) & 3;
      std::vector<const HuffTable *> customs = gather_tables(h);
      size_t next_custom = 0;
      auto custom = [&]() -> const HuffTable * {
        if (next_custom >= customs.size())
          fail("text region missing a referred custom table");
        return customs[next_custom++];
      };
      HuffTable std_fs, std_ds, std_dt;
      const HuffTable *tfs, *tds, *tdt;
      if (sel_fs == 3) tfs = custom();
      else if (sel_fs == 2) fail("invalid SBHUFFFS selector");
      else tfs = &(std_fs = make_std_table(sel_fs == 0 ? 6 : 7));
      if (sel_ds == 3) tds = custom();
      else tds = &(std_ds = make_std_table(8 + sel_ds));
      if (sel_dt == 3) tdt = custom();
      else tdt = &(std_dt = make_std_table(11 + sel_dt));

      BitReader br(r.d + r.p, seg_end - r.p);
      HuffTable symt = decode_symbol_id_table(br, numsyms);

      int32_t stript;
      if (!tdt->decode(br, &stript)) fail("OOB in DT");
      stript *= -sbstrips;
      int32_t firsts = 0;
      uint32_t ninst = 0;
      while (ninst < numinstances) {
        int32_t dt;
        if (!tdt->decode(br, &dt)) fail("OOB in DT");
        stript += dt * sbstrips;
        int32_t curs = 0;
        bool first = true;
        for (;;) {
          if (first) {
            int32_t dfs;
            if (!tfs->decode(br, &dfs)) fail("OOB in FS");
            firsts += dfs;
            curs = firsts;
            first = false;
          } else {
            int32_t ids;
            if (!tds->decode(br, &ids)) break;  // OOB: end of strip
            curs += ids + sbdsoffset;
          }
          if (ninst >= numinstances) break;
          // CURT is a raw log2(SBSTRIPS)-bit field in Huffman mode.
          int32_t curt = sbstrips > 1 ? (int32_t)br.read(log2strips) : 0;
          int32_t ti = stript + curt;
          int32_t id;
          if (!symt.decode(br, &id)) fail("OOB in symbol ID");
          if ((uint32_t)id >= numsyms) fail("symbol id %d out of range", id);
          place(*syms[id], curs, ti);
          ninst++;
        }
      }
    } else {
      int codelen = 0;
      while ((1u << codelen) < numsyms) codelen++;
      if (codelen == 0) codelen = 1;

      MQDecoder mq;
      mq.init(r.d + r.p, seg_end - r.p);
      IntCtx iadt, iafs, iads, iait, iari, iardw, iardh, iardx, iardy;
      RefineCtx gr;
      std::vector<uint8_t> iaid_cx((size_t)1 << (codelen + 1), 0);

      int32_t stript;
      if (!decode_int(mq, iadt, &stript)) fail("OOB in IADT");
      stript *= -sbstrips;
      int32_t firsts = 0;
      uint32_t ninst = 0;
      while (ninst < numinstances) {
        int32_t dt;
        if (!decode_int(mq, iadt, &dt)) fail("OOB in IADT");
        stript += dt * sbstrips;
        int32_t curs = 0;
        bool first = true;
        for (;;) {
          if (first) {
            int32_t dfs;
            if (!decode_int(mq, iafs, &dfs)) fail("OOB in IAFS");
            firsts += dfs;
            curs = firsts;
            first = false;
          } else {
            int32_t ids;
            if (!decode_int(mq, iads, &ids)) break;  // OOB: end of strip
            curs += ids + sbdsoffset;
          }
          if (ninst >= numinstances) break;
          int32_t curt = 0;
          if (sbstrips > 1) {
            if (!decode_int(mq, iait, &curt)) fail("OOB in IAIT");
          }
          int32_t ti = stript + curt;
          int id = decode_iaid(mq, iaid_cx, codelen);
          if ((uint32_t)id >= numsyms) fail("symbol id %d out of range", id);
          const J2Bitmap *wi = syms[id];
          J2Bitmap refined;
          if (sbrefine) {
            int32_t ri_flag;
            if (!decode_int(mq, iari, &ri_flag)) fail("OOB in IARI");
            if (ri_flag) {
              int32_t rdw, rdh, rdx, rdy;
              if (!decode_int(mq, iardw, &rdw)) fail("OOB in IARDW");
              if (!decode_int(mq, iardh, &rdh)) fail("OOB in IARDH");
              if (!decode_int(mq, iardx, &rdx)) fail("OOB in IARDX");
              if (!decode_int(mq, iardy, &rdy)) fail("OOB in IARDY");
              int nw = wi->w + rdw, nh = wi->h + rdh;
              if (nw <= 0 || nh <= 0 || nw > (1 << 20) || nh > (1 << 20))
                fail("bad refined symbol size");
              refined = J2Bitmap(nw, nh);
              // floor division for negative deltas (T.88 6.4.11)
              auto floor2 = [](int32_t v) {
                return v >= 0 ? v / 2 : -((-v + 1) / 2);
              };
              decode_refinement(mq, gr, refined, *wi, floor2(rdw) + rdx,
                                floor2(rdh) + rdy, sbrtemplate, rat);
              wi = &refined;
            }
          }
          place(*wi, curs, ti);
          ninst++;
        }
      }
    }
    r.p = seg_end;
    if (immediate) {
      ensure_page(ri.x + ri.w, ri.y + ri.h);
      compose(page, region, (int)ri.x, (int)ri.y, ri.combop);
    } else {
      fail("intermediate text regions not supported");
    }
  }

  void run(const uint8_t *data, long n) {
    Reader r(data, n);
    while (!r.eof()) {
      // tolerate trailing zero padding after the last segment
      if (r.n - r.p < 11) break;
      SegmentHeader h = parse_segment_header(r);
      if (h.length == 0xFFFFFFFF)
        fail("unknown-length segment (type %d) not supported", h.type);
      long seg_end = r.p + (long)h.length;
      if (seg_end > r.n) fail("segment %u overruns stream", h.number);
      switch (h.type) {
        case 0:
          handle_symbol_dict(r, h, seg_end);
          break;
        case 4:
          handle_text_region(r, h, seg_end, /*immediate=*/false);
          break;
        case 6:
        case 7:
          handle_text_region(r, h, seg_end, /*immediate=*/true);
          break;
        case 36:
          fail("intermediate generic regions not supported");
          break;
        case 38:
        case 39:
          handle_generic_region(r, seg_end);
          break;
        case 48:
          handle_page_info(r);
          break;
        case 16:
          handle_pattern_dict(r, h, seg_end);
          break;
        case 20:
          handle_halftone_region(r, h, seg_end, /*immediate=*/false);
          break;
        case 22:
        case 23:
          handle_halftone_region(r, h, seg_end, /*immediate=*/true);
          break;
        case 40:
        case 42:
        case 43:
          fail("standalone refinement regions not supported");
          break;
        case 49:  // end of page
        case 50:  // end of stripe (page height already covers regions)
        case 51:  // end of file
        case 52:  // profiles
        case 62:  // extension
          break;
        case 53:
          handle_table_segment(r, h, seg_end);
          break;
        default:
          fail("unknown segment type %d", h.type);
      }
      r.p = seg_end;
    }
  }
};

}  // namespace jbig2

extern "C" {

const char *jbig2_last_error() { return jbig2::g_error.c_str(); }

// Decode a PDF-embedded JBIG2 stream (optionally with a JBIG2Globals
// prefix) into out[width*height], one byte per pixel, 1 = black.
// Returns 0 on success, -1 on failure (see jbig2_last_error).
int jbig2_decode(const uint8_t *globals, long nglobals, const uint8_t *data,
                 long ndata, int width, int height, uint8_t *out) {
  try {
    jbig2::Decoder dec;
    if (globals && nglobals > 0) dec.run(globals, nglobals);
    dec.run(data, ndata);
    if (!dec.page_started) jbig2::fail("stream contains no page regions");
    // Conform to the declared Width/Height: crop, pad with the page default.
    for (int y = 0; y < height; y++) {
      for (int x = 0; x < width; x++) {
        out[(size_t)y * width + x] =
            (x < dec.page.w && y < dec.page.h)
                ? dec.page.px[(size_t)y * dec.page.w + x]
                : dec.page_def_pixel;
      }
    }
    return 0;
  } catch (const jbig2::Error &e) {
    jbig2::g_error = e.msg;
    return -1;
  } catch (...) {
    jbig2::g_error = "unexpected decoder failure";
    return -1;
  }
}

}  // extern "C"
