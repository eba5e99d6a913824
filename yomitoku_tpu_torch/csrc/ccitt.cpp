// CCITT Group 3 / Group 4 (ITU-T T.4 / T.6) fax decoder for the built-in
// PDF rasterizer.  The reference renders scanned (fax-encoded) PDF pages via
// pdfium's C++ decoder (through pypdfium2); this is a from-scratch
// equivalent, the port's copy of yomitoku_tpu/native/ccitt.cpp, exposed to
// Python via ctypes (see native/__init__.py:ccitt_decode).
//
// Supports:
//   * K < 0  — Group 4 (pure 2-D MMR, the dominant encoding in PDF scans)
//   * K == 0 — Group 3 1-D (MH), with or without per-row EOL codes
//   * K > 0  — Group 3 mixed 1-D/2-D (EOL + tag bit per row)
//   * EncodedByteAlign, Rows/Columns, EOFB/RTC termination, zero-fill
//
// Output is one byte per pixel, 1 = black.  BlackIs1 / Decode / ImageMask
// semantics are applied by the Python caller (data/pdf/render.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t *d;
  long nbits;
  long pos;
  BitReader(const uint8_t *d, long n) : d(d), nbits(n * 8), pos(0) {}
  inline long left() const { return nbits - pos; }
  // Peek k (<= 24) bits, zero-padded past the end of data.
  inline uint32_t peek(int k) const {
    long byte = pos >> 3;
    int off = (int)(pos & 7);
    long nb = nbits >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; i++)
      v = (v << 8) | (byte + i < nb ? d[byte + i] : 0);
    return (uint32_t)((v >> (40 - off - k)) & ((1u << k) - 1));
  }
  inline void skip(int k) { pos += k; }
  inline void align() { pos = (pos + 7) & ~7L; }
};

struct Code {
  short run;
  unsigned char len;
  unsigned short bits;
};

// ITU-T T.4 modified-Huffman run-length tables.
static const Code WHITE[] = {
    {0, 8, 0x35},    {1, 6, 0x07},    {2, 4, 0x07},    {3, 4, 0x08},
    {4, 4, 0x0B},    {5, 4, 0x0C},    {6, 4, 0x0E},    {7, 4, 0x0F},
    {8, 5, 0x13},    {9, 5, 0x14},    {10, 5, 0x07},   {11, 5, 0x08},
    {12, 6, 0x08},   {13, 6, 0x03},   {14, 6, 0x34},   {15, 6, 0x35},
    {16, 6, 0x2A},   {17, 6, 0x2B},   {18, 7, 0x27},   {19, 7, 0x0C},
    {20, 7, 0x08},   {21, 7, 0x17},   {22, 7, 0x03},   {23, 7, 0x04},
    {24, 7, 0x28},   {25, 7, 0x2B},   {26, 7, 0x13},   {27, 7, 0x24},
    {28, 7, 0x18},   {29, 8, 0x02},   {30, 8, 0x03},   {31, 8, 0x1A},
    {32, 8, 0x1B},   {33, 8, 0x12},   {34, 8, 0x13},   {35, 8, 0x14},
    {36, 8, 0x15},   {37, 8, 0x16},   {38, 8, 0x17},   {39, 8, 0x28},
    {40, 8, 0x29},   {41, 8, 0x2A},   {42, 8, 0x2B},   {43, 8, 0x2C},
    {44, 8, 0x2D},   {45, 8, 0x04},   {46, 8, 0x05},   {47, 8, 0x0A},
    {48, 8, 0x0B},   {49, 8, 0x52},   {50, 8, 0x53},   {51, 8, 0x54},
    {52, 8, 0x55},   {53, 8, 0x24},   {54, 8, 0x25},   {55, 8, 0x58},
    {56, 8, 0x59},   {57, 8, 0x5A},   {58, 8, 0x5B},   {59, 8, 0x4A},
    {60, 8, 0x4B},   {61, 8, 0x32},   {62, 8, 0x33},   {63, 8, 0x34},
    // make-up codes
    {64, 5, 0x1B},   {128, 5, 0x12},  {192, 6, 0x17},  {256, 7, 0x37},
    {320, 8, 0x36},  {384, 8, 0x37},  {448, 8, 0x64},  {512, 8, 0x65},
    {576, 8, 0x68},  {640, 8, 0x67},  {704, 9, 0xCC},  {768, 9, 0xCD},
    {832, 9, 0xD2},  {896, 9, 0xD3},  {960, 9, 0xD4},  {1024, 9, 0xD5},
    {1088, 9, 0xD6}, {1152, 9, 0xD7}, {1216, 9, 0xD8}, {1280, 9, 0xD9},
    {1344, 9, 0xDA}, {1408, 9, 0xDB}, {1472, 9, 0x98}, {1536, 9, 0x99},
    {1600, 9, 0x9A}, {1664, 6, 0x18}, {1728, 9, 0x9B},
};

static const Code BLACK[] = {
    {0, 10, 0x37},   {1, 3, 0x02},    {2, 2, 0x03},    {3, 2, 0x02},
    {4, 3, 0x03},    {5, 4, 0x03},    {6, 4, 0x02},    {7, 5, 0x03},
    {8, 6, 0x05},    {9, 6, 0x04},    {10, 7, 0x04},   {11, 7, 0x05},
    {12, 7, 0x07},   {13, 8, 0x04},   {14, 8, 0x07},   {15, 9, 0x18},
    {16, 10, 0x17},  {17, 10, 0x18},  {18, 10, 0x08},  {19, 11, 0x67},
    {20, 11, 0x68},  {21, 11, 0x6C},  {22, 11, 0x37},  {23, 11, 0x28},
    {24, 11, 0x17},  {25, 11, 0x18},  {26, 12, 0xCA},  {27, 12, 0xCB},
    {28, 12, 0xCC},  {29, 12, 0xCD},  {30, 12, 0x68},  {31, 12, 0x69},
    {32, 12, 0x6A},  {33, 12, 0x6B},  {34, 12, 0xD2},  {35, 12, 0xD3},
    {36, 12, 0xD4},  {37, 12, 0xD5},  {38, 12, 0xD6},  {39, 12, 0xD7},
    {40, 12, 0x6C},  {41, 12, 0x6D},  {42, 12, 0xDA},  {43, 12, 0xDB},
    {44, 12, 0x54},  {45, 12, 0x55},  {46, 12, 0x56},  {47, 12, 0x57},
    {48, 12, 0x64},  {49, 12, 0x65},  {50, 12, 0x52},  {51, 12, 0x53},
    {52, 12, 0x24},  {53, 12, 0x37},  {54, 12, 0x38},  {55, 12, 0x27},
    {56, 12, 0x28},  {57, 12, 0x58},  {58, 12, 0x59},  {59, 12, 0x2B},
    {60, 12, 0x2C},  {61, 12, 0x5A},  {62, 12, 0x66},  {63, 12, 0x67},
    // make-up codes
    {64, 10, 0x0F},  {128, 12, 0xC8}, {192, 12, 0xC9}, {256, 12, 0x5B},
    {320, 12, 0x33}, {384, 12, 0x34}, {448, 12, 0x35}, {512, 13, 0x6C},
    {576, 13, 0x6D}, {640, 13, 0x4A}, {704, 13, 0x4B}, {768, 13, 0x4C},
    {832, 13, 0x4D}, {896, 13, 0x72}, {960, 13, 0x73}, {1024, 13, 0x74},
    {1088, 13, 0x75},{1152, 13, 0x76},{1216, 13, 0x77},{1280, 13, 0x52},
    {1344, 13, 0x53},{1408, 13, 0x54},{1472, 13, 0x55},{1536, 13, 0x5A},
    {1600, 13, 0x5B},{1664, 13, 0x64},{1728, 13, 0x65},
};

// Extended make-up codes, shared by both colours.
static const Code EXT[] = {
    {1792, 11, 0x08}, {1856, 11, 0x0C}, {1920, 11, 0x0D}, {1984, 12, 0x12},
    {2048, 12, 0x13}, {2112, 12, 0x14}, {2176, 12, 0x15}, {2240, 12, 0x16},
    {2304, 12, 0x17}, {2368, 12, 0x1C}, {2432, 12, 0x1D}, {2496, 12, 0x1E},
    {2560, 12, 0x1F},
};

// 13-bit direct lookup: entry = (run << 8) | code_len, -1 = invalid.
static int wlut[8192], blut[8192];
static bool tables_ready = false;

static void fill_lut(const Code *t, int n, int *lut) {
  for (int i = 0; i < n; i++) {
    int shift = 13 - t[i].len;
    uint32_t base = (uint32_t)t[i].bits << shift;
    for (uint32_t j = 0; j < (1u << shift); j++)
      lut[base | j] = (t[i].run << 8) | t[i].len;
  }
}

static void init_tables() {
  if (tables_ready) return;
  for (int i = 0; i < 8192; i++) wlut[i] = blut[i] = -1;
  fill_lut(WHITE, sizeof(WHITE) / sizeof(Code), wlut);
  fill_lut(BLACK, sizeof(BLACK) / sizeof(Code), blut);
  fill_lut(EXT, sizeof(EXT) / sizeof(Code), wlut);
  fill_lut(EXT, sizeof(EXT) / sizeof(Code), blut);
  tables_ready = true;
}

// Decode one complete run (make-up codes + terminating code).
// Returns run length >= 0, or -1 on an invalid code / exhausted data.
static int decode_run(BitReader &br, int color) {
  int total = 0;
  for (;;) {
    if (br.left() <= 0) return -1;
    int e = (color ? blut : wlut)[br.peek(13)];
    if (e < 0) return -1;
    int len = e & 0xFF;
    if (br.left() < len) return -1;
    br.skip(len);
    total += e >> 8;
    if ((e >> 8) < 64) return total;  // terminating code
  }
}

// EOL = eleven 0s then a 1.  Valid MH/mode codes never have 11 leading 0s.
static inline bool at_eol(const BitReader &br) {
  return br.left() >= 12 && br.peek(12) == 1;
}

// Decode a 1-D (MH) row into a transition list (positions where the colour
// flips, alternating white->black / black->white from a white row start).
// Returns the number of transitions, or -1 on error.
static int decode_1d_row(BitReader &br, int *cur, int columns) {
  int pos = 0, color = 0, nc = 0;
  while (pos < columns) {
    int run = decode_run(br, color);
    if (run < 0) return -1;
    pos += run;
    if (pos > columns) pos = columns;
    if (nc >= 2 * columns + 4) return -1;
    cur[nc++] = pos;
    color ^= 1;
  }
  return nc;
}

// Decode a 2-D (MR/MMR) row against the reference transition list.
// ref has nref transitions followed by >=2 sentinel entries == columns.
static int decode_2d_row(BitReader &br, const int *ref, int nref, int *cur,
                         int columns) {
  int a0 = -1, color = 0, nc = 0, ri = 0;
  while (a0 < columns) {
    if (br.left() <= 0) return -1;
    // b1: first reference transition > a0 whose parity matches the current
    // colour (even index = white->black).  a0 is monotonic but a vertical
    // move can land left of the last b1, so allow a small rewind.
    while (ri > 0 && ref[ri - 1] > a0) ri--;
    while (ri < nref + 2 && (ref[ri] <= a0 || ((ri & 1) != color))) ri++;
    int b1 = ri < nref ? ref[ri] : columns;
    int b2 = ri + 1 < nref ? ref[ri + 1] : columns;

    uint32_t v = br.peek(7);
    int a1;
    if (v >> 6) {  // 1: V(0)
      br.skip(1);
      a1 = b1;
    } else if ((v >> 4) == 3) {  // 011: VR(1)
      br.skip(3);
      a1 = b1 + 1;
    } else if ((v >> 4) == 2) {  // 010: VL(1)
      br.skip(3);
      a1 = b1 - 1;
    } else if ((v >> 4) == 1) {  // 001: horizontal
      br.skip(3);
      int r1 = decode_run(br, color);
      int r2 = decode_run(br, color ^ 1);
      if (r1 < 0 || r2 < 0) return -1;
      int s = a0 < 0 ? 0 : a0;
      int p1 = s + r1, p2 = s + r1 + r2;
      if (p1 > columns) p1 = columns;
      if (p2 > columns) p2 = columns;
      if (p2 <= a0 && a0 >= 0) return -1;  // no progress: corrupt stream
      if (nc + 2 > 2 * columns + 4) return -1;
      cur[nc++] = p1;
      cur[nc++] = p2;
      a0 = p2;  // colour unchanged
      continue;
    } else if ((v >> 3) == 1) {  // 0001: pass
      br.skip(4);
      a0 = b2;  // colour unchanged, no transition emitted
      continue;
    } else if ((v >> 1) == 3) {  // 000011: VR(2)
      br.skip(6);
      a1 = b1 + 2;
    } else if ((v >> 1) == 2) {  // 000010: VL(2)
      br.skip(6);
      a1 = b1 - 2;
    } else if (v == 3) {  // 0000011: VR(3)
      br.skip(7);
      a1 = b1 + 3;
    } else if (v == 2) {  // 0000010: VL(3)
      br.skip(7);
      a1 = b1 - 3;
    } else {
      return -1;  // EOL or invalid code: row ends
    }
    if (a1 < 0) a1 = 0;
    if (a1 > columns) a1 = columns;
    if (a1 <= a0) return -1;  // vertical moves must advance
    if (nc >= 2 * columns + 4) return -1;
    cur[nc++] = a1;
    a0 = a1;
    color ^= 1;
  }
  return nc;
}

static void paint_row(uint8_t *row, const int *cur, int nc, int columns) {
  memset(row, 0, columns);
  for (int i = 0; i + 1 < nc; i += 2) {
    int s = cur[i], e = cur[i + 1];
    if (s < 0) s = 0;
    if (e > columns) e = columns;
    if (e > s) memset(row + s, 1, e - s);
  }
  if (nc & 1) {  // trailing black run to end of row
    int s = cur[nc - 1];
    if (s < 0) s = 0;
    if (s < columns) memset(row + s, 1, columns - s);
  }
}

}  // namespace

extern "C" {

// Decode CCITT fax data into out (max_rows * columns bytes, 1 = black).
//   k < 0: Group 4; k == 0: Group 3 1-D; k > 0: Group 3 mixed 1-D/2-D.
// Returns the number of rows decoded (stops early on EOFB/RTC or a corrupt
// stream), or -1 on invalid arguments.
int ccitt_decode(const uint8_t *data, long n, int columns, int k,
                 int byte_align, uint8_t *out, int max_rows) {
  if (columns <= 0 || columns > 1 << 20 || max_rows < 0) return -1;
  init_tables();
  BitReader br(data, n);
  std::vector<int> refv(2 * columns + 8, columns), curv(2 * columns + 8, columns);
  int *ref = refv.data(), *cur = curv.data();
  int nref = 0;  // imaginary all-white reference line above the first row
  int r = 0;
  bool row_is_1d = (k >= 0);
  while (r < max_rows) {
    if (byte_align) br.align();
    if (br.left() < 1) break;
    // Consume zero-fill and EOL codes.  Two consecutive EOLs (EOFB / RTC)
    // end the image.  For K > 0 an EOL is followed by a 1-D/2-D tag bit.
    int eols = 0;
    for (;;) {
      if (at_eol(br)) {
        br.skip(12);
        eols++;
        if (k > 0 && br.left() >= 1 && eols == 1) {
          row_is_1d = br.peek(1) != 0;
          br.skip(1);
        }
        if (eols >= 2) break;
      } else if (br.left() >= 12 && br.peek(12) == 0) {
        br.skip(1);  // zero fill before an EOL
      } else {
        break;
      }
    }
    if (eols >= 2 || br.left() < 1) break;
    if (k == 0) row_is_1d = true;
    int nc = row_is_1d ? decode_1d_row(br, cur, columns)
                       : decode_2d_row(br, ref, nref, cur, columns);
    if (nc < 0) break;  // corrupt tail: return the rows decoded so far
    paint_row(out + (long)r * columns, cur, nc, columns);
    // The decoded row becomes the reference line; pad sentinels.
    if (nc & 1) cur[nc++] = columns;  // keep transition parity even
    cur[nc] = columns;
    cur[nc + 1] = columns;
    int *t = ref;
    ref = cur;
    cur = t;
    nref = nc;
    if (k < 0) row_is_1d = false;
    r++;
  }
  return r;
}
}
