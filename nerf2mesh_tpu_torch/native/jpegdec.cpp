// JPEG decoder with the output of libjpeg-turbo's default decompression,
// which Pillow's Image.open(...) gives, for every file libjpeg-turbo 3 and
// Pillow read:
//   * 8-bit samples, 1 (grey), 3 or 4 components, restart intervals
//     (DRI / RSTn);
//   * Huffman entropy coding: baseline and extended sequential scans (any
//     number, interleaved or not) and progressive ones (jdphuff.c): DC
//     first and refine scans, AC first scans with their end-of-band runs
//     and AC refine scans with their correction bits;
//   * arithmetic entropy coding (SOF9 sequential, SOF10 progressive): the QM
//     decoder of ITU T.81 Annex D as jdarith.c runs it, with the DAC
//     segment's conditioning values (defaults DC L=0 U=1, AC Kx=5), the
//     statistics bins reset at each scan and restart marker, zero data
//     after a marker, and the four progressive scan kinds, whose AC refine
//     codes its correction bits through their own bins;
//   * every scan fills a coefficient buffer, and the blocks are transformed
//     once the file is read (no block smoothing: libjpeg smooths only blocks
//     whose coefficients some scan left incomplete), by the integer "islow"
//     IDCT (jidctint.c) with its range-limit table;
//   * lossless files (SOF3, jdlossls.c / jddiffct.c / jdlhuff.c): Huffman
//     coded differences, predictors 1-7, the point transform, restarts at
//     the start of a row of MCUs (libjpeg-turbo refuses other intervals);
//     grey, RGB (a 3-component file without markers is RGB there) and
//     CMYK: libjpeg-turbo converts no colours in a lossless file;
//   * upsampling as jdsample.c chooses it per component: "fancy" triangle
//     filters for 2h1v, 1h2v (libjpeg-turbo's own) and 2h2v, plain
//     replication for 2h1v / 2h2v planes 2 samples wide or less and for
//     every other integral ratio (int_upsample, e.g. 4:1:1), and
//     replication throughout in a lossless file (libjpeg-turbo's fancy
//     filters need DCT blocks); a non-integral ratio is refused, as libjpeg
//     refuses it;
//   * the fixed-point YCbCr -> RGB of jdcolor.c (16 fraction bits), chosen
//     as jdapimin.c's default_decompress_parms chooses it (a JFIF marker,
//     then the Adobe transform, then the component ids); no conversion for
//     RGB files; CMYK comes out inverted, as Pillow reads it ("CMYK;I"), and
//     YCCK (Adobe transform 2, 4 components) through ycck_cmyk_convert
//     then the same inversion.
// What Pillow or libjpeg-turbo refuses is refused with code 2: 12- and
// 16-bit precision (Pillow reads 8-bit layers only), hierarchical frames
// (SOF5-7, SOF13-15), arithmetic-coded lossless files (SOF11: libjpeg-turbo
// has no such decoder), lossless YCbCr and YCCK, a height left to a DNL
// marker, 2 components, a non-integral sampling ratio, more pixels than
// Image.open allows (its DecompressionBombError).
//
// C interface (ctypes):
//   int jpeg_decode_tables(const uint8_t *tables, int64_t ntables,
//                          const uint8_t *data, int64_t n, int colour,
//                          uint8_t *out, int64_t out_cap, int32_t *dims,
//                          char *err, int errlen)
// reads the tables-only stream `tables` (SOI, DQT/DHT/DAC/DRI, EOI; ntables
// 0 for none) before the stream `data`, as libtiff feeds a JPEG-compressed
// TIFF's abbreviated strips to libjpeg.  colour: 0 converts as the file's
// markers say (libjpeg's default), 1 not at all (JCS_UNKNOWN: the
// components as stored), 2 YCbCr -> RGB, 3 not at all and each component
// replicated to full size without the fancy filters (the raw planes of
// libjpeg's raw_data_out, as old-style JPEG TIFF reads them).  dims receives (height, width,
// channels).  With out == NULL only the headers are read (to size the
// output).  Returns 0, or an error code: 1 corrupt or not a JPEG, 2 a file
// Pillow does not read; err holds the message.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for corrupt data (jutils.c jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  int code;
  std::string msg;
};

struct Huff {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  uint8_t look_nbits[256];
  uint8_t look_sym[256];
};

// false when the counts do not make a prefix code (jdhuff.c's
// JERR_BAD_HUFF_TABLE); counts sum to at most 256
bool build_huff(Huff &h, const uint8_t *counts, const uint8_t *vals) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l - 1]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int numsymbols = p;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return false;
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      h.valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0x7FFFFFFF;  // ends the slow decode loop
  memset(h.huffval, 0, sizeof(h.huffval));
  memcpy(h.huffval, vals, numsymbols);
  memset(h.look_nbits, 0, sizeof(h.look_nbits));
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= counts[l - 1]; i++, p++) {
      int look = huffcode[p] << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; ctr--) {
        h.look_nbits[look] = (uint8_t)l;
        h.look_sym[look] = vals[p];
        look++;
      }
    }
  }
  h.defined = true;
  return true;
}

struct Component {
  int id, h, v, tq;
  int bw, bh;        // data units across and down (the MCU-padded plane):
                     // 8x8 blocks, or samples in a lossless file
  int dw, dh;        // samples of the downsampled plane that are real
  int td, ta;        // the current scan's entropy tables
  int pred;          // DC predictor (the last DC value)
  int dc_context;    // arithmetic DC conditioning (jdarith.c dc_context)
  int stride;        // bytes a row of plane
  std::vector<int16_t> coef;   // bh*bw blocks of 64, natural order
  std::vector<int32_t> diff;   // lossless: bh*bw decoded differences
  std::vector<uint8_t> first;  // lossless: rows undifferenced as a first row
  std::vector<uint8_t> plane;  // the samples, rows of `stride` bytes
  int16_t *block(int bx, int by) {
    return coef.data() + ((size_t)by * bw + bx) * 64;
  }
};

struct BitReader {
  const uint8_t *data;
  int64_t n, pos;
  uint64_t buf = 0;
  int bits = 0;
  bool marker = false;  // a marker stopped the reads; zeros follow

  void fill() {
    while (bits <= 56) {
      int c = 0;
      if (!marker && pos < n) {
        c = data[pos];
        if (c == 0xFF) {
          int c2 = pos + 1 < n ? data[pos + 1] : 0xD9;
          if (c2 == 0x00) {
            pos += 2;
          } else {
            marker = true;
            c = 0;
          }
        } else {
          pos++;
        }
      }
      buf |= (uint64_t)c << (56 - bits);
      bits += 8;
    }
  }
  int peek(int k) {
    if (bits < k) fill();
    return (int)(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    bits -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  void reset() {
    buf = 0;
    bits = 0;
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + ((-1) * (1 << s)) + 1 : r;
}

inline int decode_huff(BitReader &br, const Huff &h) {
  if (br.bits < 16) br.fill();
  int look = (int)(br.buf >> 56);
  int nb = h.look_nbits[look];
  if (nb) {
    br.skip(nb);
    return h.look_sym[look];
  }
  int l = 9;
  int code = br.get(9);
  while (code > h.maxcode[l]) {
    code = (code << 1) | br.get(1);
    l++;
  }
  if (l > 16) return 0;  // corrupt data: libjpeg returns symbol 0
  return h.huffval[(code + h.valoffset[l]) & 0xFF];
}

uint8_t g_idct_limit[1024];
uint8_t g_limit[1024 + 512];  // clamp to 0..255 of x in [-512, 1023]

void init_tables() {
  static bool done = false;
  if (done) return;
  for (int i = 0; i < 1024; i++)
    g_idct_limit[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255
                                : i < 896 ? 0 : i - 896);
  for (int i = 0; i < 1024 + 512; i++) {
    int x = i - 512;
    g_limit[i] = (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
  }
  done = true;
}

// jidctint.c jpeg_idct_islow: coef in natural order, dequantized by q
void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out,
                int stride) {
  const int CONST_BITS = 13, PASS1_BITS = 2;
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                F1_961 = 16069, F2_053 = 16819, F2_562 = 20995,
                F3_072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *in = coef + c;
    const uint16_t *qq = q + c;
    int *w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (in[0] * (int)qq[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * (int)qq[16], z3 = in[48] * (int)qq[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * (-F1_847);
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = in[0] * (int)qq[0];
    z3 = in[32] * (int)qq[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * (int)qq[56];
    tmp1 = in[40] * (int)qq[40];
    tmp2 = in[24] * (int)qq[24];
    tmp3 = in[8] * (int)qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    const int64_t rnd = (int64_t)1 << (sh - 1);
    w[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
    w[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
    w[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
    w[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
    w[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
    w[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
    w[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
    w[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  const int64_t rnd = (int64_t)1 << (sh - 1);
  for (int r = 0; r < 8; r++) {
    const int *w = ws + 8 * r;
    uint8_t *o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = g_idct_limit[((w[0] + (1 << (PASS1_BITS + 2))) >>
                                (PASS1_BITS + 3)) & 1023];
      for (int k = 0; k < 8; k++) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * (-F1_847);
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = g_idct_limit[(int)((tmp10 + tmp3 + rnd) >> sh) & 1023];
    o[7] = g_idct_limit[(int)((tmp10 - tmp3 + rnd) >> sh) & 1023];
    o[1] = g_idct_limit[(int)((tmp11 + tmp2 + rnd) >> sh) & 1023];
    o[6] = g_idct_limit[(int)((tmp11 - tmp2 + rnd) >> sh) & 1023];
    o[2] = g_idct_limit[(int)((tmp12 + tmp1 + rnd) >> sh) & 1023];
    o[5] = g_idct_limit[(int)((tmp12 - tmp1 + rnd) >> sh) & 1023];
    o[3] = g_idct_limit[(int)((tmp13 + tmp0 + rnd) >> sh) & 1023];
    o[4] = g_idct_limit[(int)((tmp13 - tmp0 + rnd) >> sh) & 1023];
  }
}

// ITU T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
// of the sign and correction bits (T.851 Table 5).
#define QM(qe, lps, mps, sw) \
  (((int32_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int32_t kAritab[114] = {
    QM(0x5a1d, 1, 1, 1),     QM(0x2586, 14, 2, 0),    QM(0x1114, 16, 3, 0),
    QM(0x080b, 18, 4, 0),    QM(0x03d8, 20, 5, 0),    QM(0x01da, 23, 6, 0),
    QM(0x00e5, 25, 7, 0),    QM(0x006f, 28, 8, 0),    QM(0x0036, 30, 9, 0),
    QM(0x001a, 33, 10, 0),   QM(0x000d, 35, 11, 0),   QM(0x0006, 9, 12, 0),
    QM(0x0003, 10, 13, 0),   QM(0x0001, 12, 13, 0),   QM(0x5a7f, 15, 15, 1),
    QM(0x3f25, 36, 16, 0),   QM(0x2cf2, 38, 17, 0),   QM(0x207c, 39, 18, 0),
    QM(0x17b9, 40, 19, 0),   QM(0x1182, 42, 20, 0),   QM(0x0cef, 43, 21, 0),
    QM(0x09a1, 45, 22, 0),   QM(0x072f, 46, 23, 0),   QM(0x055c, 48, 24, 0),
    QM(0x0406, 49, 25, 0),   QM(0x0303, 51, 26, 0),   QM(0x0240, 52, 27, 0),
    QM(0x01b1, 54, 28, 0),   QM(0x0144, 56, 29, 0),   QM(0x00f5, 57, 30, 0),
    QM(0x00b7, 59, 31, 0),   QM(0x008a, 60, 32, 0),   QM(0x0068, 62, 33, 0),
    QM(0x004e, 63, 34, 0),   QM(0x003b, 32, 35, 0),   QM(0x002c, 33, 9, 0),
    QM(0x5ae1, 37, 37, 1),   QM(0x484c, 64, 38, 0),   QM(0x3a0d, 65, 39, 0),
    QM(0x2ef1, 67, 40, 0),   QM(0x261f, 68, 41, 0),   QM(0x1f33, 69, 42, 0),
    QM(0x19a8, 70, 43, 0),   QM(0x1518, 72, 44, 0),   QM(0x1177, 73, 45, 0),
    QM(0x0e74, 74, 46, 0),   QM(0x0bfb, 75, 47, 0),   QM(0x09f8, 77, 48, 0),
    QM(0x0861, 78, 49, 0),   QM(0x0706, 79, 50, 0),   QM(0x05cd, 48, 51, 0),
    QM(0x04de, 50, 52, 0),   QM(0x040f, 50, 53, 0),   QM(0x0363, 51, 54, 0),
    QM(0x02d4, 52, 55, 0),   QM(0x025c, 53, 56, 0),   QM(0x01f8, 54, 57, 0),
    QM(0x01a4, 55, 58, 0),   QM(0x0160, 56, 59, 0),   QM(0x0125, 57, 60, 0),
    QM(0x00f6, 58, 61, 0),   QM(0x00cb, 59, 62, 0),   QM(0x00ab, 61, 63, 0),
    QM(0x008f, 61, 32, 0),   QM(0x5b12, 65, 65, 1),   QM(0x4d04, 80, 66, 0),
    QM(0x412c, 81, 67, 0),   QM(0x37d8, 82, 68, 0),   QM(0x2fe8, 83, 69, 0),
    QM(0x293c, 84, 70, 0),   QM(0x2379, 86, 71, 0),   QM(0x1edf, 87, 72, 0),
    QM(0x1aa9, 87, 73, 0),   QM(0x174e, 72, 74, 0),   QM(0x1424, 72, 75, 0),
    QM(0x119c, 74, 76, 0),   QM(0x0f6b, 74, 77, 0),   QM(0x0d51, 75, 78, 0),
    QM(0x0bb6, 77, 79, 0),   QM(0x0a40, 77, 48, 0),   QM(0x5832, 80, 81, 1),
    QM(0x4d1c, 88, 82, 0),   QM(0x438e, 89, 83, 0),   QM(0x3bdd, 90, 84, 0),
    QM(0x34ee, 91, 85, 0),   QM(0x2eae, 92, 86, 0),   QM(0x299a, 93, 87, 0),
    QM(0x2516, 86, 71, 0),   QM(0x5570, 88, 89, 1),   QM(0x4ca9, 95, 90, 0),
    QM(0x44d9, 96, 91, 0),   QM(0x3e22, 97, 92, 0),   QM(0x3824, 99, 93, 0),
    QM(0x32b4, 99, 94, 0),   QM(0x2e17, 93, 86, 0),   QM(0x56a8, 95, 96, 1),
    QM(0x4f46, 101, 97, 0),  QM(0x47e5, 102, 98, 0),  QM(0x41cf, 103, 99, 0),
    QM(0x3c3d, 104, 100, 0), QM(0x375e, 99, 93, 0),   QM(0x5231, 105, 102, 0),
    QM(0x4c0f, 106, 103, 0), QM(0x4639, 107, 104, 0), QM(0x415e, 103, 99, 0),
    QM(0x5627, 105, 106, 1), QM(0x50e7, 108, 107, 0), QM(0x4b85, 109, 103, 0),
    QM(0x5597, 110, 109, 0), QM(0x504f, 111, 107, 0), QM(0x5a10, 110, 111, 1),
    QM(0x5522, 112, 109, 0), QM(0x59eb, 112, 111, 1), QM(0x5a1d, 113, 113, 0)};
#undef QM

// jdarith.c's register state and get_byte: a marker (or the end of the
// data) stops the reads, and zeros are decoded from then on; pos stays at
// the marker's first 0xFF.
struct ArithReader {
  const uint8_t *data;
  int64_t n, pos;
  bool marker = false;
  int64_t c = 0, a = 0;
  int ct = -16;       // -16: two bytes to read into C first
  bool bad = false;   // a code the stream cannot hold: skip to the restart

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
    bad = false;
  }
  int next_byte() {
    if (marker || pos >= n) {
      marker = true;
      return 0;
    }
    int d = data[pos];
    if (d != 0xFF) {
      pos++;
      return d;
    }
    int64_t p = pos + 1;
    while (p < n && data[p] == 0xFF) p++;  // fill bytes
    if (p < n && data[p] == 0) {           // a stuffed 0xFF
      pos = p + 1;
      return 0xFF;
    }
    marker = true;
    return 0;
  }
  // one binary decision with the statistics bin st (D.2.4-D.2.6)
  int decode(uint8_t *st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    int nl = qe & 0xFF;
    qe >>= 8;
    int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Decoder {
  const uint8_t *data;  // the stream being parsed
  int64_t n;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  uint8_t dac_l[16], dac_u[16], dac_k[16];  // arithmetic conditioning
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;
  std::vector<Component> comps;
  int H = 0, W = 0, hmax = 1, vmax = 1, restart = 0;
  bool adobe = false, jfif = false;
  int adobe_transform = -1;
  bool frame = false, progressive = false, arith = false, lossless = false;
  int ss = 0, se = 63, ah = 0, al = 0;  // the current scan's band and bits
  unsigned eobrun = 0;

  Decoder() {
    for (int i = 0; i < 16; i++) {  // jdmarker.c get_soi's defaults
      dac_l[i] = 0;
      dac_u[i] = 1;
      dac_k[i] = 5;
    }
  }

  void fail(int code, const std::string &msg) { throw Error{code, msg}; }

  int u16(int64_t p) {
    if (p + 1 >= n) fail(1, "truncated JPEG");
    return (data[p] << 8) | data[p + 1];
  }

  void read_frame(const uint8_t *b, int len) {
    if (len < 6) fail(1, "short SOF segment");
    if (b[0] != 8)
      fail(2, "JPEG with " + std::to_string(b[0]) +
                  "-bit samples (Pillow reads 8-bit layers only)");
    H = (b[1] << 8) | b[2];
    W = (b[3] << 8) | b[4];
    int nc = b[5];
    if (H == 0 || W == 0)
      fail(2, "JPEG whose height a DNL marker gives, or of zero size "
              "(libjpeg reads neither)");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(2, "JPEG with " + std::to_string(nc) +
                  " components (Pillow reads 1, 3 or 4)");
    if ((int64_t)W * H > 2 * 89478485)  // Image.open's DecompressionBombError
      fail(2, "JPEG of more pixels than Pillow opens");
    if (len < 6 + 3 * nc) fail(1, "short SOF segment");
    comps.resize(nc);
    hmax = vmax = 1;
    for (int c = 0; c < nc; c++) {
      Component &k = comps[c];
      k.id = b[6 + 3 * c];
      k.h = b[7 + 3 * c] >> 4;
      k.v = b[7 + 3 * c] & 15;
      k.tq = b[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        fail(1, "bad SOF component");
      hmax = k.h > hmax ? k.h : hmax;
      vmax = k.v > vmax ? k.v : vmax;
    }
    // data units: 8x8 blocks, or single samples in a lossless file
    int du = lossless ? 1 : 8;
    int mx = (W + du * hmax - 1) / (du * hmax);
    int my = (H + du * vmax - 1) / (du * vmax);
    for (Component &k : comps) {
      if (hmax % k.h || vmax % k.v)
        fail(2, "non-integral sampling ratio (libjpeg refuses it)");
      k.bw = mx * k.h;
      k.bh = my * k.v;
      k.dw = (W * k.h + hmax - 1) / hmax;
      k.dh = (H * k.v + vmax - 1) / vmax;
      if (lossless) {
        k.diff.assign((size_t)k.bw * k.bh, 0);
        k.first.assign(k.bh, 0);
        k.stride = k.bw;
        k.plane.assign((size_t)k.bw * k.bh, 0);
      } else {
        k.coef.assign((size_t)k.bw * k.bh * 64, 0);
      }
    }
    frame = true;
  }

  void decode_block(BitReader &br, Component &k, int bx, int by) {
    if (progressive) {
      decode_progressive(br, k, bx, by);
      return;
    }
    int16_t *coef = k.block(bx, by);
    memset(coef, 0, 64 * sizeof(int16_t));
    const Huff &dct = dc[k.td], &act = ac[k.ta];
    int s = decode_huff(br, dct);
    if (s) {
      int r = br.get(s);
      s = extend(r, s);
    }
    k.pred += s;
    coef[0] = (int16_t)k.pred;
    for (int kk = 1; kk < 64; kk++) {
      s = decode_huff(br, act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        kk += r;
        int v = br.get(s);
        coef[kNatural[kk]] = (int16_t)extend(v, s);
      } else {
        if (r != 15) break;
        kk += 15;
      }
    }
  }

  // jdphuff.c: decode_mcu_DC_first / DC_refine / AC_first / AC_refine
  void decode_progressive(BitReader &br, Component &k, int bx, int by) {
    int16_t *coef = k.block(bx, by);
    if (ss == 0) {
      if (ah == 0) {
        int s = decode_huff(br, dc[k.td]);
        if (s) s = extend(br.get(s), s);
        k.pred += s;
        coef[0] = (int16_t)(k.pred * (1 << al));
      } else if (br.get(1)) {
        coef[0] = (int16_t)(coef[0] | (1 << al));
      }
      return;
    }
    const Huff &act = ac[k.ta];
    if (ah == 0) {
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int kk = ss; kk <= se; kk++) {
        int s = decode_huff(br, act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          kk += r;
          s = extend(br.get(s), s);
          coef[kNatural[kk]] = (int16_t)(s * (1 << al));
        } else if (r == 15) {
          kk += 15;
        } else {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
      return;
    }
    const int p1 = 1 << al, m1 = -(1 << al);
    int kk = ss;
    auto correct = [&](int16_t *c) {
      if (br.get(1) && (*c & p1) == 0) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; kk <= se; kk++) {
        int s = decode_huff(br, act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a newly nonzero coefficient is +-1
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          break;  // the rest of the band is the end-of-band logic's
        }
        do {  // over nonzero coefficients and r zero ones
          int16_t *c = coef + kNatural[kk];
          if (*c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          kk++;
        } while (kk <= se);
        if (s) coef[kNatural[kk]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; kk <= se; kk++) {
        int16_t *c = coef + kNatural[kk];
        if (*c != 0) correct(c);
      }
      eobrun--;
    }
  }

  // jdarith.c, Figures F.19-F.24: one DC difference (0 and ar.bad set on
  // a magnitude overflow)
  int arith_dc_diff(ArithReader &ar, Component &k) {
    int tbl = k.td;
    uint8_t *st = dc_stats[tbl] + k.dc_context;
    if (ar.decode(st) == 0) {
      k.dc_context = 0;
      return 0;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;  // X1
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.bad = true;
          return 0;
        }
        st++;
      }
    }
    if (m < (int)((1L << dac_l[tbl]) >> 1))
      k.dc_context = 0;  // zero difference category
    else if (m > (int)((1L << dac_u[tbl]) >> 1))
      k.dc_context = 12 + sign * 4;  // large
    else
      k.dc_context = 4 + sign * 4;  // small
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // the magnitude of a nonzero AC coefficient at zigzag index kk, its
  // statistics at st (Figures F.21-F.24 as decode_mcu_AC_first runs them)
  int arith_ac_value(ArithReader &ar, int tbl, int kk, uint8_t *st) {
    int sign = ar.decode(&fixed_bin);
    st += 2;
    int m = ar.decode(st);
    if (m && ar.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (kk <= dac_k[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.bad = true;
          return 0;
        }
        st++;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // jdarith.c decode_mcu: one block of a sequential scan
  void arith_sequential(ArithReader &ar, Component &k, int bx, int by) {
    if (ar.bad) return;
    int16_t *coef = k.block(bx, by);
    memset(coef, 0, 64 * sizeof(int16_t));
    int v = arith_dc_diff(ar, k);
    if (ar.bad) return;
    k.pred += v;
    coef[0] = (int16_t)k.pred;
    int tbl = k.ta, kk = 0;
    do {
      uint8_t *st = ac_stats[tbl] + 3 * kk;
      if (ar.decode(st)) break;  // end of block
      for (;;) {
        kk++;
        if (ar.decode(st + 1)) break;
        st += 3;
        if (kk >= 63) {
          ar.bad = true;  // spectral overflow
          return;
        }
      }
      v = arith_ac_value(ar, tbl, kk, st);
      if (ar.bad) return;
      coef[kNatural[kk]] = (int16_t)v;
    } while (kk < 63);
  }

  // jdarith.c decode_mcu_DC_first / DC_refine / AC_first / AC_refine
  void arith_progressive(ArithReader &ar, Component &k, int bx, int by) {
    if (ar.bad) return;
    int16_t *coef = k.block(bx, by);
    if (ss == 0) {
      if (ah == 0) {
        int v = arith_dc_diff(ar, k);
        if (ar.bad) return;
        k.pred += v;
        coef[0] = (int16_t)(k.pred * (1 << al));
      } else if (ar.decode(&fixed_bin)) {
        coef[0] = (int16_t)(coef[0] | (1 << al));
      }
      return;
    }
    int tbl = k.ta;
    if (ah == 0) {
      for (int kk = ss; kk <= se; kk++) {
        uint8_t *st = ac_stats[tbl] + 3 * (kk - 1);
        if (ar.decode(st)) break;  // end of band
        while (ar.decode(st + 1) == 0) {
          st += 3;
          if (++kk > se) {
            ar.bad = true;
            return;
          }
        }
        int v = arith_ac_value(ar, tbl, kk, st);
        if (ar.bad) return;
        coef[kNatural[kk]] = (int16_t)((unsigned)v << al);
      }
      return;
    }
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (coef[kNatural[kex]]) break;
    for (int kk = ss; kk <= se; kk++) {
      uint8_t *st = ac_stats[tbl] + 3 * (kk - 1);
      if (kk > kex && ar.decode(st)) break;
      for (;;) {
        int16_t *c = coef + kNatural[kk];
        if (*c) {  // a correction bit through its own bin
          if (ar.decode(st + 2)) *c = (int16_t)(*c + (*c < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          *c = (int16_t)(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++kk > se) {
          ar.bad = true;
          return;
        }
      }
    }
  }

  // the bins a scan (or a restart interval) starts from (start_pass)
  void reset_stats(std::vector<Component *> &sc) {
    for (Component *k : sc) {
      if (!progressive || (ss == 0 && ah == 0)) {
        memset(dc_stats[k->td], 0, sizeof(dc_stats[0]));
        k->pred = 0;
        k->dc_context = 0;
      }
      if (!progressive || ss) memset(ac_stats[k->ta], 0, sizeof(ac_stats[0]));
    }
  }

  // the position after the RSTn marker at or after p
  int64_t skip_restart(int64_t p) {
    while (p + 1 < n && !(data[p] == 0xFF && data[p + 1] >= 0xD0 &&
                          data[p + 1] <= 0xD7))
      p++;
    return p + 2 <= n ? p + 2 : n;
  }

  // the MCUs of a scan of the components sc: block(k, x, y) for each data
  // unit, on_restart() where a restart interval ends
  template <class Block, class Restart>
  void mcus(std::vector<Component *> &sc, int du, Block block,
            Restart on_restart) {
    int64_t mcus_x, mcus_y;
    if (sc.size() == 1) {
      mcus_x = (sc[0]->dw + du - 1) / du;
      mcus_y = (sc[0]->dh + du - 1) / du;
    } else {
      mcus_x = (W + du * hmax - 1) / (du * hmax);
      mcus_y = (H + du * vmax - 1) / (du * vmax);
    }
    int64_t total = mcus_x * mcus_y, left = restart;
    for (int64_t m = 0; m < total; m++) {
      if (restart && left == 0) {
        on_restart(m / mcus_x);
        left = restart;
      }
      int64_t mx = m % mcus_x, my = m / mcus_x;
      if (sc.size() == 1) {
        block(*sc[0], (int)mx, (int)my);
      } else {
        for (Component *k : sc)
          for (int yy = 0; yy < k->v; yy++)
            for (int xx = 0; xx < k->h; xx++)
              block(*k, (int)(mx * k->h + xx), (int)(my * k->v + yy));
      }
      if (restart) left--;
    }
  }

  // jddiffct.c / jdpred.c: a lossless component's differences to samples,
  // row by row; a row after a restart (and the first) is predicted as a
  // first row
  void undifference(Component &k, int psv) {
    const int init = 1 << (8 - al - 1);
    std::vector<int> prev(k.dw), cur(k.dw);
    for (int r = 0; r < k.dh; r++) {
      const int32_t *d = &k.diff[(size_t)r * k.bw];
      if (k.first[r]) {
        int ra = (d[0] + init) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < k.dw; x++) cur[x] = ra = (d[x] + ra) & 0xFFFF;
      } else {
        int ra = (d[0] + prev[0]) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < k.dw; x++) {
          int rb = prev[x], rc = prev[x - 1], p;
          switch (psv) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (d[x] + p) & 0xFFFF;
        }
      }
      uint8_t *o = &k.plane[(size_t)r * k.stride];
      for (int x = 0; x < k.dw; x++) o[x] = (uint8_t)(cur[x] << al);
      prev.swap(cur);
    }
  }

  // a lossless scan (jdlhuff.c decode_mcus, then the undifferencing)
  int64_t scan_lossless(std::vector<Component *> &sc, int64_t pos) {
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7)
      fail(1, "bad lossless scan parameters");
    for (Component *k : sc) {
      if (k->td > 3 || !dc[k->td].defined)
        fail(1, "SOS names an undefined Huffman table");
      std::fill(k->first.begin(), k->first.end(), 0);
      k->first[0] = 1;
    }
    int64_t mcus_x = sc.size() == 1 ? sc[0]->dw : (W + hmax - 1) / hmax;
    if (restart && restart % mcus_x)
      fail(2, "lossless JPEG whose restart interval is not a whole number "
              "of MCU rows (libjpeg-turbo refuses it)");
    BitReader br{data, n, pos};
    auto block = [&](Component &k, int x, int y) {
      int s = decode_huff(br, dc[k.td]), d = 0;
      if (s == 16) {
        d = 32768;
      } else if (s > 16) {
        fail(1, "bad lossless difference category");
      } else if (s) {
        d = extend(br.get(s), s);
      }
      k.diff[(size_t)y * k.bw + x] = d;
    };
    auto on_restart = [&](int64_t my) {
      br.reset();
      br.pos = skip_restart(br.pos);
      br.marker = false;
      // the next undifferenced row group starts as a first row (the
      // predictor is reset for the iMCU row the restart falls in)
      for (Component *k : sc) {
        int64_t r = sc.size() == 1 ? my / k->v * k->v : my * k->v;
        if (r < k->bh) k->first[r] = 1;
      }
    };
    mcus(sc, 1, block, on_restart);
    for (Component *k : sc) undifference(*k, ss);
    return br.pos;
  }

  // every block of every component through the IDCT into its plane
  void transform() {
    for (Component &k : comps) {
      k.stride = k.bw * 8;
      k.plane.assign((size_t)k.stride * k.bh * 8, 0);
      for (int by = 0; by < k.bh; by++)
        for (int bx = 0; bx < k.bw; bx++)
          idct_islow(k.block(bx, by), qt[k.tq],
                     k.plane.data() + (size_t)by * 8 * k.stride + bx * 8,
                     k.stride);
      std::vector<int16_t>().swap(k.coef);
    }
  }

  // one scan; returns the position after its entropy-coded data
  int64_t scan(const uint8_t *b, int len, int64_t pos) {
    int ns = b[0];
    if (ns < 1 || ns > 4 || len < 1 + 2 * ns + 3) fail(1, "bad SOS segment");
    std::vector<Component *> sc;
    int blocks = 0;
    for (int i = 0; i < ns; i++) {
      int cid = b[1 + 2 * i], t = b[2 + 2 * i];
      Component *found = nullptr;
      for (Component &k : comps)
        if (k.id == cid) found = &k;
      if (!found) fail(1, "SOS names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      found->pred = 0;
      found->dc_context = 0;
      sc.push_back(found);
      blocks += found->h * found->v;
    }
    if (ns > 1 && blocks > 10) fail(1, "more than 10 data units an MCU");
    ss = b[1 + 2 * ns];
    se = b[2 + 2 * ns];
    ah = b[3 + 2 * ns] >> 4;
    al = b[3 + 2 * ns] & 15;
    eobrun = 0;
    int64_t end;
    if (lossless) {
      end = scan_lossless(sc, pos);
    } else {
      if (!progressive) {
        if (ss != 0 || se != 63 || ah != 0 || al != 0)
          fail(1, "sequential scan with spectral selection or approximation");
      } else if (se > 63 || ss > se || al > 13 || (ss == 0 && se != 0) ||
                 (ss > 0 && ns != 1)) {
        fail(1, "bad progressive scan parameters");
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      for (Component *k : sc) {
        if (!arith && ((need_dc && (k->td > 3 || !dc[k->td].defined)) ||
                       (need_ac && (k->ta > 3 || !ac[k->ta].defined))))
          fail(1, "SOS names an undefined Huffman table");
        if (!qt_defined[k->tq]) fail(1, "undefined quantization table");
      }
      if (arith) {
        ArithReader ar{data, n, pos};
        reset_stats(sc);
        auto on_restart = [&](int64_t) {
          ar.pos = skip_restart(ar.pos);
          ar.marker = false;
          reset_stats(sc);
          ar.reset();
        };
        if (progressive)
          mcus(sc, 8, [&](Component &k, int x, int y) {
            arith_progressive(ar, k, x, y);
          }, on_restart);
        else
          mcus(sc, 8, [&](Component &k, int x, int y) {
            arith_sequential(ar, k, x, y);
          }, on_restart);
        end = ar.pos;
      } else {
        BitReader br{data, n, pos};
        auto on_restart = [&](int64_t) {
          // discard the buffered bits, find and skip the RSTn marker
          br.reset();
          br.pos = skip_restart(br.pos);
          br.marker = false;
          for (Component *k : sc) k->pred = 0;
          eobrun = 0;
        };
        mcus(sc, 8, [&](Component &k, int x, int y) {
          decode_block(br, k, x, y);
        }, on_restart);
        end = br.pos;
      }
    }
    // the next marker after the scan's data
    int64_t p = end;
    while (p + 1 < n && !(data[p] == 0xFF && data[p + 1] != 0x00 &&
                          !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
      p++;
    return p;
  }

  // a stream's markers; tables_only: a tables-only (abbreviated) stream,
  // which ends at its EOI without a frame
  void parse(const uint8_t *stream, int64_t len_, bool headers_only,
             bool tables_only) {
    data = stream;
    n = len_;
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail(1, "not a JPEG (no SOI)");
    int64_t pos = 2;
    bool scanned = false;
    while (true) {
      while (pos < n && data[pos] != 0xFF) pos++;  // tolerate junk
      while (pos < n && data[pos] == 0xFF) pos++;  // fill bytes
      if (pos >= n) {
        if (scanned || tables_only) return;
        fail(1, "truncated JPEG (no scan)");
      }
      int m = data[pos++];
      if (m == 0xD9) {
        if (!scanned && !tables_only) fail(1, "JPEG without a scan");
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;
      int len = u16(pos);
      if (len < 2 || pos + len > n) fail(1, "truncated JPEG segment");
      const uint8_t *b = data + pos + 2;
      int blen = len - 2;
      int64_t next = pos + len;
      bool is_sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                    m != 0xCC;
      if ((is_sof || m == 0xDA) && tables_only)
        fail(1, "a frame in a tables-only JPEG stream");
      if (is_sof) {
        if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE ||
            m == 0xCF)
          fail(2, "hierarchical JPEG (libjpeg reads none)");
        if (m == 0xCB)
          fail(2, "arithmetic-coded lossless JPEG (libjpeg-turbo reads none)");
        if (frame) fail(1, "two frames");
        progressive = m == 0xC2 || m == 0xCA;
        arith = m == 0xC9 || m == 0xCA;
        lossless = m == 0xC3;
        read_frame(b, blen);
        if (headers_only) return;
        pos = next;
        continue;
      }
      switch (m) {
        case 0xC4: {
          int i = 0;
          while (i < blen) {
            if (i + 17 > blen) fail(1, "bad DHT segment");
            int cls = b[i] >> 4, id = b[i] & 15;
            if (cls > 1 || id > 3) fail(1, "bad DHT table id");
            int cnt = 0;
            for (int l = 0; l < 16; l++) cnt += b[i + 1 + l];
            if (cnt > 256 || i + 17 + cnt > blen) fail(1, "bad DHT segment");
            if (!build_huff(cls ? ac[id] : dc[id], b + i + 1, b + i + 17))
              fail(1, "bad Huffman table");
            i += 17 + cnt;
          }
          break;
        }
        case 0xCC:  // DAC: jdmarker.c get_dac
          for (int i = 0; i + 1 < blen; i += 2) {
            int index = b[i], val = b[i + 1];
            if (index >= 32) fail(1, "bad DAC table index");
            if (index >= 16) {
              dac_k[index - 16] = (uint8_t)val;
            } else {
              dac_l[index] = (uint8_t)(val & 15);
              dac_u[index] = (uint8_t)(val >> 4);
              if (dac_l[index] > dac_u[index]) fail(1, "bad DAC value");
            }
          }
          break;
        case 0xDB: {
          int i = 0;
          while (i < blen) {
            int pq = b[i] >> 4, id = b[i] & 15;
            if (id > 3) fail(1, "bad DQT table id");
            int sz = pq ? 128 : 64;
            if (i + 1 + sz > blen) fail(1, "bad DQT segment");
            for (int k = 0; k < 64; k++)
              qt[id][kNatural[k]] =
                  pq ? (uint16_t)((b[i + 1 + 2 * k] << 8) | b[i + 2 + 2 * k])
                     : b[i + 1 + k];
            qt_defined[id] = true;
            i += 1 + sz;
          }
          break;
        }
        case 0xDD:
          if (blen < 2) fail(1, "bad DRI segment");
          restart = (b[0] << 8) | b[1];
          break;
        case 0xE0:
          if (blen >= 14 && !memcmp(b, "JFIF\0", 5)) jfif = true;
          break;
        case 0xEE:
          if (blen >= 12 && !memcmp(b, "Adobe", 5)) {
            adobe = true;
            adobe_transform = b[11];
          }
          break;
        case 0xDA:
          if (!frame) fail(1, "scan before the frame header");
          next = scan(b, blen, next);
          scanned = true;
          break;
        default:
          break;
      }
      pos = next;
    }
  }

  // the colour conversion: 0 none (grey, or the components as stored), 1
  // YCbCr -> RGB, 2 RGB as stored, 3 CMYK inverted, 4 YCCK -> CMYK inverted
  int conversion(int colour) {
    int nc = (int)comps.size();
    if (nc == 1 || colour == 1 || colour == 3) return 0;
    if (colour == 2) {
      if (nc != 3) fail(1, "YCbCr conversion of a 4-component JPEG");
      return 1;
    }
    int conv;
    if (nc == 4)
      conv = adobe && adobe_transform != 0 ? 4 : 3;
    else if (jfif)
      conv = 1;
    else if (adobe)
      conv = adobe_transform == 0 ? 2 : 1;
    else  // by the component ids; libjpeg-turbo guesses RGB in lossless
      conv = (comps[0].id == 'R' && comps[1].id == 'G' &&
              comps[2].id == 'B') || lossless
                 ? 2
                 : 1;
    if (lossless && (conv == 1 || conv == 4))
      fail(2, "lossless JPEG in YCbCr or YCCK (libjpeg-turbo converts no "
              "colours in a lossless file)");
    return conv;
  }
};

// jdsample.c's choice for a component upsampled hs x vs into f [H, W]
void upsample(const Component &k, int hs, int vs, bool fancy, int64_t H,
              int64_t W, uint8_t *f) {
  const uint8_t *pl = k.plane.data();
  const int64_t stride = k.stride;
  const int dw = k.dw, dh = k.dh;
  if (hs == 1 && vs == 1) {
    for (int64_t y = 0; y < H; y++) memcpy(f + y * W, pl + y * stride, W);
  } else if (fancy && hs == 2 && vs == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int64_t y = 0; y < H; y++) {
      const uint8_t *in = pl + y * stride;
      uint8_t *o = f + y * W;
      for (int64_t x = 0; x < W; x++) {
        int j = (int)(x >> 1);
        o[x] = (uint8_t)((x & 1)
                             ? (3 * in[j] + in[j + 1 < dw ? j + 1 : dw - 1] + 2) >> 2
                             : (3 * in[j] + in[j > 0 ? j - 1 : 0] + 1) >> 2);
      }
    }
  } else if (fancy && hs == 1 && vs == 2) {  // h1v2_fancy_upsample
    for (int64_t y = 0; y < H; y++) {
      int i = (int)(y >> 1);
      int far = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t *n0 = pl + (int64_t)i * stride;
      const uint8_t *n1 = pl + (int64_t)far * stride;
      uint8_t *o = f + y * W;
      for (int64_t x = 0; x < W; x++)
        o[x] = (uint8_t)((3 * n0[x] + n1[x] + bias) >> 2);
    }
  } else if (fancy && hs == 2 && vs == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> cs(dw);
    for (int64_t y = 0; y < H; y++) {
      int i = (int)(y >> 1);
      int far = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
      const uint8_t *n0 = pl + (int64_t)i * stride;
      const uint8_t *n1 = pl + (int64_t)far * stride;
      for (int j = 0; j < dw; j++) cs[j] = 3 * n0[j] + n1[j];
      uint8_t *o = f + y * W;
      for (int64_t x = 0; x < W; x++) {
        int j = (int)(x >> 1);
        o[x] = (uint8_t)((x & 1)
                             ? (3 * cs[j] + cs[j + 1 < dw ? j + 1 : dw - 1] + 7) >> 4
                             : (3 * cs[j] + cs[j > 0 ? j - 1 : 0] + 8) >> 4);
      }
    }
  } else {  // h2v1/h2v2_upsample and int_upsample: replication
    for (int64_t y = 0; y < H; y++) {
      const uint8_t *in = pl + (y / vs) * stride;
      uint8_t *o = f + y * W;
      for (int64_t x = 0; x < W; x++) o[x] = in[x / hs];
    }
  }
}

int decode(const uint8_t *tables, int64_t ntables, const uint8_t *data,
           int64_t n, int colour, uint8_t *out, int64_t out_cap,
           int32_t *dims, char *err, int errlen) {
  init_tables();
  Decoder d;
  try {
    if (tables != nullptr && ntables > 0) d.parse(tables, ntables, false, true);
    d.parse(data, n, out == nullptr, false);
    if (!d.frame) d.fail(1, "JPEG without a frame header");
    int nc = (int)d.comps.size();
    dims[0] = d.H;
    dims[1] = d.W;
    dims[2] = nc;
    if (out == nullptr) return 0;
    int64_t H = d.H, W = d.W;
    if (out_cap < H * W * nc) d.fail(1, "output buffer too small");
    int conv = d.conversion(colour);
    if (!d.lossless) d.transform();
    // each component at full size
    bool fancy = !d.lossless && colour != 3;
    std::vector<std::vector<uint8_t>> full(nc);
    for (int c = 0; c < nc; c++) {
      Component &k = d.comps[c];
      full[c].resize((size_t)H * W);
      upsample(k, d.hmax / k.h, d.vmax / k.v, fancy, H, W, full[c].data());
    }
    if (nc == 1) {
      memcpy(out, full[0].data(), (size_t)H * W);
      return 0;
    }
    if (conv == 0 || conv == 2 || conv == 3) {  // as stored, or inverted
      int inv = conv == 3 ? 255 : 0;
      for (int64_t p = 0; p < H * W; p++)
        for (int c = 0; c < nc; c++)
          out[nc * p + c] = (uint8_t)(inv ^ full[c][p]);
      return 0;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert (ycck_cmyk_convert
    // is the same on the first three, then inverted by Pillow)
    static int cr_r[256], cb_b[256];
    static int64_t cr_g[256], cb_g[256];
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    const uint8_t *lim = g_limit + 512;
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(),
                  *Cr = full[2].data();
    for (int64_t p = 0; p < H * W; p++) {
      int y = Y[p], cb = Cb[p], cr = Cr[p];
      uint8_t *o = out + nc * p;
      o[0] = lim[y + cr_r[cr]];
      o[1] = lim[y + (int)((cb_g[cb] + cr_g[cr]) >> SB)];
      o[2] = lim[y + cb_b[cb]];
      if (nc == 4) o[3] = (uint8_t)(255 - full[3][p]);
    }
    return 0;
  } catch (const Error &e) {
    if (err && errlen > 0) snprintf(err, errlen, "%s", e.msg.c_str());
    return e.code;
  } catch (const std::exception &e) {  // e.g. a frame too large to hold
    if (err && errlen > 0) snprintf(err, errlen, "%s", e.what());
    return 1;
  }
}

}  // namespace

extern "C" int jpeg_decode_tables(const uint8_t *tables, int64_t ntables,
                                  const uint8_t *data, int64_t n, int colour,
                                  uint8_t *out, int64_t out_cap,
                                  int32_t *dims, char *err, int errlen) {
  return decode(tables, ntables, data, n, colour, out, out_cap, dims, err,
                errlen);
}
