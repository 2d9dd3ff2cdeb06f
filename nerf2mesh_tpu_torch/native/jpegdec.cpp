// Baseline sequential and progressive JPEG decoder with the output of
// libjpeg(-turbo)'s default decompression, which Pillow's Image.open(...)
// gives:
//   * Huffman entropy decoding, restart intervals (DRI / RSTn), 8-bit
//     samples, 1 (grey), 3 or 4 (CMYK) components;
//   * baseline scans (any number, interleaved or not) and progressive ones
//     (jdphuff.c): DC first and refine scans, AC first scans with their
//     end-of-band runs and AC refine scans with their correction bits;
//     every scan fills a coefficient buffer, and the blocks are
//     transformed once the file is read (no block smoothing: libjpeg
//     smooths only blocks whose coefficients some scan left incomplete);
//   * the integer "islow" IDCT (jidctint.c) with its range-limit table;
//   * "fancy" triangle upsampling of 2h1v and 2h2v chroma (jdsample.c),
//     plain replication when a chroma plane is 2 samples wide or less;
//   * the fixed-point YCbCr -> RGB of jdcolor.c (16 fraction bits), or no
//     conversion for RGB files (Adobe transform 0, or component ids R G B);
//     CMYK comes out inverted, as Pillow reads it ("CMYK;I").
// Arithmetic-coded, lossless, hierarchical and 12-bit files, YCCK and
// sampling ratios other than 1x1, 2x1 and 2x2 are refused with their own
// codes: no encoder at hand writes them, so nothing holds a decoder of them
// to libjpeg.
//
// C interface (ctypes):
//   int jpeg_decode(const uint8_t *data, int64_t n, uint8_t *out,
//                   int64_t out_cap, int32_t *dims, char *err, int errlen)
// dims receives (height, width, channels).  With out == NULL only the
// headers are read (to size the output).  Returns 0, or an error code:
//   1 corrupt or not a JPEG, 2 arithmetic / lossless / hierarchical,
//   3 a file whose form this decoder does not read (12-bit, YCCK, other
//   sampling ratios);
// err holds the message.
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
  int bw, bh;        // blocks across and down (the MCU-padded plane)
  int dw, dh;        // samples of the downsampled plane that are real
  int td, ta;        // the current scan's Huffman tables
  int pred;          // DC predictor
  std::vector<int16_t> coef;   // bh*bw blocks of 64, natural order
  std::vector<uint8_t> plane;  // bh*8 rows of bw*8 samples
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

struct Decoder {
  const uint8_t *data;
  int64_t n;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Component> comps;
  int H = 0, W = 0, hmax = 1, vmax = 1, restart = 0;
  bool adobe = false;
  int adobe_transform = -1;
  bool frame = false, progressive = false;
  int ss = 0, se = 63, ah = 0, al = 0;  // the current scan's band and bits
  unsigned eobrun = 0;

  void fail(int code, const std::string &msg) { throw Error{code, msg}; }

  int u16(int64_t p) {
    if (p + 1 >= n) fail(1, "truncated JPEG");
    return (data[p] << 8) | data[p + 1];
  }

  void read_frame(const uint8_t *b, int len) {
    if (len < 6) fail(1, "short SOF segment");
    if (b[0] != 8) fail(3, "JPEG with " + std::to_string(b[0]) +
                               "-bit samples (only 8-bit is read)");
    H = (b[1] << 8) | b[2];
    W = (b[3] << 8) | b[4];
    int nc = b[5];
    if (H == 0 || W == 0) fail(3, "JPEG with a DNL height or zero size");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(3, "JPEG with " + std::to_string(nc) + " components");
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
    int mx = (W + 8 * hmax - 1) / (8 * hmax);
    int my = (H + 8 * vmax - 1) / (8 * vmax);
    for (Component &k : comps) {
      if (hmax % k.h || vmax % k.v) fail(3, "non-integral sampling ratio");
      k.bw = mx * k.h;
      k.bh = my * k.v;
      k.dw = (W * k.h + hmax - 1) / hmax;
      k.dh = (H * k.v + vmax - 1) / vmax;
      k.coef.assign((size_t)k.bw * k.bh * 64, 0);
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

  // every block of every component through the IDCT into its plane
  void transform() {
    for (Component &k : comps) {
      int stride = k.bw * 8;
      k.plane.assign((size_t)stride * k.bh * 8, 0);
      for (int by = 0; by < k.bh; by++)
        for (int bx = 0; bx < k.bw; bx++)
          idct_islow(k.block(bx, by), qt[k.tq],
                     k.plane.data() + (size_t)by * 8 * stride + bx * 8,
                     stride);
      std::vector<int16_t>().swap(k.coef);
    }
  }

  // one scan; returns the position after its entropy-coded data
  int64_t scan(const uint8_t *b, int len, int64_t pos) {
    int ns = b[0];
    if (ns < 1 || ns > 4 || len < 1 + 2 * ns + 3) fail(1, "bad SOS segment");
    std::vector<Component *> sc;
    for (int i = 0; i < ns; i++) {
      int cid = b[1 + 2 * i], t = b[2 + 2 * i];
      Component *found = nullptr;
      for (Component &k : comps)
        if (k.id == cid) found = &k;
      if (!found) fail(1, "SOS names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      found->pred = 0;
      sc.push_back(found);
    }
    ss = b[1 + 2 * ns];
    se = b[2 + 2 * ns];
    ah = b[3 + 2 * ns] >> 4;
    al = b[3 + 2 * ns] & 15;
    eobrun = 0;
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        fail(1, "baseline scan with spectral selection or approximation");
    } else if (se > 63 || ss > se || al > 13 || (ss == 0 && se != 0) ||
               (ss > 0 && ns != 1)) {
      fail(1, "bad progressive scan parameters");
    }
    bool need_dc = !progressive || (ss == 0 && ah == 0);
    bool need_ac = !progressive || ss > 0;
    for (Component *k : sc) {
      if ((need_dc && (k->td > 3 || !dc[k->td].defined)) ||
          (need_ac && (k->ta > 3 || !ac[k->ta].defined)))
        fail(1, "SOS names an undefined Huffman table");
      if (!qt_defined[k->tq]) fail(1, "undefined quantization table");
    }
    BitReader br{data, n, pos};
    int64_t mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = (W + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (H + 8 * vmax - 1) / (8 * vmax);
    }
    int64_t total = mcus_x * mcus_y, left = restart;
    for (int64_t m = 0; m < total; m++) {
      if (restart && left == 0) {
        // discard the buffered bits, find and skip the RSTn marker
        br.reset();
        int64_t p = br.pos;
        while (p + 1 < n && !(data[p] == 0xFF && data[p + 1] >= 0xD0 &&
                              data[p + 1] <= 0xD7))
          p++;
        br.pos = p + 2 <= n ? p + 2 : n;
        br.marker = false;
        for (Component *k : sc) k->pred = 0;
        eobrun = 0;
        left = restart;
      }
      int64_t mx = m % mcus_x, my = m / mcus_x;
      if (ns == 1) {
        decode_block(br, *sc[0], (int)mx, (int)my);
      } else {
        for (Component *k : sc)
          for (int yy = 0; yy < k->v; yy++)
            for (int xx = 0; xx < k->h; xx++)
              decode_block(br, *k, (int)(mx * k->h + xx),
                           (int)(my * k->v + yy));
      }
      if (restart) left--;
    }
    // the next marker after the scan's data
    int64_t p = br.pos;
    while (p + 1 < n && !(data[p] == 0xFF && data[p + 1] != 0x00 &&
                          !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
      p++;
    return p;
  }

  void parse(bool headers_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail(1, "not a JPEG (no SOI)");
    int64_t pos = 2;
    bool scanned = false;
    while (true) {
      while (pos < n && data[pos] != 0xFF) pos++;  // tolerate junk
      while (pos < n && data[pos] == 0xFF) pos++;  // fill bytes
      if (pos >= n) {
        if (scanned) return;
        fail(1, "truncated JPEG (no scan)");
      }
      int m = data[pos++];
      if (m == 0xD9) {
        if (!scanned) fail(1, "JPEG without a scan");
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;
      int len = u16(pos);
      if (len < 2 || pos + len > n) fail(1, "truncated JPEG segment");
      const uint8_t *b = data + pos + 2;
      int blen = len - 2;
      int64_t next = pos + len;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          if (frame) fail(1, "two frames");
          progressive = m == 0xC2;
          read_frame(b, blen);
          if (headers_only) return;
          break;
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail(2, "lossless JPEG");
        case 0xC5:
        case 0xC6:
        case 0xCD:
        case 0xCE:
          fail(2, "hierarchical JPEG");
        case 0xC9:
        case 0xCA:
          fail(2, "arithmetic-coded JPEG");
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
};

}  // namespace

extern "C" int jpeg_decode(const uint8_t *data, int64_t n, uint8_t *out,
                           int64_t out_cap, int32_t *dims, char *err,
                           int errlen) {
  init_tables();
  Decoder d;
  d.data = data;
  d.n = n;
  try {
    d.parse(out == nullptr);
    if (!d.frame) d.fail(1, "JPEG without a frame header");
    int nc = (int)d.comps.size();
    dims[0] = d.H;
    dims[1] = d.W;
    dims[2] = nc;
    if (out == nullptr) return 0;
    int64_t H = d.H, W = d.W;
    if (out_cap < H * W * nc) d.fail(1, "output buffer too small");
    if (nc == 4 && d.adobe && d.adobe_transform == 2)
      d.fail(3, "YCCK JPEG");
    d.transform();
    // each component at full size: upsampled (fancy) or copied
    std::vector<std::vector<uint8_t>> full(nc);
    for (int c = 0; c < nc; c++) {
      Component &k = d.comps[c];
      int hs = d.hmax / k.h, vs = d.vmax / k.v;
      int stride = k.bw * 8;
      const uint8_t *pl = k.plane.data();
      std::vector<uint8_t> &f = full[c];
      f.resize((size_t)H * W);
      int dw = k.dw, dh = k.dh;
      if (hs == 1 && vs == 1) {
        for (int64_t y = 0; y < H; y++) memcpy(&f[y * W], pl + y * stride, W);
      } else if (hs == 2 && vs == 1) {
        for (int64_t y = 0; y < H; y++) {
          const uint8_t *in = pl + y * stride;
          uint8_t *o = &f[y * W];
          for (int64_t x = 0; x < W; x++) {
            int j = (int)(x >> 1);
            int v;
            if (dw <= 2) {
              v = in[j];
            } else if (x & 1) {
              v = (3 * in[j] + in[j + 1 < dw ? j + 1 : dw - 1] + 2) >> 2;
            } else {
              v = (3 * in[j] + in[j > 0 ? j - 1 : 0] + 1) >> 2;
            }
            o[x] = (uint8_t)v;
          }
        }
      } else if (hs == 2 && vs == 2) {
        std::vector<int> cs(dw);
        for (int64_t y = 0; y < H; y++) {
          int i = (int)(y >> 1);
          uint8_t *o = &f[y * W];
          if (dw <= 2) {
            const uint8_t *in = pl + (int64_t)i * stride;
            for (int64_t x = 0; x < W; x++) o[x] = in[x >> 1];
            continue;
          }
          int far = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1)
                            : (i > 0 ? i - 1 : 0);
          const uint8_t *n0 = pl + (int64_t)i * stride;
          const uint8_t *n1 = pl + (int64_t)far * stride;
          for (int j = 0; j < dw; j++) cs[j] = 3 * n0[j] + n1[j];
          for (int64_t x = 0; x < W; x++) {
            int j = (int)(x >> 1);
            int v = (x & 1)
                        ? (3 * cs[j] + cs[j + 1 < dw ? j + 1 : dw - 1] + 7) >> 4
                        : (3 * cs[j] + cs[j > 0 ? j - 1 : 0] + 8) >> 4;
            o[x] = (uint8_t)v;
          }
        }
      } else {
        d.fail(3, "chroma sampling " + std::to_string(hs) + "x" +
                      std::to_string(vs) + " (only 2x1 and 2x2 are read)");
      }
    }
    if (nc == 1) {
      memcpy(out, full[0].data(), (size_t)H * W);
      return 0;
    }
    if (nc == 4) {  // CMYK as libjpeg gives it, inverted as Pillow reads it
      for (int64_t p = 0; p < H * W; p++)
        for (int c = 0; c < 4; c++) out[4 * p + c] = (uint8_t)(255 - full[c][p]);
      return 0;
    }
    bool rgb = (d.adobe && d.adobe_transform == 0) ||
               (d.comps[0].id == 'R' && d.comps[1].id == 'G' &&
                d.comps[2].id == 'B');
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(),
                  *Cr = full[2].data();
    const uint8_t *lim = g_limit + 512;
    if (rgb) {
      for (int64_t p = 0; p < H * W; p++) {
        out[3 * p] = Y[p];
        out[3 * p + 1] = Cb[p];
        out[3 * p + 2] = Cr[p];
      }
      return 0;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
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
    for (int64_t p = 0; p < H * W; p++) {
      int y = Y[p], cb = Cb[p], cr = Cr[p];
      out[3 * p] = lim[y + cr_r[cr]];
      out[3 * p + 1] = lim[y + (int)((cb_g[cb] + cr_g[cr]) >> SB)];
      out[3 * p + 2] = lim[y + cb_b[cb]];
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
