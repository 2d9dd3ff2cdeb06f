// WebP bitstreams for data/webp.py: lossless VP8L (the WebP Lossless
// Bitstream Specification) and lossy VP8 key frames (RFC 6386) with
// libwebp's YUV -> RGB conversion and its "fancy" chroma upsampling, the
// pixels Pillow's libwebp returns.
//
// C interface (ctypes):
//   int vp8l_decode(const uint8_t *src, int64_t n, int width, int height,
//                   int headerless, uint32_t *argb, char *err, int errlen)
//     a VP8L stream (after its 5-byte header, or an ALPH chunk's
//     headerless stream of the given size) -> width * height ARGB words.
//   int vp8_decode(const uint8_t *src, int64_t n, int width, int height,
//                  uint8_t *rgb, int stride, char *err, int errlen)
//     a VP8 key frame (the "VP8 " chunk's payload) -> RGB bytes, `stride`
//     bytes a pixel (3, or 4 leaving every fourth byte alone).
// Each returns 0, or -1 with a message in err.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const std::string &m) { throw Fail{m}; }

// ------------------------------------------------------------------ VP8L
struct LBits {
  const uint8_t *p;
  int64_t n, pos = 0;
  uint64_t val = 0;
  int bits = 0;
  LBits(const uint8_t *s, int64_t len) : p(s), n(len) {}
  void fill() {
    while (bits <= 56) {
      uint64_t b = pos < n ? p[pos] : 0;  // past the end reads zeros
      pos++;
      val |= b << bits;
      bits += 8;
    }
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    if (bits < k) fill();
    uint32_t v = (uint32_t)(val & ((1ull << k) - 1));
    val >>= k;
    bits -= k;
    return v;
  }
  uint32_t peek(int k) {
    if (bits < k) fill();
    return (uint32_t)(val & ((1ull << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    bits -= k;
  }
  // more bits taken than the stream holds
  bool overrun() const { return pos * 8 - bits > n * 8; }
};

// A canonical prefix code, read as deflate's are (the first bit read is the
// code's most significant): an 8-bit table for short codes, the canonical
// walk for the rest; a code of one symbol takes no bits.
struct Huffman {
  static const int kFast = 8;
  int single = -1;
  uint16_t count[16] = {0};
  std::vector<uint16_t> symbols;
  uint32_t fast[1 << kFast];  // symbol << 8 | length, 0 when longer

  void build(const std::vector<int> &lengths) {
    int nonzero = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); s++)
      if (lengths[s]) {
        nonzero++;
        last = (int)s;
        if (lengths[s] > 15) fail("VP8L code length over 15");
        count[lengths[s]]++;
      }
    if (nonzero == 0) fail("VP8L prefix code with no symbols");
    if (nonzero == 1) {
      single = last;
      return;
    }
    // complete?
    int left = 1;
    for (int len = 1; len < 16; len++) {
      left <<= 1;
      left -= count[len];
      if (left < 0) fail("VP8L prefix code over-subscribed");
    }
    if (left) fail("VP8L prefix code incomplete");
    uint16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; len++) offs[len + 1] = offs[len] + count[len];
    symbols.assign(nonzero, 0);
    for (size_t s = 0; s < lengths.size(); s++)
      if (lengths[s]) symbols[offs[lengths[s]]++] = (uint16_t)s;
    memset(fast, 0, sizeof(fast));
    // canonical codes, bit-reversed into the table
    int code = 0, idx = 0;
    for (int len = 1; len <= kFast; len++) {
      for (int i = 0; i < count[len]; i++, code++, idx++) {
        int rev = 0;
        for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int f = rev; f < (1 << kFast); f += 1 << len)
          fast[f] = ((uint32_t)symbols[idx] << 8) | (uint32_t)len;
      }
      code <<= 1;
    }
  }

  int read(LBits &br) const {
    if (single >= 0) return single;
    uint32_t e = fast[br.peek(kFast)];
    if (e) {
      br.skip(e & 255);
      return (int)(e >> 8);
    }
    uint32_t bits = br.peek(15);
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; len++) {
      code |= bits & 1;
      bits >>= 1;
      int c = count[len];
      if (code - c < first) {
        br.skip(len);
        return symbols[index + (code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("VP8L bad prefix code");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};
// (dy << 4 | (8 - dx)) of the 120 short distance codes
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((a >> s) & 255) + (int)((b >> s) & 255) -
                             (int)((c >> s) & 255))
           << s;
  return out;
}

inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int x = (int)((a >> s) & 255), y = (int)((b >> s) & 255);
    out |= (uint32_t)clip255(x + (x - y) / 2) << s;
  }
  return out;
}

inline uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (t >> s) & 255, b = (l >> s) & 255, c = (tl >> s) & 255;
    pa_minus_pb += abs(b - c) - abs(a - c);
  }
  return pa_minus_pb <= 0 ? t : l;
}

inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR,
                        uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return clamp_add_sub_full(L, T, TL);
    case 13: return clamp_add_sub_half(average2(L, T), TL);
    default: return 0xff000000u;
  }
}

inline int delta(int8_t t, int8_t c) { return ((int)t * (int)c) >> 5; }

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

struct VP8L {
  LBits br;
  std::vector<Transform> transforms;
  VP8L(const uint8_t *s, int64_t n) : br(s, n) {}

  static int div_up(int a, int b) { return (a + b - 1) / b; }

  void read_code(int alphabet, Huffman &h) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {  // simple
      int num = br.read(1) + 1;
      int first_8bit = br.read(1);
      int s0 = br.read(first_8bit ? 8 : 1);
      if (s0 >= alphabet) fail("VP8L simple code symbol out of range");
      lengths[s0] = 1;
      if (num == 2) {
        int s1 = br.read(8);
        if (s1 >= alphabet) fail("VP8L simple code symbol out of range");
        lengths[s1] = 1;
      }
      int nz = 0, last = 0;
      for (int s = 0; s < alphabet; s++)
        if (lengths[s]) nz++, last = s;
      if (nz == 1) {
        h.single = last;
        return;
      }
      h.build(lengths);
      return;
    }
    int cl[19] = {0};
    int num_codes = br.read(4) + 4;
    if (num_codes > 19) fail("VP8L too many code length codes");
    for (int i = 0; i < num_codes; i++) cl[kCodeLengthOrder[i]] = br.read(3);
    Huffman lc;
    lc.build(std::vector<int>(cl, cl + 19));
    int max_symbol = alphabet;
    if (br.read(1)) {
      int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) fail("VP8L max_symbol past the alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      int c = lc.read(br);
      if (c < 16) {
        lengths[symbol++] = c;
        if (c) prev = c;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int repeat = br.read(extra[c - 16]) + offset[c - 16];
        if (symbol + repeat > alphabet) fail("VP8L code lengths overflow");
        int len = c == 16 ? prev : 0;
        while (repeat--) lengths[symbol++] = len;
      }
    }
    h.build(lengths);
  }

  // an entropy-coded image of xsize x ysize ARGB words
  void image(int xsize, int ysize, bool level0, std::vector<uint32_t> &out) {
    if (level0) {
      int seen = 0;
      while (br.read(1)) {
        Transform t;
        t.type = br.read(2);
        if (seen & (1 << t.type)) fail("VP8L transform repeated");
        seen |= 1 << t.type;
        t.xsize = xsize;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {
          t.bits = br.read(3) + 2;
          image(div_up(xsize, 1 << t.bits), div_up(ysize, 1 << t.bits),
                false, t.data);
        } else if (t.type == 3) {
          int colors = br.read(8) + 1;
          t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
          image(colors, 1, false, t.data);
          for (int i = 1; i < colors; i++)
            t.data[i] = add_pixels(t.data[i], t.data[i - 1]);
          t.data.resize(256, 0);
          xsize = div_up(xsize, 1 << t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L color cache bits");
    }
    int huff_bits = 0, huff_xsize = 1, groups = 1;
    std::vector<uint32_t> entropy;
    if (level0 && br.read(1)) {
      huff_bits = br.read(3) + 2;
      huff_xsize = div_up(xsize, 1 << huff_bits);
      image(huff_xsize, div_up(ysize, 1 << huff_bits), false, entropy);
      for (auto &e : entropy) {
        e = (e >> 8) & 0xffff;
        groups = std::max(groups, (int)e + 1);
      }
    }
    int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Huffman> codes(5 * (size_t)groups);
    for (int g = 0; g < groups; g++) {
      read_code(256 + 24 + cache_size, codes[5 * g]);
      read_code(256, codes[5 * g + 1]);
      read_code(256, codes[5 * g + 2]);
      read_code(256, codes[5 * g + 3]);
      read_code(40, codes[5 * g + 4]);
    }
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const int64_t total = (int64_t)xsize * ysize;
    out.assign(total, 0);
    int64_t pos = 0, cached = 0;
    const int mask = huff_bits ? (1 << huff_bits) - 1 : -1;
    auto insert = [&](int64_t upto) {
      for (; cached < upto; cached++)
        cache[(0x1e35a7bdu * out[cached]) >> (32 - cache_bits)] = out[cached];
    };
    auto length = [&](int prefix) -> int {
      if (prefix < 4) return prefix + 1;
      int extra = (prefix - 2) >> 1;
      int offset = (2 + (prefix & 1)) << extra;
      return offset + (int)br.read(extra) + 1;
    };
    while (pos < total) {
      int x = (int)(pos % xsize), y = (int)(pos / xsize);
      const Huffman *h = &codes[0];
      if (mask >= 0)
        h = &codes[5 * (size_t)entropy[(y >> huff_bits) * huff_xsize +
                                      (x >> huff_bits)]];
      int s = h[0].read(br);
      if (s < 256) {
        uint32_t r = h[1].read(br), b = h[2].read(br), a = h[3].read(br);
        out[pos++] = (a << 24) | (r << 16) | ((uint32_t)s << 8) | b;
      } else if (s < 256 + 24) {
        int len = length(s - 256);
        int dcode = length(h[4].read(br));
        int64_t dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          int v = kCodeToPlane[dcode - 1];
          dist = (int64_t)(v >> 4) * xsize + (8 - (v & 15));
          if (dist < 1) dist = 1;
        }
        if (dist > pos || pos + len > total) fail("VP8L bad backward reference");
        for (int i = 0; i < len; i++, pos++) out[pos] = out[pos - dist];
      } else {
        if (!cache_bits) fail("VP8L color cache code without a cache");
        insert(pos);
        out[pos++] = cache[s - 280];
      }
      if (cache_bits) insert(pos);
      if (br.overrun()) fail("VP8L stream truncated");
    }
  }

  void inverse(const Transform &t, int ysize, std::vector<uint32_t> &px) {
    const int w = t.xsize;
    if (t.type == 2) {
      for (auto &p : px) {
        uint32_t g = (p >> 8) & 255;
        p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 255) << 16) |
            (((p & 255) + g) & 255);
      }
    } else if (t.type == 0) {
      const int tw = div_up(w, 1 << t.bits);
      for (int y = 0; y < ysize; y++)
        for (int x = 0; x < w; x++) {
          uint32_t *o = &px[(size_t)y * w + x];
          uint32_t pred;
          if (y == 0)
            pred = x == 0 ? 0xff000000u : o[-1];
          else if (x == 0)
            pred = o[-w];
          else
            pred = predict(
                (t.data[(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 15, o[-1],
                o[-w], o[-w + 1], o[-w - 1]);
          *o = add_pixels(*o, pred);
        }
    } else if (t.type == 1) {
      const int tw = div_up(w, 1 << t.bits);
      for (int y = 0; y < ysize; y++)
        for (int x = 0; x < w; x++) {
          uint32_t e = t.data[(y >> t.bits) * tw + (x >> t.bits)];
          int8_t g2r = (int8_t)(e & 255), g2b = (int8_t)((e >> 8) & 255),
                 r2b = (int8_t)((e >> 16) & 255);
          uint32_t &p = px[(size_t)y * w + x];
          int8_t green = (int8_t)((p >> 8) & 255);
          int r = (p >> 16) & 255, b = p & 255;
          r = (r + delta(g2r, green)) & 255;
          b = (b + delta(g2b, green) + delta(r2b, (int8_t)r)) & 255;
          p = (p & 0xff00ff00u) | ((uint32_t)r << 16) | (uint32_t)b;
        }
    } else {
      const int per = 1 << t.bits, nbits = 8 >> t.bits;
      const int packed = div_up(w, per);
      std::vector<uint32_t> out((size_t)w * ysize);
      for (int y = 0; y < ysize; y++)
        for (int x = 0; x < w; x++) {
          uint32_t g = (px[(size_t)y * packed + x / per] >> 8) & 255;
          int idx = (g >> ((x % per) * nbits)) & ((1 << nbits) - 1);
          out[(size_t)y * w + x] = t.data[idx];
        }
      px.swap(out);
    }
  }

  void decode(int width, int height, uint32_t *argb) {
    std::vector<uint32_t> px;
    image(width, height, true, px);
    for (int i = (int)transforms.size() - 1; i >= 0; i--)
      inverse(transforms[i], height, px);
    memcpy(argb, px.data(), px.size() * 4);
  }
};

// ------------------------------------------------------------------- VP8
// RFC 6386's tables, in libwebp's order of the 4x4 intra modes (DC, TM,
// VE, HE, RD, VR, LD, VL, HD, HU): the quantizer steps, the coefficient
// probabilities (defaults and update probabilities, [type][band][context]
// [node]) and the key-frame sub-block mode probabilities [above][left].
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};

const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};

const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t *const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the sub-block mode tree: a leaf is -mode, an inner node the index of its
// pair of children
const int8_t kYModesIntra4[18] = {0,  1,  -1, 2,  -2, 3,  4,  6,  -3,
                                  5,  -4, -5, -6, 7,  -7, 8,  -8, -9};
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
// 16x16 and chroma modes share the first four values
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3 };

// RFC 6386's boolean decoder (section 7.3); past the data it reads zeros
struct BoolDec {
  const uint8_t *p = nullptr, *end = nullptr;
  uint32_t value = 0;
  int range = 255, bit_count = 0;
  uint8_t next() { return p < end ? *p++ : 0; }
  void init(const uint8_t *s, const uint8_t *e) {
    p = s;
    end = e;
    value = next() << 8;
    value |= next();
    range = 255;
    bit_count = 0;
  }
  int bit(int prob) {
    const uint32_t split = 1 + (((uint32_t)(range - 1) * prob) >> 8);
    const uint32_t big = split << 8;
    int b;
    if (value >= big) {
      range -= split;
      value -= big;
      b = 1;
    } else {
      range = split;
      b = 0;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return b;
  }
  int literal(int n) {
    int v = 0;
    while (n--) v = (v << 1) | bit(128);
    return v;
  }
  int signed_literal(int n) {
    int v = literal(n);
    return bit(128) ? -v : v;
  }
};

struct MB {
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t imodes[16];
  int16_t coeffs[384];
  uint32_t nonzero_y, nonzero_uv;  // a bit a block with a coefficient
  uint8_t f_limit, f_ilevel, f_inner, hev;
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

const int BPS = 32;

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

void transform(const int16_t *in, uint8_t *dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; i++) {  // vertical pass
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = MUL2(in[4]) - MUL1(in[12]);
    const int d = MUL1(in[4]) + MUL2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; i++) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = MUL2(tmp[4]) - MUL1(tmp[12]);
    const int d = MUL1(tmp[4]) + MUL2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t *in, int16_t *out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t *dst, int size) {
  const uint8_t *top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; y++, dst += BPS)
    for (int x = 0; x < size; x++) dst[x] = clip8(top[x] + dst[-1] - tl);
}

void fill(uint8_t *dst, int v, int size) {
  for (int y = 0; y < size; y++) memset(dst + y * BPS, v, size);
}

void predict4(uint8_t *dst, int mode) {
  const uint8_t *top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                            AVG3(C, D, E)};
      for (int i = 0; i < 4; i++) memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      const int v[4] = {AVG3(X, I, J), AVG3(I, J, K), AVG3(J, K, L),
                        AVG3(K, L, L)};
      for (int i = 0; i < 4; i++) memset(dst + i * BPS, v[i], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
  }
}

// 16x16 (size 16) and chroma (size 8) prediction; DC without a top or a
// left neighbour uses the other, without both 128
void predict_block(uint8_t *dst, int mode, int size, bool has_top,
                   bool has_left) {
  switch (mode) {
    case DC_PRED: {
      const int shift = size == 16 ? 4 : 3;
      int dc = 0;
      if (has_top && has_left) {
        for (int i = 0; i < size; i++) dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc = (dc + size) >> (shift + 1);
      } else if (has_top || has_left) {
        for (int i = 0; i < size; i++)
          dc += has_top ? dst[i - BPS] : dst[-1 + i * BPS];
        dc = (dc + (size >> 1)) >> shift;
      } else {
        dc = 128;
      }
      fill(dst, dc, size);
      break;
    }
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED:
      for (int y = 0; y < size; y++) memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int y = 0; y < size; y++) memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
  }
}

// loop filters (libwebp's dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t *p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t *p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t *p, int step, int t) {
  return abs(p[-2 * step] - p[-step]) > t || abs(p[step] - p[0]) > t;
}

inline bool needs_filter(const uint8_t *p, int step, int t) {
  return 4 * abs(p[-step] - p[0]) + abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t *p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
            q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

void simple_filter(uint8_t *p, int hstride, int vstride, int size,
                   int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; i++, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

// `six`: the macroblock edge's filter (else the inner edges')
void complex_filter(uint8_t *p, int hstride, int vstride, int size,
                    int thresh, int ithresh, int hev_t, bool six) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; i++, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      do_filter2(p, hstride);
    else if (six)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

struct VP8 {
  int width, height, mbw, mbh;
  BoolDec br;
  std::vector<BoolDec> parts;
  // headers
  bool use_segment = false, update_map = false, absolute_delta = false;
  int8_t seg_quant[4] = {0}, seg_filter[4] = {0};
  uint8_t seg_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  int y1[4][2], y2[4][2], uv[4][2];  // [segment][dc, ac] steps
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  // frame planes (unfiltered while decoding), MB-aligned
  std::vector<uint8_t> Y, U, V;
  int ys, uvs;  // strides
  std::vector<MB> mbs;

  void parse_headers(const uint8_t *src, int64_t n) {
    if (n < 10) fail("VP8 frame too short");
    const uint32_t bits = src[0] | (src[1] << 8) | (src[2] << 16);
    if (bits & 1) fail("VP8 frame is not a key frame");
    if (((bits >> 1) & 7) > 3) fail("VP8 profile over 3");
    if (!((bits >> 4) & 1)) fail("VP8 frame not shown");
    const uint32_t part0 = bits >> 5;
    if (src[3] != 0x9d || src[4] != 0x01 || src[5] != 0x2a)
      fail("VP8 start code missing");
    if (10 + (int64_t)part0 > n) fail("VP8 first partition truncated");
    br.init(src + 10, src + 10 + part0);
    br.bit(128);  // colour space
    br.bit(128);  // clamping type (libwebp always clamps)
    // segment header
    use_segment = br.bit(128);
    if (use_segment) {
      update_map = br.bit(128);
      if (br.bit(128)) {
        absolute_delta = br.bit(128);
        for (int s = 0; s < 4; s++)
          seg_quant[s] = (int8_t)(br.bit(128) ? br.signed_literal(7) : 0);
        for (int s = 0; s < 4; s++)
          seg_filter[s] = (int8_t)(br.bit(128) ? br.signed_literal(6) : 0);
      }
      if (update_map)
        for (int s = 0; s < 3; s++)
          seg_proba[s] = (uint8_t)(br.bit(128) ? br.literal(8) : 255);
    }
    // filter header
    simple = br.bit(128);
    level = br.literal(6);
    sharpness = br.literal(3);
    use_lf_delta = br.bit(128);
    if (use_lf_delta && br.bit(128)) {
      for (int i = 0; i < 4; i++)
        if (br.bit(128)) ref_lf_delta[i] = br.signed_literal(6);
      for (int i = 0; i < 4; i++)
        if (br.bit(128)) mode_lf_delta[i] = br.signed_literal(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    // token partitions
    const int num_parts = 1 << br.literal(2);
    const uint8_t *sizes = src + 10 + part0;
    const uint8_t *buf_end = src + n;
    const uint8_t *part_start = sizes + 3 * (num_parts - 1);
    if (part_start > buf_end) fail("VP8 partition sizes truncated");
    parts.resize(num_parts);
    for (int p = 0; p < num_parts - 1; p++) {
      int64_t psize = sizes[0] | (sizes[1] << 8) | (sizes[2] << 16);
      sizes += 3;
      if (psize > buf_end - part_start) psize = buf_end - part_start;
      parts[p].init(part_start, part_start + psize);
      part_start += psize;
    }
    parts[num_parts - 1].init(part_start, buf_end);
    // quantizers
    const int base_q = br.literal(7);
    const int dqy1_dc = br.bit(128) ? br.signed_literal(4) : 0;
    const int dqy2_dc = br.bit(128) ? br.signed_literal(4) : 0;
    const int dqy2_ac = br.bit(128) ? br.signed_literal(4) : 0;
    const int dquv_dc = br.bit(128) ? br.signed_literal(4) : 0;
    const int dquv_ac = br.bit(128) ? br.signed_literal(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; s++) {
      int q = base_q;
      if (use_segment) {
        q = seg_quant[s] + (absolute_delta ? 0 : base_q);
      }
      y1[s][0] = kDcTable[clip(q + dqy1_dc, 127)];
      y1[s][1] = kAcTable[clip(q, 127)];
      y2[s][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      y2[s][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (y2[s][1] < 8) y2[s][1] = 8;
      uv[s][0] = kDcTable[clip(q + dquv_dc, 117)];
      uv[s][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.bit(128);  // refresh entropy probabilities: one frame, ignored
    for (int t = 0; t < 4; t++)
      for (int b = 0; b < 8; b++)
        for (int c = 0; c < 3; c++)
          for (int p = 0; p < 11; p++) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = (uint8_t)(br.bit(kCoeffsUpdateProba[i])
                                              ? br.literal(8)
                                              : kCoeffsProba0[i]);
          }
    use_skip = br.bit(128);
    if (use_skip) skip_p = br.literal(8);
  }

  // one row's intra modes from the first partition
  void parse_modes(int mby, std::vector<uint8_t> &intra_t) {
    uint8_t left[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mbx = 0; mbx < mbw; mbx++) {
      MB &m = mbs[(size_t)mby * mbw + mbx];
      uint8_t *top = &intra_t[4 * mbx];
      m.segment = update_map ? (!br.bit(seg_proba[0])
                                    ? br.bit(seg_proba[1])
                                    : br.bit(seg_proba[2]) + 2)
                             : 0;
      m.skip = use_skip ? br.bit(skip_p) : 0;
      m.is_i4x4 = !br.bit(145);
      if (!m.is_i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                      : (br.bit(163) ? V_PRED : DC_PRED);
        m.imodes[0] = (uint8_t)ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
      } else {
        for (int y = 0; y < 4; y++) {
          int ymode = left[y];
          for (int x = 0; x < 4; x++) {
            const uint8_t *prob = kBModesProba + (top[x] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ymode = -i;
            top[x] = (uint8_t)ymode;
            m.imodes[4 * y + x] = (uint8_t)ymode;
          }
          left[y] = (uint8_t)ymode;
        }
      }
      m.uvmode = !br.bit(142) ? DC_PRED
                 : !br.bit(114) ? V_PRED
                 : br.bit(183)  ? TM_PRED
                                : H_PRED;
    }
  }

  // the coefficients of one 4x4 block from position n: returns the
  // position after its last nonzero one (n where it has none)
  static int coeffs(BoolDec &d, const uint8_t (*prob)[3][11], int ctx,
                    const int *dq, int n, int16_t *out) {
    const uint8_t *p = prob[kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!d.bit(p[0])) return n;
      while (!d.bit(p[1])) {
        p = prob[kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      const uint8_t(*next)[11] = prob[kBands[n + 1]];
      if (!d.bit(p[2])) {
        v = 1;
        p = next[1];
      } else {
        if (!d.bit(p[3])) {
          if (!d.bit(p[4]))
            v = 2;
          else
            v = 3 + d.bit(p[5]);
        } else if (!d.bit(p[6])) {
          if (!d.bit(p[7]))
            v = 5 + d.bit(159);
          else {
            v = 7 + 2 * d.bit(165);
            v += d.bit(145);
          }
        } else {
          const int bit1 = d.bit(p[8]);
          const int bit0 = d.bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t *tab = kCat3456[cat]; *tab; ++tab)
            v += v + d.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = next[2];
      }
      out[kZigzag[n]] = (int16_t)((d.bit(128) ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  // residuals of one MB; nz holds the top (t) and left (l) contexts:
  // 4 luma, 2 u, 2 v, and the Y2 block's
  void residuals(MB &m, BoolDec &d, uint8_t *tnz, uint8_t *lnz) {
    int16_t *dst = m.coeffs;
    memset(dst, 0, sizeof(m.coeffs));
    m.nonzero_y = m.nonzero_uv = 0;
    int first;
    const uint8_t(*ac)[3][11];
    const int s = m.segment;
    if (!m.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = tnz[8] + lnz[8];
      const int nz = coeffs(d, proba[1], ctx, y2[s], 0, dc);
      tnz[8] = lnz[8] = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac = proba[0];
    } else {
      first = 0;
      ac = proba[3];
    }
    for (int y = 0; y < 4; y++)
      for (int x = 0; x < 4; x++) {
        const int ctx = tnz[x] + lnz[y];
        const int nz = coeffs(d, ac, ctx, y1[s], first, dst);
        tnz[x] = lnz[y] = nz > first;
        // libwebp's test: coefficients past the first, or a nonzero first
        // (for a 16x16 MB, its Y2 DC)
        if (nz > 1 || dst[0] != 0) m.nonzero_y |= 1u << (4 * y + x);
        dst += 16;
      }
    for (int ch = 0; ch < 2; ch++)
      for (int y = 0; y < 2; y++)
        for (int x = 0; x < 2; x++) {
          const int ctx = tnz[4 + 2 * ch + x] + lnz[4 + 2 * ch + y];
          const int nz = coeffs(d, proba[2], ctx, uv[s], 0, dst);
          tnz[4 + 2 * ch + x] = lnz[4 + 2 * ch + y] = nz > 0;
          if (nz > 1 || dst[0] != 0) m.nonzero_uv |= 1u << (4 * ch + 2 * y + x);
          dst += 16;
        }
  }

  void reconstruct(int mbx, int mby, const MB &m) {
    uint8_t ybuf[17 * BPS + 8], ubuf[9 * BPS], vbuf[9 * BPS];
    uint8_t *yd = ybuf + BPS + 8, *ud = ubuf + BPS + 1, *vd = vbuf + BPS + 1;
    const int x0 = mbx * 16, y0 = mby * 16, cx0 = mbx * 8, cy0 = mby * 8;
    // the top row (with top-left and top-right) and the left column
    if (mby == 0) {
      memset(yd - BPS - 1, 127, 21);
      memset(ud - BPS - 1, 127, 9);
      memset(vd - BPS - 1, 127, 9);
    } else {
      memcpy(yd - BPS, &Y[(size_t)(y0 - 1) * ys + x0], 16);
      memcpy(ud - BPS, &U[(size_t)(cy0 - 1) * uvs + cx0], 8);
      memcpy(vd - BPS, &V[(size_t)(cy0 - 1) * uvs + cx0], 8);
      if (mbx == 0) {
        yd[-BPS - 1] = ud[-BPS - 1] = vd[-BPS - 1] = 129;
      } else {
        yd[-BPS - 1] = Y[(size_t)(y0 - 1) * ys + x0 - 1];
        ud[-BPS - 1] = U[(size_t)(cy0 - 1) * uvs + cx0 - 1];
        vd[-BPS - 1] = V[(size_t)(cy0 - 1) * uvs + cx0 - 1];
      }
      if (mbx < mbw - 1)
        memcpy(yd - BPS + 16, &Y[(size_t)(y0 - 1) * ys + x0 + 16], 4);
      else
        memset(yd - BPS + 16, Y[(size_t)(y0 - 1) * ys + x0 + 15], 4);
    }
    for (int j = 0; j < 16; j++)
      yd[j * BPS - 1] = mbx ? Y[(size_t)(y0 + j) * ys + x0 - 1] : 129;
    for (int j = 0; j < 8; j++) {
      ud[j * BPS - 1] = mbx ? U[(size_t)(cy0 + j) * uvs + cx0 - 1] : 129;
      vd[j * BPS - 1] = mbx ? V[(size_t)(cy0 + j) * uvs + cx0 - 1] : 129;
    }
    const int16_t *c = m.coeffs;
    if (m.is_i4x4) {
      for (int r = 1; r < 4; r++)
        memcpy(yd + (4 * r - 1) * BPS + 16, yd - BPS + 16, 4);
      for (int n = 0; n < 16; n++) {
        uint8_t *dst = yd + (n >> 2) * 4 * BPS + (n & 3) * 4;
        predict4(dst, m.imodes[n]);
        if (m.nonzero_y & (1u << n)) transform(c + 16 * n, dst);
      }
    } else {
      predict_block(yd, m.imodes[0], 16, mby > 0, mbx > 0);
      for (int n = 0; n < 16; n++)
        if (m.nonzero_y & (1u << n))
          transform(c + 16 * n, yd + (n >> 2) * 4 * BPS + (n & 3) * 4);
    }
    predict_block(ud, m.uvmode, 8, mby > 0, mbx > 0);
    predict_block(vd, m.uvmode, 8, mby > 0, mbx > 0);
    for (int n = 0; n < 4; n++) {
      const int off = (n >> 1) * 4 * BPS + (n & 1) * 4;
      if (m.nonzero_uv & (1u << n)) transform(c + 256 + 16 * n, ud + off);
      if (m.nonzero_uv & (1u << (4 + n))) transform(c + 320 + 16 * n, vd + off);
    }
    for (int j = 0; j < 16; j++)
      memcpy(&Y[(size_t)(y0 + j) * ys + x0], yd + j * BPS, 16);
    for (int j = 0; j < 8; j++) {
      memcpy(&U[(size_t)(cy0 + j) * uvs + cx0], ud + j * BPS, 8);
      memcpy(&V[(size_t)(cy0 + j) * uvs + cx0], vd + j * BPS, 8);
    }
  }

  void filter_strengths() {
    for (auto &m : mbs) {
      int base = level;
      if (use_segment) {
        base = seg_filter[m.segment];
        if (!absolute_delta) base += level;
      }
      int lvl = base;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (m.is_i4x4) lvl += mode_lf_delta[0];
      }
      lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
      m.f_limit = 0;
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        m.f_ilevel = (uint8_t)ilevel;
        m.f_limit = (uint8_t)(2 * lvl + ilevel);
        m.hev = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
      }
      m.f_inner = m.is_i4x4 || m.nonzero_y || m.nonzero_uv;
    }
  }

  void loop_filter() {
    for (int mby = 0; mby < mbh; mby++)
      for (int mbx = 0; mbx < mbw; mbx++) {
        const MB &m = mbs[(size_t)mby * mbw + mbx];
        const int limit = m.f_limit;
        if (!limit) continue;
        uint8_t *y = &Y[(size_t)mby * 16 * ys + mbx * 16];
        if (filter_type == 1) {
          if (mbx > 0) simple_filter(y, 1, ys, 16, limit + 4);
          if (m.f_inner)
            for (int i = 4; i < 16; i += 4) simple_filter(y + i, 1, ys, 16, limit);
          if (mby > 0) simple_filter(y, ys, 1, 16, limit + 4);
          if (m.f_inner)
            for (int i = 4; i < 16; i += 4)
              simple_filter(y + i * ys, ys, 1, 16, limit);
          continue;
        }
        uint8_t *u = &U[(size_t)mby * 8 * uvs + mbx * 8];
        uint8_t *v = &V[(size_t)mby * 8 * uvs + mbx * 8];
        const int il = m.f_ilevel, ht = m.hev;
        if (mbx > 0) {
          complex_filter(y, 1, ys, 16, limit + 4, il, ht, true);
          complex_filter(u, 1, uvs, 8, limit + 4, il, ht, true);
          complex_filter(v, 1, uvs, 8, limit + 4, il, ht, true);
        }
        if (m.f_inner) {
          for (int i = 4; i < 16; i += 4)
            complex_filter(y + i, 1, ys, 16, limit, il, ht, false);
          complex_filter(u + 4, 1, uvs, 8, limit, il, ht, false);
          complex_filter(v + 4, 1, uvs, 8, limit, il, ht, false);
        }
        if (mby > 0) {
          complex_filter(y, ys, 1, 16, limit + 4, il, ht, true);
          complex_filter(u, uvs, 1, 8, limit + 4, il, ht, true);
          complex_filter(v, uvs, 1, 8, limit + 4, il, ht, true);
        }
        if (m.f_inner) {
          for (int i = 4; i < 16; i += 4)
            complex_filter(y + i * ys, ys, 1, 16, limit, il, ht, false);
          complex_filter(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          complex_filter(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
        }
      }
  }

  void decode(const uint8_t *src, int64_t n) {
    parse_headers(src, n);
    mbw = (width + 15) >> 4;
    mbh = (height + 15) >> 4;
    ys = mbw * 16;
    uvs = mbw * 8;
    Y.assign((size_t)ys * mbh * 16, 0);
    U.assign((size_t)uvs * mbh * 8, 0);
    V.assign((size_t)uvs * mbh * 8, 0);
    mbs.assign((size_t)mbw * mbh, MB());
    std::vector<uint8_t> intra_t(4 * mbw, B_DC), tnz(9 * mbw, 0);
    for (int mby = 0; mby < mbh; mby++) {
      parse_modes(mby, intra_t);
      BoolDec &d = parts[mby & (parts.size() - 1)];
      uint8_t lnz[9] = {0};
      for (int mbx = 0; mbx < mbw; mbx++) {
        MB &m = mbs[(size_t)mby * mbw + mbx];
        uint8_t *t = &tnz[9 * mbx];
        if (!m.skip) {
          residuals(m, d, t, lnz);
        } else {
          memset(t, 0, 8);
          memset(lnz, 0, 8);
          if (!m.is_i4x4) t[8] = lnz[8] = 0;
          m.nonzero_y = m.nonzero_uv = 0;
        }
        reconstruct(mbx, mby, m);
      }
    }
    if (filter_type) {
      filter_strengths();
      loop_filter();
    }
  }
};

// libwebp's YUV -> RGB (src/dsp/yuv.h: 14-bit fixed point, YUV_FIX2 = 6)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? (uint8_t)(v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t *rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) +
                     8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's "fancy" upsampling (src/dsp/upsampling.c) of one output row:
// chroma from the near row weighted 3 and the far row 1, across and down
void upsample_row(const uint8_t *yrow, const uint8_t *nu, const uint8_t *nv,
                  const uint8_t *fu, const uint8_t *fv, int len, uint8_t *out,
                  int stride) {
  auto edge = [&](int xc, int xp) {
    const int u = (3 * nu[xc] + fu[xc] + 2) >> 2;
    const int v = (3 * nv[xc] + fv[xc] + 2) >> 2;
    yuv_to_rgb(yrow[xp], u, v, out + (size_t)xp * stride);
  };
  edge(0, 0);
  const int pairs = (len - 1) >> 1;
  for (int x = 1; x <= pairs; x++) {
    int uv0[2], uv1[2];
    const uint8_t *n[2] = {nu, nv}, *f[2] = {fu, fv};
    for (int c = 0; c < 2; c++) {
      const int avg = n[c][x - 1] + n[c][x] + f[c][x - 1] + f[c][x] + 8;
      const int d12 = (avg + 2 * (n[c][x] + f[c][x - 1])) >> 3;
      const int d03 = (avg + 2 * (n[c][x - 1] + f[c][x])) >> 3;
      uv0[c] = (d12 + n[c][x - 1]) >> 1;
      uv1[c] = (d03 + n[c][x]) >> 1;
    }
    yuv_to_rgb(yrow[2 * x - 1], uv0[0], uv0[1], out + (size_t)(2 * x - 1) * stride);
    yuv_to_rgb(yrow[2 * x], uv1[0], uv1[1], out + (size_t)(2 * x) * stride);
  }
  if (!(len & 1)) edge((len - 1) >> 1, len - 1);
}

void copy_err(const std::string &m, char *err, int errlen) {
  if (errlen > 0) {
    strncpy(err, m.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" int vp8l_decode(const uint8_t *src, int64_t n, int width,
                           int height, int headerless, uint32_t *argb,
                           char *err, int errlen) {
  try {
    if (!headerless) {
      // 0x2f, 14 bits width-1, 14 bits height-1, 1 alpha bit, 3 version
      if (n < 5 || src[0] != 0x2f) fail("not a VP8L stream");
      uint32_t bits = src[1] | (src[2] << 8) | (src[3] << 16) |
                      ((uint32_t)src[4] << 24);
      if ((int)(bits & 0x3fff) + 1 != width ||
          (int)((bits >> 14) & 0x3fff) + 1 != height)
        fail("VP8L size differs from the container's");
      if (bits >> 29) fail("VP8L version is not 0");
      src += 5;
      n -= 5;
    }
    VP8L d(src, n);
    d.decode(width, height, argb);
    return 0;
  } catch (const Fail &f) {
    copy_err(f.msg, err, errlen);
    return -1;
  }
}

// The ALPH chunk's filters undone in place (libwebp's unfilters): each
// row predicted from the row above (vertical), its left neighbour
// (horizontal) or clip(left + above - above-left) (gradient); the first
// row from the left, the first column from above.
extern "C" void alpha_unfilter(uint8_t *a, int w, int h, int method) {
  for (int y = 0; y < h; y++) {
    uint8_t *row = a + (size_t)y * w;
    const uint8_t *prev = y ? row - w : nullptr;
    if (!prev || method == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; x++) pred = row[x] = (uint8_t)(row[x] + pred);
    } else if (method == 2) {
      for (int x = 0; x < w; x++) row[x] = (uint8_t)(row[x] + prev[x]);
    } else {
      int top, top_left = prev[0], left = prev[0];
      for (int x = 0; x < w; x++) {
        top = prev[x];
        int g = left + top - top_left;
        g = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = row[x] = (uint8_t)(row[x] + g);
        top_left = top;
      }
    }
  }
}

extern "C" int vp8_decode(const uint8_t *src, int64_t n, int width, int height,
                          uint8_t *rgb, int stride, char *err, int errlen) {
  try {
    VP8 d;
    d.width = width;
    d.height = height;
    d.decode(src, n);
    const int ch = (height + 1) / 2;
    for (int y = 0; y < height; y++) {
      const int near = y >> 1;
      int far = (y & 1) ? near + 1 : near - 1;
      far = far < 0 ? 0 : far > ch - 1 ? ch - 1 : far;
      upsample_row(&d.Y[(size_t)y * d.ys], &d.U[(size_t)near * d.uvs],
                   &d.V[(size_t)near * d.uvs], &d.U[(size_t)far * d.uvs],
                   &d.V[(size_t)far * d.uvs], width,
                   rgb + (size_t)y * width * stride, stride);
    }
    return 0;
  } catch (const Fail &f) {
    copy_err(f.msg, err, errlen);
    return -1;
  }
}
