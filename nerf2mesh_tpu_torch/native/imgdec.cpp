// Inner loops of the BMP, TIFF, GIF, netpbm, TGA and QOI readers
// (data/bmp.py, tiff.py, gif.py, netpbm.py, tga.py, qoi.py): the LZW
// variants of TIFF and GIF, PackBits, TIFF's horizontal predictor, the BMP
// RLE8/RLE4 decoder as Pillow's BmpRleDecoder reads it (the array JAX's
// providers see), the plain (ASCII) netpbm samples, TGA's RLE packets and
// the QOI operations as Pillow's decoders read them.
//
// C interface (ctypes); each returns the bytes written or -1 on a code
// the stream cannot hold:
//   int64_t lzw_tiff(const uint8_t *src, int64_t n, uint8_t *dst,
//                    int64_t cap)
//     TIFF LZW (TIFF 6.0 section 13): codes MSB first, 9-12 bits, the
//     width growing one code early; 256 clears, 257 ends.
//   int64_t lzw_gif(const uint8_t *src, int64_t n, int min_bits,
//                   uint8_t *dst, int64_t cap)
//     GIF89a LZW: codes LSB first from min_bits + 1 bits up to 12, a full
//     table kept until the next clear code.
//   int64_t packbits(const uint8_t *src, int64_t n, uint8_t *dst,
//                    int64_t cap)
//   void tiff_unpredict(uint8_t *buf, int64_t rows, int64_t cols, int spp,
//                       int bytes, int big_endian)
//     undoes TIFF predictor 2 in place: rows of cols pixels of spp samples
//     of 1 or 2 bytes (in the file's byte order).
//   int64_t bmp_rle(const uint8_t *src, int64_t n, int64_t pos,
//                   int64_t width, int64_t count, int rle4, uint8_t *out)
//     RLE8/RLE4 from src[pos:] (src is the whole file: the word alignment
//     of absolute runs is on the file offset) into out, at most count
//     pixels.
//   int64_t netpbm_plain(const uint8_t *src, int64_t n, int bitonal,
//                        int32_t *out, int64_t count)
//     the first count samples of a plain netpbm body (PpmPlainDecoder):
//     comments from '#' through the end of their line removed first (a
//     token may go on after one), tokens of at most 10 digits, or with
//     bitonal every '0' or '1' a sample; -1 on any other token.
//   int64_t tga_rle(const uint8_t *src, int64_t n, int depth,
//                   int64_t row_bytes, uint8_t *out, int64_t count)
//     TGA run-length packets of depth-byte pixels as TgaRleDecode.c reads
//     them: a literal goes on across rows, a run that would cross a row's
//     end is an overrun (-1); at most count bytes.
//   int64_t qoi_decode(const uint8_t *src, int64_t n, int channels,
//                      uint8_t *out, int64_t pixels)
//     QOI's index, diff, luma, run, RGB and RGBA operations as Pillow's
//     QoiDecoder reads them (a run does not enter the index; an index
//     never written gives 0, 0, 0, 0); -1 when the data ends first.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct LzwTable {
  uint16_t prefix[4096];
  uint8_t suffix[4096];
  uint8_t first[4096];
  uint16_t length[4096];
  void reset(int roots) {
    for (int i = 0; i < roots; i++) {
      prefix[i] = 0xFFFF;
      suffix[i] = first[i] = (uint8_t)i;
      length[i] = 1;
    }
  }
  // writes code's string at dst (room checked by the caller)
  void emit(int code, uint8_t *dst) const {
    int len = length[code];
    while (len-- > 0) {
      dst[len] = suffix[code];
      code = prefix[code];
    }
  }
};

template <bool kMsbFirst>
struct BitReader {
  const uint8_t *src;
  int64_t n, pos = 0;
  uint64_t acc = 0;
  int bits = 0;
  BitReader(const uint8_t *s, int64_t len) : src(s), n(len) {}
  // -1 at the end of the data
  int read(int width) {
    while (bits < width) {
      if (pos >= n) return -1;
      if (kMsbFirst)
        acc = (acc << 8) | src[pos++];
      else
        acc |= (uint64_t)src[pos++] << bits;
      bits += 8;
    }
    int v;
    if (kMsbFirst) {
      v = (int)((acc >> (bits - width)) & ((1u << width) - 1));
    } else {
      v = (int)(acc & ((1u << width) - 1));
      acc >>= width;
    }
    bits -= width;
    return v;
  }
};

template <bool kTiff>
int64_t lzw(const uint8_t *src, int64_t n, int min_bits, uint8_t *dst,
            int64_t cap) {
  static thread_local LzwTable t;
  const int clear = 1 << min_bits, eoi = clear + 1;
  BitReader<kTiff> br(src, n);
  t.reset(clear);
  int bits = min_bits + 1, next = clear + 2, prev = -1;
  int64_t out = 0;
  for (;;) {
    int code = br.read(bits);
    if (code < 0 || code == eoi) break;
    if (code == clear) {
      bits = min_bits + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code >= clear) return -1;
      if (out >= cap) break;
      dst[out++] = (uint8_t)code;
      prev = code;
      continue;
    }
    int len;
    uint8_t head;
    if (code < next) {
      len = t.length[code];
      head = t.first[code];
    } else if (code == next) {
      len = t.length[prev] + 1;
      head = t.first[prev];
    } else {
      return -1;
    }
    if (next < 4096) {
      t.prefix[next] = (uint16_t)prev;
      t.suffix[next] = head;
      t.first[next] = t.first[prev];
      t.length[next] = (uint16_t)(t.length[prev] + 1);
      next++;
    }
    if (out + len > cap) {            // a stream longer than the image
      std::vector<uint8_t> tmp(len);
      t.emit(code, tmp.data());
      memcpy(dst + out, tmp.data(), cap - out);
      out = cap;
      break;
    }
    t.emit(code, dst + out);
    out += len;
    prev = code;
    int grow = kTiff ? next + 1 : next;   // TIFF's early change
    if (grow >= (1 << bits) && bits < 12) bits++;
  }
  return out;
}

}  // namespace

extern "C" int64_t lzw_tiff(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t cap) {
  return lzw<true>(src, n, 8, dst, cap);
}

extern "C" int64_t lzw_gif(const uint8_t *src, int64_t n, int min_bits,
                           uint8_t *dst, int64_t cap) {
  if (min_bits < 1 || min_bits > 11) return -1;
  return lzw<false>(src, n, min_bits, dst, cap);
}

extern "C" int64_t packbits(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t cap) {
  int64_t i = 0, out = 0;
  while (i < n && out < cap) {
    int c = (int8_t)src[i++];
    if (c >= 0) {
      int64_t len = c + 1;
      if (i + len > n) len = n - i;
      if (out + len > cap) len = cap - out;
      memcpy(dst + out, src + i, len);
      i += c + 1;
      out += len;
    } else if (c != -128) {
      if (i >= n) break;
      int64_t len = 1 - c;
      if (out + len > cap) len = cap - out;
      memset(dst + out, src[i++], len);
      out += len;
    }
  }
  return out;
}

extern "C" void tiff_unpredict(uint8_t *buf, int64_t rows, int64_t cols,
                               int spp, int bytes, int big_endian) {
  const int64_t stride = cols * spp * bytes;
  for (int64_t y = 0; y < rows; y++) {
    uint8_t *r = buf + y * stride;
    if (bytes == 1) {
      for (int64_t i = spp; i < cols * spp; i++) r[i] = (uint8_t)(r[i] + r[i - spp]);
      continue;
    }
    auto get = [&](int64_t i) -> uint16_t {
      return big_endian ? (uint16_t)((r[2 * i] << 8) | r[2 * i + 1])
                        : (uint16_t)(r[2 * i] | (r[2 * i + 1] << 8));
    };
    for (int64_t i = spp; i < cols * spp; i++) {
      uint16_t v = (uint16_t)(get(i) + get(i - spp));
      if (big_endian) {
        r[2 * i] = (uint8_t)(v >> 8);
        r[2 * i + 1] = (uint8_t)v;
      } else {
        r[2 * i] = (uint8_t)v;
        r[2 * i + 1] = (uint8_t)(v >> 8);
      }
    }
  }
}

// Pillow's BmpRleDecoder (BmpImagePlugin.py), step for step: an encoded
// run is cut at the row's end; end of line pads the row with zeros; a
// delta reads two bytes it ignores and then its two offsets; an absolute
// RLE4 run of n pixels reads n / 2 bytes (two pixels each) and advances x
// by n; absolute runs end on an even file offset.
extern "C" int64_t bmp_rle(const uint8_t *src, int64_t n, int64_t pos,
                           int64_t width, int64_t count, int rle4,
                           uint8_t *out) {
  std::vector<uint8_t> data;
  data.reserve(count);
  int64_t x = 0;
  while ((int64_t)data.size() < count) {
    if (pos + 2 > n) break;
    int pixels = src[pos], byte = src[pos + 1];
    pos += 2;
    if (pixels) {
      int64_t num = pixels;
      if (x + num > width) num = width - x > 0 ? width - x : 0;
      for (int64_t i = 0; i < num; i++)
        data.push_back(rle4 ? (uint8_t)(i % 2 == 0 ? byte >> 4 : byte & 15)
                            : (uint8_t)byte);
      x += num;
    } else if (byte == 0) {
      while (data.size() % width) data.push_back(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (pos + 2 > n) break;
      pos += 2;
      int right = pos < n ? src[pos] : 0;
      int up = pos + 1 < n ? src[pos + 1] : 0;
      pos = pos + 2 <= n ? pos + 2 : n;
      data.insert(data.end(), right + (int64_t)up * width, 0);
      x = data.size() % width;
    } else {
      int64_t want = rle4 ? byte / 2 : byte;
      int64_t got = pos + want <= n ? want : n - pos;
      for (int64_t i = 0; i < got; i++) {
        uint8_t b = src[pos + i];
        if (rle4) {
          data.push_back(b >> 4);
          data.push_back(b & 15);
        } else {
          data.push_back(b);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) pos++;
    }
  }
  int64_t m = (int64_t)data.size() < count ? (int64_t)data.size() : count;
  memcpy(out, data.data(), m);
  return m;
}

extern "C" int64_t netpbm_plain(const uint8_t *src, int64_t n, int bitonal,
                                int32_t *out, int64_t count) {
  int64_t got = 0, pos = 0;
  auto space = [](uint8_t c) { return c == ' ' || (c >= 9 && c <= 13); };
  auto comment = [&]() {  // from '#' through the line's end
    while (pos < n && src[pos] != '\n' && src[pos] != '\r') pos++;
    pos++;
  };
  while (got < count && pos < n) {
    uint8_t c = src[pos];
    if (c == '#') {
      comment();
      continue;
    }
    if (space(c)) {
      pos++;
      continue;
    }
    if (bitonal) {
      if (c != '0' && c != '1') return -1;
      out[got++] = c - '0';
      pos++;
      continue;
    }
    int64_t v = 0;
    int len = 0;
    while (pos < n) {
      c = src[pos];
      if (c == '#') {
        comment();
        continue;
      }
      if (space(c)) break;
      if (c < '0' || c > '9' || ++len > 10) return -1;
      v = v * 10 + (c - '0');
      pos++;
    }
    if (v > 0x7FFFFFFF) return -1;
    out[got++] = (int32_t)v;
  }
  return got;
}

extern "C" int64_t tga_rle(const uint8_t *src, int64_t n, int depth,
                           int64_t row_bytes, uint8_t *out, int64_t count) {
  int64_t pos = 0, got = 0;
  while (got < count && pos < n) {
    int head = src[pos++];
    int64_t len = (int64_t)depth * ((head & 0x7F) + 1);
    if (head & 0x80) {
      if (pos + depth > n) break;
      if (got % row_bytes + len > row_bytes) return -1;
      for (int64_t i = 0; i < len && got < count; i++)
        out[got++] = src[pos + i % depth];
      pos += depth;
    } else {
      if (pos + len > n) break;
      int64_t m = len < count - got ? len : count - got;
      memcpy(out + got, src + pos, m);
      got += m;
      pos += len;
    }
  }
  return got;
}

extern "C" int64_t qoi_decode(const uint8_t *src, int64_t n, int channels,
                              uint8_t *out, int64_t pixels) {
  uint8_t index[64][4];
  memset(index, 0, sizeof(index));
  uint8_t px[4] = {0, 0, 0, 255};
  int64_t pos = 0, got = 0;
  auto emit = [&](const uint8_t *p) {
    memcpy(out + got * channels, p, channels);
    got++;
  };
  while (got < pixels) {
    if (pos >= n) return -1;
    int b = src[pos++];
    if (b == 0xFE || b == 0xFF) {  // RGB, RGBA
      int k = b == 0xFE ? 3 : 4;
      if (pos + k > n) return -1;
      memcpy(px, src + pos, k);
      pos += k;
    } else if ((b >> 6) == 0) {  // index
      memcpy(px, index[b & 63], 4);
    } else if ((b >> 6) == 1) {  // diff
      px[0] = (uint8_t)(px[0] + ((b >> 4) & 3) - 2);
      px[1] = (uint8_t)(px[1] + ((b >> 2) & 3) - 2);
      px[2] = (uint8_t)(px[2] + (b & 3) - 2);
    } else if ((b >> 6) == 2) {  // luma
      if (pos >= n) return -1;
      int b2 = src[pos++];
      int dg = (b & 63) - 32;
      px[0] = (uint8_t)(px[0] + dg + ((b2 >> 4) & 15) - 8);
      px[1] = (uint8_t)(px[1] + dg);
      px[2] = (uint8_t)(px[2] + dg + (b2 & 15) - 8);
    } else {  // run: not entered into the index
      for (int r = (b & 63) + 1; r > 0 && got < pixels; r--) emit(px);
      continue;
    }
    memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px,
           4);
    emit(px);
  }
  return got;
}
