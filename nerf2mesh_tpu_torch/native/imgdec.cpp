// Inner loops of the BMP, TIFF, GIF, netpbm, TGA, QOI, SGI and PCX readers
// (data/bmp.py, tiff.py, gif.py, netpbm.py, tga.py, qoi.py, sgi.py,
// pcx.py): the LZW variants of TIFF and GIF, PackBits, TIFF's horizontal
// predictor, the CCITT fax and ThunderScan codecs as libtiff decodes them,
// the BMP RLE8/RLE4 decoder as Pillow's BmpRleDecoder reads it (the array
// JAX's providers see), the plain (ASCII) netpbm samples, TGA's RLE
// packets, the QOI operations, the SGI and PCX run-length codes,
// PackBits in rows (PSD's channels, data/psd.py), ICNS's RLE, the Sun
// raster RLE and the FLI/FLC frame chunks as Pillow's decoders read them.
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
//   int64_t fax_decode(const uint8_t *src, int64_t n, int mode,
//                      int64_t width, int64_t rows, int64_t rowbytes,
//                      uint8_t *out)
//     one strip or tile of CCITT data as libtiff's tif_fax3.c decodes it
//     (mode 0 modified Huffman, 1 the same word-aligned (RLEW), 2 Group 3
//     1-D, 3 Group 3 2-D, 4 Group 4): rows of rowbytes bytes, black runs
//     as 1 bits, MSB first; src in fill order 1.  Returns the rows written,
//     or -1 where libtiff's decoder fails; a damaged row is repaired as
//     libtiff repairs it (the rest of the row in the colour at the damage).
//   int64_t thunder_decode(const uint8_t *src, int64_t n, int64_t width,
//                          int64_t rows, int64_t rowbytes, uint8_t *out)
//     ThunderScan 4-bit rows (tif_thunder.c); -1 when a row has too few or
//     too many pixels.
//   int64_t sgi_rle(const uint8_t *src, int64_t n, int64_t xsize,
//                   int64_t ysize, int bands, int bpc, uint8_t *out)
//     SGI RLE as SgiRleDecode.c reads it: src is the file from byte 512 on,
//     out ysize rows (in file order) of xsize * bands * bpc bytes; returns
//     the rows stored, or -1 on a run past a row or the data.
//   int64_t pcx_rle(const uint8_t *src, int64_t n, int64_t line,
//                   int64_t rows, uint8_t *out)
//     PCX RLE (PcxDecode.c) into rows of line bytes; returns the rows
//     written (fewer when the data ends first), -1 on a run past a line.
//   int64_t packbits_rows(const uint8_t *src, int64_t n, int64_t rowbytes,
//                         int64_t rows, uint8_t *out)
//     PackBits as PackbitsDecode.c reads it: a run or literal that passes
//     a row's end is cut there (the rest of it dropped), 128 is a no-op,
//     a packet is taken only whole; returns the bytes read when the rows
//     are full, or -1 when the data ends first.
//   int64_t icns_rle(const uint8_t *src, int64_t n, int64_t pos,
//                    int64_t count, uint8_t *out)
//     an ICNS 24-bit entry's three bands of count bytes each as Pillow's
//     IcnsImagePlugin.read_32 reads them, one band after the other from
//     src[pos:] (the whole file): a byte with the high bit set is a run of
//     (byte - 125) copies of the next byte, any other a literal of byte + 1
//     bytes; -1 when a band's packets do not sum to count (one ends short
//     or a run crosses its end) or the file ends inside a band.
//   int64_t sun_rle(const uint8_t *src, int64_t n, int64_t total,
//                   uint8_t *out)
//     Sun raster type 2 (SunRleDecode.c) into total bytes of rows: 0x80 0
//     is a literal 0x80, 0x80 c v a run of c + 1 bytes v (going on across
//     rows, cut at the image's end), any other byte a literal; returns the
//     bytes read, or -1 when the data ends before the image is full.
//   int64_t fli_frame(const uint8_t *src, int64_t n, int64_t width,
//                     int64_t height, uint8_t *out)
//     one FLI/FLC frame (FliDecode.c) from its 16-byte header, applied to
//     out (height rows of width indices): COLOR256 (4), COLOR64 (11) and
//     PSTAMP (18) skipped, SS2 (7) word deltas, LC (12) byte deltas, BLACK
//     (13), BRUN (15) and COPY (16).  Returns -1 when the frame is done,
//     the bytes consumed (>= 0) when n is too short for it (Pillow reads
//     more), -2 on a chunk past the data or a line it cannot finish, -3 on
//     a header that is not a frame's or an unknown chunk, -4 on a chunk of
//     size 0.
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

namespace {

// tif_fax3.c's decoder state tables (mkg3states.c): each entry of a
// table of 2^bits is indexed by the next bits of the stream, first bit
// lowest (libtiff reverses each byte of fill order 1 as it loads it).
enum {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};
struct FaxEnt {
  uint8_t state, width;
  uint16_t param;
};
struct FaxCode {
  const char *bits;
  int param;
};

// ITU-T T.4 tables 2 and 3: terminating codes 0-63 and make-up codes
const char *const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
    "0000011", "0000100", "0101000", "0101011", "0010011", "0100100",
    "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100",
    "00000101", "00001010", "00001011", "01010010", "01010011", "01010100",
    "01010101", "00100100", "00100101", "01011000", "01011001", "01011010",
    "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
const char *const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
// make-up codes for 64, 128, ..., 1728
const char *const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char *const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
// the make-up codes of both colours, 1792, 1856, ..., 2560
const char *const kExtMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

FaxEnt g_main[128], g_white[4096], g_black[8192];

void fill_table(FaxEnt *t, int bits, const char *code, int state, int param) {
  int width = (int)strlen(code), rev = 0;
  for (int i = 0; i < width; i++) rev |= (code[i] == '1') << i;
  for (int idx = rev; idx < (1 << bits); idx += 1 << width)
    t[idx] = FaxEnt{(uint8_t)state, (uint8_t)width, (uint16_t)param};
}

void build_fax_tables() {
  // mkg3states.c: the 2-D modes, and an EOL as the 7 (main) or 11
  // (white, black) zeros that begin one
  static const FaxCode modes[] = {{"0001", 0}, {"001", 0}, {"1", 0},
                                  {"011", 1},  {"000011", 2}, {"0000011", 3},
                                  {"010", 1},  {"000010", 2}, {"0000010", 3},
                                  {"0000001", 0}, {"0000000", 0}};
  static const int mode_states[] = {S_Pass, S_Horiz, S_V0, S_VR, S_VR, S_VR,
                                    S_VL,   S_VL,    S_VL, S_Ext, S_EOL};
  for (int i = 0; i < 11; i++)
    fill_table(g_main, 7, modes[i].bits, mode_states[i], modes[i].param);
  for (int i = 0; i < 64; i++) {
    fill_table(g_white, 12, kWhiteTerm[i], S_TermW, i);
    fill_table(g_black, 13, kBlackTerm[i], S_TermB, i);
  }
  for (int i = 0; i < 27; i++) {
    fill_table(g_white, 12, kWhiteMakeUp[i], S_MakeUpW, 64 * (i + 1));
    fill_table(g_black, 13, kBlackMakeUp[i], S_MakeUpB, 64 * (i + 1));
  }
  for (int i = 0; i < 13; i++) {
    fill_table(g_white, 12, kExtMakeUp[i], S_MakeUp, 1792 + 64 * i);
    fill_table(g_black, 13, kExtMakeUp[i], S_MakeUp, 1792 + 64 * i);
  }
  fill_table(g_white, 12, "00000000000", S_EOL, 0);
  fill_table(g_black, 13, "00000000000", S_EOL, 0);
}

uint8_t g_rev[256];

void init_fax() {
  static bool done = false;  // the tables are the same for every caller
  if (done) return;
  for (int i = 0; i < 256; i++) {
    int r = 0;
    for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
    g_rev[i] = (uint8_t)r;
  }
  build_fax_tables();
  done = true;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run
// past lastx is cut to it, in the run array too (the next row's reference)
void fill_runs(uint8_t *buf, uint32_t *runs, uint32_t *erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  auto paint = [&](uint32_t from, uint32_t len, bool black) {
    for (uint32_t i = from; i < from + len; i++) {
      uint8_t m = (uint8_t)(0x80 >> (i & 7));
      if (black)
        buf[i >> 3] |= m;
      else
        buf[i >> 3] &= (uint8_t)~m;
    }
  };
  for (; runs < erun; runs += 2) {
    uint32_t run = runs[0];
    if (x + run > lastx || run > lastx) run = runs[0] = lastx - x;
    if (run) {
      paint(x, run, false);
      x += run;
    }
    run = runs[1];
    if (x + run > lastx || run > lastx) run = runs[1] = lastx - x;
    if (run) {
      paint(x, run, true);
      x += run;
    }
  }
}

// tif_fax3.c's Fax3DecodeRLE / Fax3Decode1D / Fax3Decode2D / Fax4Decode
// for one strip, macro for macro (their names in the comments)
struct FaxDecoder {
  const uint8_t *cp, *ep;
  uint32_t acc = 0;
  int avail = 0;
  int eolcnt = 0;
  int64_t a0 = 0, lastx, run_length = 0;
  uint32_t nruns;
  std::vector<uint32_t> runs;
  uint32_t *thisrun = nullptr, *pa = nullptr, *pb = nullptr, *refruns = nullptr;
  int64_t b1 = 0;

  bool eod() const { return cp >= ep; }
  // NeedBits8 / NeedBits16: false at the end of the data with no bit left;
  // past the end, zeros
  bool need8(int n) {
    if (avail < n) {
      if (eod()) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)g_rev[*cp++] << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (eod()) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)g_rev[*cp++] << avail;
        if ((avail += 8) < n) {
          if (eod()) {
            avail = n;
          } else {
            acc |= (uint32_t)g_rev[*cp++] << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  // SETVALUE; false on a run array overflow (libtiff fails the strip)
  bool setvalue(int64_t x) {
    if (pa >= thisrun + nruns) return false;
    *pa++ = (uint32_t)(run_length + x);
    a0 += x;
    run_length = 0;
    return true;
  }
  // CLEANUP_RUNS: a row cut short is padded to lastx
  bool cleanup() {
    if (run_length && !setvalue(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (((pa - thisrun) & 1) && !setvalue(0)) return false;
        if (!setvalue(lastx - a0)) return false;
      } else if (a0 > lastx) {
        if (!setvalue(lastx) || !setvalue(0)) return false;
      }
    }
    return true;
  }
  // SYNC_EOL; false at the end of the data
  bool sync_eol() {
    if (eolcnt == 0) {
      for (;;) {
        if (!need16(11)) return false;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) return false;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
    return true;
  }
  // one colour's run through `table` (bits wide); 0 done (terminating
  // code), 1 an EOL, 2 a bad code, 3 the end of the data, 4 overflow
  int run(const FaxEnt *table, int bits, int term, int makeup) {
    for (;;) {
      if (!need16(bits)) return 3;
      const FaxEnt &e = table[get(bits)];
      clr(e.width);
      if (e.state == term) return setvalue(e.param) ? 0 : 4;
      if (e.state == makeup || e.state == S_MakeUp) {
        a0 += e.param;
        run_length += e.param;
      } else {
        return e.state == S_EOL ? 1 : 2;
      }
    }
  }
  // EXPAND1D: 0 the row is done, 1 the end of the data, -1 overflow
  int expand1d() {
    for (;;) {
      int r = run(g_white, 12, S_TermW, S_MakeUpW);
      if (r == 1) eolcnt = 1;
      if (r == 3) return cleanup() ? 1 : -1;
      if (r == 4) return -1;
      if (r != 0 || a0 >= lastx) break;
      r = run(g_black, 13, S_TermB, S_MakeUpB);
      if (r == 1) eolcnt = 1;
      if (r == 3) return cleanup() ? 1 : -1;
      if (r == 4) return -1;
      if (r != 0 || a0 >= lastx) break;
      if (pa[-1] == 0 && pa[-2] == 0) pa -= 2;
    }
    return cleanup() ? 0 : -1;
  }
  // CHECK_b1; false on overflow
  bool check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) return false;
        b1 += pb[0] + pb[1];
        pb += 2;
      }
    return true;
  }
  // EXPAND2D: 0 the row is done, 1 the end of the data, -1 a failure
  int expand2d() {
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return -1;
      if (!need8(7)) return cleanup() ? 1 : -1;
      const FaxEnt &e = g_main[get(7)];
      clr(e.width);
      switch (e.state) {
        case S_Pass:
          if (!check_b1() || pb >= refruns + nruns) return -1;
          b1 += *pb++;
          run_length += b1 - a0;
          a0 = b1;
          b1 += *pb++;
          break;
        case S_Horiz: {
          bool black_first = (pa - thisrun) & 1;
          for (int k = 0; k < 2; k++) {
            bool black = black_first != (k == 1);
            int r = black ? run(g_black, 13, S_TermB, S_MakeUpB)
                          : run(g_white, 12, S_TermW, S_MakeUpW);
            if (r == 3) return cleanup() ? 1 : -1;
            if (r == 4) return -1;
            if (r != 0) return cleanup() ? 0 : -1;  // badBlack2d/badWhite2d
          }
          if (!check_b1()) return -1;
          break;
        }
        case S_V0:
        case S_VR:
          if (!check_b1()) return -1;
          if (!setvalue(b1 - a0 + (e.state == S_VR ? e.param : 0)))
            return -1;
          if (pb >= refruns + nruns) return -1;
          b1 += *pb++;
          break;
        case S_VL:
          if (!check_b1()) return -1;
          if (b1 < a0 + e.param) return cleanup() ? 0 : -1;
          if (!setvalue(b1 - a0 - e.param)) return -1;
          b1 -= *--pb;
          break;
        case S_Ext:  // uncompressed mode: libtiff reports it and ends the row
          *pa++ = (uint32_t)(lastx - a0);
          return cleanup() ? 0 : -1;
        case S_EOL:
          *pa++ = (uint32_t)(lastx - a0);
          if (!need8(4)) return cleanup() ? 1 : -1;
          clr(4);
          eolcnt = 1;
          return cleanup() ? 0 : -1;
        default:  // badMain2d
          return cleanup() ? 0 : -1;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {  // expect a final V0
        if (!need8(1)) return cleanup() ? 1 : -1;
        if (!get(1)) return cleanup() ? 0 : -1;
        clr(1);
      }
      if (!setvalue(0)) return -1;
    }
    return cleanup() ? 0 : -1;
  }
};

}  // namespace

extern "C" int64_t fax_decode(const uint8_t *src, int64_t n, int mode,
                              int64_t width, int64_t rows, int64_t rowbytes,
                              uint8_t *out) {
  init_fax();
  FaxDecoder d;
  d.cp = src;
  d.ep = src + n;
  d.lastx = width;
  bool twod = mode >= 3;
  // Fax3SetupState: roundup(rowpixels + 1, 32) runs, twice with a
  // reference line; the reference starts as one white run
  uint64_t nr = ((uint64_t)width + 1 + 31) / 32 * 32;
  if (twod) nr *= 2;
  d.nruns = (uint32_t)nr;
  d.runs.assign(2 * nr + 2, 0);
  uint32_t *cur = d.runs.data(), *ref = twod ? d.runs.data() + nr : nullptr;
  if (ref) {
    ref[0] = (uint32_t)width;
    ref[1] = 0;
  }
  d.refruns = ref;
  for (int64_t line = 0; line < rows; line++) {
    uint8_t *buf = out + line * rowbytes;
    d.a0 = 0;
    d.run_length = 0;
    d.thisrun = d.pa = cur;
    if (mode <= 1) {  // Fax3DecodeRLE
      int r = d.expand1d();
      if (r < 0) return -1;
      fill_runs(buf, d.thisrun, d.pa, (uint32_t)width);
      if (r == 1) return -1;
      if (mode == 0) {
        d.clr(d.avail - (d.avail & ~7));
      } else {
        d.clr(d.avail - (d.avail & ~15));
        if (d.avail == 0 && ((d.cp - src) & 1)) d.cp++;
      }
      continue;
    }
    if (mode == 2) {  // Fax3Decode1D
      if (!d.sync_eol()) return -1;
      int r = d.expand1d();
      if (r < 0) return -1;
      fill_runs(buf, d.thisrun, d.pa, (uint32_t)width);
      if (r == 1) return -1;
      continue;
    }
    d.pb = ref;
    int r;
    if (mode == 3) {  // Fax3Decode2D
      if (!d.sync_eol() || !d.need8(1)) return -1;
      int is1d = (int)d.get(1);
      d.clr(1);
      d.b1 = *d.pb++;
      r = is1d ? d.expand1d() : d.expand2d();
      if (r < 0) return -1;
      fill_runs(buf, d.thisrun, d.pa, (uint32_t)width);
      if (r == 1) return -1;
      if (d.pa < d.thisrun + d.nruns && !d.setvalue(0)) return -1;
    } else {  // Fax4Decode
      d.b1 = *d.pb++;
      r = d.expand2d();
      if (r < 0) return -1;
      if (r == 1 || d.eolcnt) {  // EOFG4: the end of the data, or an EOL
        d.need16(13);
        d.clr(13);
        fill_runs(buf, d.thisrun, d.pa, (uint32_t)width);
        return line > 0 ? line + 1 : -1;
      }
      fill_runs(buf, d.thisrun, d.pa, (uint32_t)width);
      if (!d.setvalue(0)) return -1;
    }
    std::swap(cur, ref);
    d.refruns = ref;
  }
  return rows;
}

// tif_thunder.c's ThunderDecode, row by row
extern "C" int64_t thunder_decode(const uint8_t *src, int64_t n, int64_t width,
                                  int64_t rows, int64_t rowbytes,
                                  uint8_t *out) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  int64_t pos = 0;
  for (int64_t row = 0; row < rows; row++) {
    uint8_t *op = out + row * rowbytes;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    auto setpixel = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < width) {
        if (npixels++ & 1)
          *op++ |= (uint8_t)lastpixel;
        else
          op[0] = (uint8_t)(lastpixel << 4);
      }
    };
    while (pos < n && npixels < width) {
      int c = src[pos++], delta;
      switch (c & 0xc0) {
        case 0x00: {  // a run of the last pixel
          int k = c & 0x3f;
          if (npixels & 1) {
            op[0] |= (uint8_t)lastpixel;
            lastpixel = *op++;
            npixels++;
            k--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += k;
          if (npixels <= width)
            for (; k > 0; k -= 2) *op++ = (uint8_t)lastpixel;
          if (k == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        }
        case 0x40:  // three 2-bit deltas
          if ((delta = (c >> 4) & 3) != 2) setpixel(lastpixel + two[delta]);
          if ((delta = (c >> 2) & 3) != 2) setpixel(lastpixel + two[delta]);
          if ((delta = c & 3) != 2) setpixel(lastpixel + two[delta]);
          break;
        case 0x80:  // two 3-bit deltas
          if ((delta = (c >> 3) & 7) != 4) setpixel(lastpixel + three[delta]);
          if ((delta = c & 7) != 4) setpixel(lastpixel + three[delta]);
          break;
        default:  // raw
          setpixel((unsigned)c);
      }
    }
    if (npixels != width) return -1;
  }
  return rows;
}

// SgiRleDecode.c's expandrow / expandrow2: 0 the row is done, 1 it ended
// on a non-zero last byte (the decoder stops there), -1 an overrun; `end`
// is the index of the data's last byte
int sgi_row(uint8_t *dest, const uint8_t *base, int64_t src, int64_t n,
            int z, int64_t xsize, int64_t end, int bpc) {
  int64_t x = 0;
  for (; n > 0; n--) {
    if (src + bpc - 1 > end) return -1;
    int pixel = base[src + bpc - 1];
    src += bpc;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + (int64_t)bpc * count > end) return -1;
      while (count--) {
        memcpy(dest, base + src, bpc);
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (src + bpc - 1 > end) return -1;
      while (count--) {
        memcpy(dest, base + src, bpc);
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

extern "C" int64_t sgi_rle(const uint8_t *src, int64_t n, int64_t xsize,
                           int64_t ysize, int bands, int bpc, uint8_t *out) {
  const int64_t tablen = (int64_t)bands * ysize;
  if (n < 8 * tablen) return -1;
  auto word = [&](int64_t i) {
    return (uint32_t)src[i] << 24 | (uint32_t)src[i + 1] << 16 |
           (uint32_t)src[i + 2] << 8 | src[i + 3];
  };
  // one row buffer for every row, as the decoder keeps it (a row whose
  // runs stop short keeps the row before's samples)
  const int64_t row_bytes = xsize * bands * bpc;
  std::vector<uint8_t> row(row_bytes, 0);
  for (int64_t y = 0; y < ysize; y++) {
    for (int c = 0; c < bands; c++) {
      int64_t t = y + c * ysize;
      int64_t off = word(4 * t), len = word(4 * (tablen + t));
      if (off < 512) return -1;
      off -= 512;
      if (off + len > n) return -1;
      int r = sgi_row(row.data() + c * bpc, src, off, len, bands, xsize,
                      n - 1, bpc);
      if (r < 0) return -1;
      if (r == 1) return y;
    }
    memcpy(out + y * row_bytes, row.data(), row_bytes);
  }
  return ysize;
}

extern "C" int64_t pcx_rle(const uint8_t *src, int64_t n, int64_t line,
                           int64_t rows, uint8_t *out) {
  int64_t pos = 0, x = 0, y = 0;
  uint8_t *buf = out;
  while (y < rows) {
    if (pos >= n) return y;
    if ((src[pos] & 0xC0) == 0xC0) {
      if (pos + 2 > n) return y;
      int k = src[pos] & 0x3F;
      for (; k > 0; k--) {
        if (x >= line) return -1;
        buf[x++] = src[pos + 1];
      }
      pos += 2;
    } else {
      buf[x++] = src[pos++];
    }
    if (x >= line) {
      x = 0;
      buf += line;
      y++;
    }
  }
  return y;
}

extern "C" int64_t packbits_rows(const uint8_t *src, int64_t n,
                                 int64_t rowbytes, int64_t rows,
                                 uint8_t *out) {
  int64_t pos = 0, x = 0, y = 0;
  if (rows <= 0) return 0;
  uint8_t *row = out;
  for (;;) {
    if (pos >= n) return -1;
    int c = src[pos];
    if (c == 0x80) {
      pos++;
      continue;
    }
    if (c & 0x80) {
      if (pos + 2 > n) return -1;
      for (int k = 257 - c; k > 0 && x < rowbytes; k--) row[x++] = src[pos + 1];
      pos += 2;
    } else {
      if (pos + c + 2 > n) return -1;
      for (int k = 1; k < c + 2 && x < rowbytes; k++) row[x++] = src[pos + k];
      pos += c + 2;
    }
    if (x >= rowbytes) {
      x = 0;
      row += rowbytes;
      if (++y >= rows) return pos;
    }
  }
}

extern "C" int64_t icns_rle(const uint8_t *src, int64_t n, int64_t pos,
                            int64_t count, uint8_t *out) {
  for (int band = 0; band < 3; band++) {
    uint8_t *dst = out + band * count;
    int64_t left = count, got = 0;
    while (left > 0 && pos < n) {
      int b = src[pos++];
      int64_t len;
      if (b & 0x80) {
        len = b - 125;
        if (pos < n) {
          int64_t k = len < count - got ? len : count - got;
          if (k > 0) memset(dst + got, src[pos], k);
          got += len;
          pos++;
        }
      } else {
        len = b + 1;
        int64_t avail = n - pos < len ? n - pos : len;
        int64_t k = avail < count - got ? avail : count - got;
        if (k > 0) memcpy(dst + got, src + pos, k);
        got += avail;
        pos += avail;
      }
      left -= len;
    }
    if (left != 0 || got != count) return -1;
  }
  return pos;
}

extern "C" int64_t sun_rle(const uint8_t *src, int64_t n, int64_t total,
                           uint8_t *out) {
  int64_t pos = 0, x = 0;
  while (x < total) {
    if (pos >= n) return -1;
    if (src[pos] != 0x80) {
      out[x++] = src[pos++];
      continue;
    }
    if (pos + 2 > n) return -1;
    int c = src[pos + 1];
    if (c == 0) {
      out[x++] = 0x80;
      pos += 2;
      continue;
    }
    if (pos + 3 > n) return -1;
    int64_t k = c + 1 < total - x ? c + 1 : total - x;
    memset(out + x, src[pos + 2], k);
    x += k;
    pos += 3;
  }
  return pos;
}

namespace {

inline int fli16(const uint8_t *p) { return p[0] | (p[1] << 8); }
inline int64_t fli32(const uint8_t *p) {
  return (int64_t)(p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24));
}

}  // namespace

extern "C" int64_t fli_frame(const uint8_t *src, int64_t n, int64_t width,
                             int64_t height, uint8_t *out) {
  const int64_t kOverrun = -2, kUnknown = -3, kBroken = -4;
  if (n < 4) return 0;
  const uint8_t *ptr = src;
  int64_t bytes = n;
  int64_t framesize = (int32_t)fli32(ptr);
  if (bytes + (bytes % 2) < framesize) return 0;
  if (bytes < 8) return kOverrun;
  if (fli16(ptr + 4) != 0xF1FA) return kUnknown;
  int chunks = fli16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) return kOverrun;
    const uint8_t *data = ptr + 6;
    const uint8_t *lim = ptr + bytes;
    switch (fli16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2: word deltas
        int lines = fli16(data);
        data += 2;
        int64_t l = 0, y = 0;
        for (; l < lines && y < height; l++, y++) {
          uint8_t *row = out + y * width;
          if (data + 2 > lim) return kOverrun;
          int packets = fli16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= height) return kOverrun;
              row = out + y * width;
            } else {
              row[width - 1] = (uint8_t)packets;
            }
            if (data + 2 > lim) return kOverrun;
            packets = fli16(data);
            data += 2;
          }
          int p = 0;
          int64_t x = 0;
          for (; p < packets; p++) {
            if (data + 2 > lim) return kOverrun;
            x += data[0];
            if (data[1] >= 128) {
              if (data + 4 > lim) return kOverrun;
              int64_t i = 256 - data[1];
              if (x + i + i > width) break;
              for (int64_t j = 0; j < i; j++) {
                row[x++] = data[2];
                row[x++] = data[3];
              }
              data += 4;
            } else {
              int64_t i = 2 * (int64_t)data[1];
              if (x + i > width) break;
              if (data + 2 + i > lim) return kOverrun;
              memcpy(row + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return kOverrun;
        break;
      }
      case 12: {  // LC: byte deltas
        int64_t y = fli16(data);
        int64_t ymax = y + fli16(data + 2);
        data += 4;
        for (; y < ymax && y < height; y++) {
          uint8_t *row = out + y * width;
          if (data + 1 > lim) return kOverrun;
          int packets = *data++;
          int p = 0;
          int64_t x = 0, i = 0;
          for (; p < packets; p++, x += i) {
            if (data + 2 > lim) return kOverrun;
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > width) break;
              if (data + 3 > lim) return kOverrun;
              memset(row + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > width) break;
              if (data + 2 + i > lim) return kOverrun;
              memcpy(row + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return kOverrun;
        break;
      }
      case 13:  // BLACK
        memset(out, 0, width * height);
        break;
      case 15:  // BRUN
        for (int64_t y = 0; y < height; y++) {
          uint8_t *row = out + y * width;
          int64_t x = 0, i = 0;
          data += 1;
          for (; x < width; x += i) {
            if (data + 2 > lim) return kOverrun;
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > width) break;
              if (data + i + 1 > lim) return kOverrun;
              memcpy(row + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > width) break;
              memset(row + x, data[1], i);
              data += 2;
            }
          }
          if (x != width) return kOverrun;
        }
        break;
      case 16:  // COPY
        if (data + width * height > lim) return ptr - src;
        memcpy(out, data, width * height);
        break;
      default:
        return kUnknown;
    }
    int64_t advance = (int32_t)fli32(ptr);
    if (advance == 0) return kBroken;
    if (advance < 0 || advance > bytes) return kOverrun;
    ptr += advance;
    bytes -= advance;
  }
  return -1;
}
