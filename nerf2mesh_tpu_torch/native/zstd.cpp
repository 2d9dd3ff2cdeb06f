// A Zstandard codec (RFC 8878) without libzstd, for the Orbax/OCDBT
// checkpoint store (utils/ocdbt.py, utils/zarr.py), and the CRC-32C that
// OCDBT puts at the end of every manifest and B+tree node.
//
// Decoder: every frame libzstd writes without a dictionary.
//   * raw, RLE and compressed blocks; frames one after another, skippable
//     frames between them; the frame content size and single-segment forms;
//   * literals raw, RLE, Huffman-coded with 1 or 4 streams, with their own
//     table (its weights direct or FSE-coded) or the previous block's
//     (treeless);
//   * sequences with predefined, RLE, FSE-coded or repeated tables, and the
//     three repeat offsets;
//   * the XXH64 content checksum, checked when the frame carries one.
// Every read is bounds-checked: corrupt input gives an error, never a read
// outside the input or a write outside the output.  A frame that names a
// dictionary is refused.
//
// Encoder: one frame of raw and RLE blocks (runs of 64 or more equal bytes
// become RLE blocks), with the content size and, when asked, the checksum.
// Valid zstd that any decoder reads; it does not compress otherwise.
//
// C interface (ctypes):
//   int64_t zstd_content_size(const uint8_t *src, int64_t n)
//       the summed content size of the frames, -1 when a frame does not
//       state it, -2 when the input is not zstd
//   int64_t zstd_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
//                           int64_t cap, char *err, int errlen)
//       the decompressed size, -1 on corrupt input (err says why), -2 when
//       cap is too small
//   int64_t zstd_compress_bound(int64_t n)
//   int64_t zstd_compress(const uint8_t *src, int64_t n, uint8_t *dst,
//                         int64_t cap, int checksum)
//       the frame's size, -2 when cap is too small
//   uint64_t zstd_xxh64(const uint8_t *src, int64_t n, uint64_t seed)
//   uint32_t crc32c(const uint8_t *src, int64_t n)
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string &msg) { throw Error{msg}; }

struct OutOfRoom {};

inline uint32_t le32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline uint64_t le64(const uint8_t *p) {
  return (uint64_t)le32(p) | ((uint64_t)le32(p + 4) << 32);
}

inline int highbit(uint64_t x) { return 63 - __builtin_clzll(x); }

// ------------------------------------------------------------------ XXH64
const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
               P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
               P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}

inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t *p, int64_t n, uint64_t seed) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t *limit = end - 32;
    do {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h ^= xround(0, le64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)le32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ----------------------------------------------------------------- CRC-32C
uint32_t g_crc[8][256];

void init_crc() {
  static bool done = false;
  if (done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    g_crc[0][i] = c;
  }
  for (int t = 1; t < 8; t++)
    for (int i = 0; i < 256; i++)
      g_crc[t][i] = (g_crc[t - 1][i] >> 8) ^ g_crc[0][g_crc[t - 1][i] & 255];
  done = true;
}

// ------------------------------------------------------------- bit readers
// Forward, least significant bit first: FSE table descriptions.
struct FwdBits {
  const uint8_t *s;
  int64_t n, pos = 0;  // pos in bits
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; i++, pos++) {
      if ((pos >> 3) >= n) fail("truncated FSE table description");
      v |= (uint32_t)((s[pos >> 3] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
};

// Backward: Huffman streams and the sequences bitstream.  `off` is the
// bit position below which bits are still unread; reads past the start
// give zeros (off goes negative) and the callers check where it ended.
struct BackBits {
  const uint8_t *s = nullptr;
  int64_t n = 0, off = 0;
  void init(const uint8_t *src, int64_t len) {
    if (len < 1) fail("empty bitstream");
    uint8_t last = src[len - 1];
    if (!last) fail("bitstream without its end mark");
    s = src;
    n = len;
    off = (len - 1) * 8 + highbit(last);
  }
  uint64_t get(int64_t pos, int k) const {
    int64_t byte = pos >> 3;
    uint64_t v = 0;
    int64_t avail = n - byte;
    if (avail >= 8) {
      memcpy(&v, s + byte, 8);
    } else {
      for (int64_t i = 0; i < avail; i++) v |= (uint64_t)s[byte + i] << (8 * i);
    }
    v >>= (pos & 7);
    return v & ((1ULL << k) - 1);
  }
  uint64_t read(int k) {  // k <= 56
    if (k == 0) return 0;
    off -= k;
    if (off >= 0) return get(off, k);
    if (off <= -k) return 0;
    return get(0, (int)(k + off)) << (-off);
  }
};

// ------------------------------------------------------------------- FSE
struct FSE {
  int log = -1;
  std::vector<uint8_t> sym, nb;
  std::vector<uint16_t> base;
};

void fse_build(FSE &t, const int16_t *norm, int nsym, int log) {
  int size = 1 << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.nb.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
  int high = size - 1;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      if (high < 0) fail("bad FSE distribution");
      t.sym[high--] = (uint8_t)s;
      next[s] = 1;
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = (uint16_t)norm[s];
    for (int i = 0; i < norm[s]; i++) {
      t.sym[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail("bad FSE distribution");
  for (int i = 0; i < size; i++) {
    int s = t.sym[i];
    uint32_t x = next[s]++;
    if (x == 0) fail("bad FSE distribution");
    int bits = log - highbit(x);
    t.nb[i] = (uint8_t)bits;
    t.base[i] = (uint16_t)((x << bits) - size);
  }
}

// Reads an FSE table description; returns the bytes it took.
int64_t fse_read(FSE &t, const uint8_t *src, int64_t n, int max_log,
                 int max_sym) {
  FwdBits br{src, n};
  int log = (int)br.read(4) + 5;
  if (log > max_log) fail("FSE accuracy log too large");
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      int r;
      do {
        r = (int)br.read(2);
        for (int i = 0; i < r; i++) {
          if (sym > max_sym) fail("FSE distribution past its last symbol");
          norm[sym++] = 0;
        }
      } while (r == 3);
    }
    if (sym > max_sym) fail("FSE distribution past its last symbol");
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.read(nbits - 1);
    if ((int)low < max) {
      count = (int)low;
    } else {
      count = (int)(low | (br.read(1) << (nbits - 1)));
      if (count >= threshold) count -= max;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = count == 0;
    if (remaining < 1) fail("bad FSE distribution");
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("bad FSE distribution");
  fse_build(t, norm, sym, log);
  return (br.pos + 7) >> 3;
}

void fse_rle(FSE &t, uint8_t s) {
  t.log = 0;
  t.sym.assign(1, s);
  t.nb.assign(1, 0);
  t.base.assign(1, 0);
}

// --------------------------------------------------------------- Huffman
struct Huf {
  int maxbits = 0;
  bool defined = false;
  std::vector<uint8_t> sym, nb;
};

void huf_build(Huf &h, const uint8_t *w, int nw) {
  // nw weights given; the last symbol's weight is implied
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > 11) fail("Huffman weight too large");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman table without weights");
  int maxbits = highbit(total) + 1;
  if (maxbits > 11) fail("Huffman table too deep");
  uint32_t rest = (1u << maxbits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not sum to a power of 2");
  uint8_t weights[256];
  memcpy(weights, w, nw);
  weights[nw] = (uint8_t)(highbit(rest) + 1);
  int nsym = nw + 1;
  uint8_t bits[256];
  int count[13] = {0};
  for (int i = 0; i < nsym; i++) {
    bits[i] = weights[i] ? (uint8_t)(maxbits + 1 - weights[i]) : 0;
    count[bits[i]]++;
  }
  int size = 1 << maxbits;
  h.sym.assign(size, 0);
  h.nb.assign(size, 0);
  int start[13];
  start[maxbits] = 0;
  for (int b = maxbits; b >= 1; b--) {
    start[b - 1] = start[b] + count[b] * (1 << (maxbits - b));
    if (start[b - 1] > size) fail("bad Huffman table");
    for (int i = start[b]; i < start[b - 1]; i++) h.nb[i] = (uint8_t)b;
  }
  if (start[0] != size) fail("bad Huffman table");
  for (int i = 0; i < nsym; i++) {
    if (!bits[i]) continue;
    int len = 1 << (maxbits - bits[i]);
    int code = start[bits[i]];
    for (int k = 0; k < len; k++) h.sym[code + k] = (uint8_t)i;
    start[bits[i]] += len;
  }
  h.maxbits = maxbits;
  h.defined = true;
}

// Reads a Huffman tree description; returns the bytes it took.
int64_t huf_read(Huf &h, const uint8_t *src, int64_t n) {
  if (n < 1) fail("truncated Huffman tree description");
  int hb = src[0];
  uint8_t w[256];
  int nw = 0;
  if (hb >= 128) {
    nw = hb - 127;
    int64_t bytes = (nw + 1) / 2;
    if (1 + bytes > n) fail("truncated Huffman weights");
    for (int i = 0; i < nw; i++) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    huf_build(h, w, nw);
    return 1 + bytes;
  }
  if (1 + hb > n || hb == 0) fail("truncated Huffman weights");
  const uint8_t *p = src + 1;
  FSE t;
  int64_t hl = fse_read(t, p, hb, 6, 255);
  if (hl >= hb) fail("bad Huffman weights");
  BackBits br;
  br.init(p + hl, hb - hl);
  uint32_t s1 = (uint32_t)br.read(t.log), s2 = (uint32_t)br.read(t.log);
  while (true) {
    if (nw > 254) fail("too many Huffman weights");
    w[nw++] = t.sym[s1];
    s1 = t.base[s1] + (uint32_t)br.read(t.nb[s1]);
    if (br.off < 0) {
      w[nw++] = t.sym[s2];
      break;
    }
    if (nw > 254) fail("too many Huffman weights");
    w[nw++] = t.sym[s2];
    s2 = t.base[s2] + (uint32_t)br.read(t.nb[s2]);
    if (br.off < 0) {
      if (nw > 254) fail("too many Huffman weights");
      w[nw++] = t.sym[s1];
      break;
    }
  }
  huf_build(h, w, nw);
  return 1 + hb;
}

void huf_stream(const Huf &h, const uint8_t *src, int64_t n, uint8_t *out,
                int64_t count) {
  BackBits br;
  br.init(src, n);
  int mb = h.maxbits;
  uint32_t mask = (1u << mb) - 1;
  uint32_t state = (uint32_t)br.read(mb);
  for (int64_t i = 0; i < count; i++) {
    out[i] = h.sym[state];
    int b = h.nb[state];
    state = ((state << b) | (uint32_t)br.read(b)) & mask;
  }
  if (br.off != -mb) fail("Huffman stream not consumed exactly");
}

// ------------------------------------------------------------- sequences
const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,  12,   13,   14,   15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64,  128, 256, 512,  1024, 2048, 4096,
    8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,   17,
    18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,  29,   30,   31,   32,
    33, 34, 35, 37, 39, 41, 43, 47, 51,  59,  67,  83,   99,   131,  259,
    515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
  // the state carried from block to block within one frame
  Huf huf;
  FSE ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
};

struct Decoder {
  uint8_t *dst;
  int64_t cap, n = 0;      // output written
  int64_t frame_start = 0;  // where the current frame's output begins
  std::vector<uint8_t> lit;

  void need(int64_t k) {
    if (k < 0 || n + k > cap) throw OutOfRoom{};
  }

  // the sequences' table for one field from its mode; returns bytes read
  int64_t table(FSE &t, int mode, const uint8_t *p, int64_t avail,
                const int16_t *def, int ndef, int deflog, int max_log,
                int max_sym) {
    switch (mode) {
      case 0:
        fse_build(t, def, ndef, deflog);
        return 0;
      case 1:
        if (avail < 1) fail("truncated RLE sequence table");
        if (p[0] > max_sym) fail("RLE sequence symbol out of range");
        fse_rle(t, p[0]);
        return 1;
      case 2:
        return fse_read(t, p, avail, max_log, max_sym);
      default:
        if (t.log < 0) fail("repeated sequence table before any table");
        return 0;
    }
  }

  void block(Frame &fr, const uint8_t *b, int64_t bn) {
    if (bn < 1) fail("empty compressed block");
    // ---- literals section
    int ltype = b[0] & 3, sf = (b[0] >> 2) & 3;
    int64_t regen = 0, csize = 0, hdr = 0;
    int streams = 1;
    if (ltype < 2) {
      if (sf == 0 || sf == 2) {
        hdr = 1;
        regen = b[0] >> 3;
      } else if (sf == 1) {
        if (bn < 2) fail("truncated literals header");
        hdr = 2;
        regen = (b[0] >> 4) + ((int64_t)b[1] << 4);
      } else {
        if (bn < 3) fail("truncated literals header");
        hdr = 3;
        regen = (b[0] >> 4) + ((int64_t)b[1] << 4) + ((int64_t)b[2] << 12);
      }
    } else {
      if (sf < 2) {
        if (bn < 3) fail("truncated literals header");
        hdr = 3;
        uint32_t h = b[0] | (b[1] << 8) | (b[2] << 16);
        regen = (h >> 4) & 0x3FF;
        csize = (h >> 14) & 0x3FF;
        streams = sf == 0 ? 1 : 4;
      } else if (sf == 2) {
        if (bn < 4) fail("truncated literals header");
        hdr = 4;
        uint32_t h = le32(b);
        regen = (h >> 4) & 0x3FFF;
        csize = (h >> 18) & 0x3FFF;
        streams = 4;
      } else {
        if (bn < 5) fail("truncated literals header");
        hdr = 5;
        uint64_t h = le32(b) | ((uint64_t)b[4] << 32);
        regen = (h >> 4) & 0x3FFFF;
        csize = (h >> 22) & 0x3FFFF;
        streams = 4;
      }
    }
    if (regen > (1 << 17)) fail("literals larger than a block");
    const uint8_t *lits;
    int64_t pos = hdr;
    if (ltype == 0) {
      if (pos + regen > bn) fail("truncated raw literals");
      lits = b + pos;
      pos += regen;
    } else if (ltype == 1) {
      if (pos + 1 > bn) fail("truncated RLE literals");
      lit.assign(regen, b[pos]);
      lits = lit.data();
      pos += 1;
    } else {
      if (pos + csize > bn) fail("truncated compressed literals");
      const uint8_t *p = b + pos;
      int64_t avail = csize;
      if (ltype == 2) {
        int64_t t = huf_read(fr.huf, p, avail);
        p += t;
        avail -= t;
      } else if (!fr.huf.defined) {
        fail("treeless literals before any Huffman table");
      }
      lit.resize(regen);
      if (streams == 1) {
        huf_stream(fr.huf, p, avail, lit.data(), regen);
      } else {
        if (avail < 10) fail("truncated Huffman jump table");
        int64_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
                s3 = p[4] | (p[5] << 8);
        int64_t s4 = avail - 6 - s1 - s2 - s3;
        if (s4 < 1) fail("bad Huffman jump table");
        int64_t seg = (regen + 3) / 4;
        if (3 * seg > regen) fail("too few literals for 4 streams");
        const uint8_t *q = p + 6;
        huf_stream(fr.huf, q, s1, lit.data(), seg);
        huf_stream(fr.huf, q + s1, s2, lit.data() + seg, seg);
        huf_stream(fr.huf, q + s1 + s2, s3, lit.data() + 2 * seg, seg);
        huf_stream(fr.huf, q + s1 + s2 + s3, s4, lit.data() + 3 * seg,
                   regen - 3 * seg);
      }
      lits = lit.data();
      pos += csize;
    }
    // ---- sequences section
    if (pos >= bn) fail("block without a sequences section");
    int64_t nseq = b[pos];
    if (nseq == 0) {
      pos += 1;
    } else if (nseq < 128) {
      pos += 1;
    } else if (nseq < 255) {
      if (pos + 2 > bn) fail("truncated sequences header");
      nseq = ((nseq - 128) << 8) + b[pos + 1];
      pos += 2;
    } else {
      if (pos + 3 > bn) fail("truncated sequences header");
      nseq = b[pos + 1] + ((int64_t)b[pos + 2] << 8) + 0x7F00;
      pos += 3;
    }
    if (nseq == 0) {
      if (pos != bn) fail("bytes after an empty sequences section");
      need(regen);
      memcpy(dst + n, lits, regen);
      n += regen;
      return;
    }
    if (pos >= bn) fail("truncated sequences header");
    int modes = b[pos++];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    pos += table(fr.ll, modes >> 6, b + pos, bn - pos, LL_DEFAULT, 36, 6, 9,
                 35);
    pos += table(fr.of, (modes >> 4) & 3, b + pos, bn - pos, OF_DEFAULT, 29,
                 5, 8, 31);
    pos += table(fr.ml, (modes >> 2) & 3, b + pos, bn - pos, ML_DEFAULT, 53,
                 6, 9, 52);
    if (pos >= bn) fail("truncated sequences bitstream");
    BackBits br;
    br.init(b + pos, bn - pos);
    uint32_t sll = (uint32_t)br.read(fr.ll.log);
    uint32_t sof = (uint32_t)br.read(fr.of.log);
    uint32_t sml = (uint32_t)br.read(fr.ml.log);
    int64_t lpos = 0, block_start = n;
    for (int64_t i = 0; i < nseq; i++) {
      int ofc = fr.of.sym[sof], llc = fr.ll.sym[sll], mlc = fr.ml.sym[sml];
      if (ofc > 31 || llc > 35 || mlc > 52) fail("sequence code out of range");
      uint64_t ofv = (1ULL << ofc) + br.read(ofc);
      uint64_t ml = ML_BASE[mlc] + br.read(ML_BITS[mlc]);
      uint64_t ll = LL_BASE[llc] + br.read(LL_BITS[llc]);
      if (i + 1 < nseq) {
        sll = fr.ll.base[sll] + (uint32_t)br.read(fr.ll.nb[sll]);
        sml = fr.ml.base[sml] + (uint32_t)br.read(fr.ml.nb[sml]);
        sof = fr.of.base[sof] + (uint32_t)br.read(fr.of.nb[sof]);
      }
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        fr.rep[2] = fr.rep[1];
        fr.rep[1] = fr.rep[0];
        fr.rep[0] = off;
      } else {
        int idx = (int)ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = fr.rep[0];
        } else {
          off = idx < 3 ? fr.rep[idx] : fr.rep[0] - 1;
          if (idx > 1) fr.rep[2] = fr.rep[1];
          fr.rep[1] = fr.rep[0];
          fr.rep[0] = off;
        }
      }
      if (ll > (uint64_t)(regen - lpos)) fail("sequence past the literals");
      need((int64_t)(ll + ml));
      memcpy(dst + n, lits + lpos, ll);
      n += ll;
      lpos += ll;
      if (off == 0 || off > (uint64_t)(n - frame_start))
        fail("match offset before the frame's start");
      uint8_t *o = dst + n;
      const uint8_t *from = o - off;
      if (off >= ml) {
        memcpy(o, from, ml);
      } else {
        for (uint64_t k = 0; k < ml; k++) o[k] = from[k];
      }
      n += ml;
    }
    if (br.off != 0) fail("sequences bitstream not consumed exactly");
    int64_t rest = regen - lpos;
    need(rest);
    memcpy(dst + n, lits + lpos, rest);
    n += rest;
    if (n - block_start > (1 << 17)) fail("block larger than 128 KiB");
  }

  // one frame at src; returns the bytes it took
  int64_t frame(const uint8_t *src, int64_t avail) {
    if (avail < 6) fail("truncated frame header");
    int fhd = src[4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
    int did_flag = fhd & 3;
    if (fhd & 8) fail("reserved frame header bit set");
    int64_t pos = 5;
    if (!single) pos++;  // window descriptor: the whole frame is in memory
    static const int did_size[4] = {0, 1, 2, 4};
    int64_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    if (pos + did_size[did_flag] + fcs_size > avail)
      fail("truncated frame header");
    uint64_t did = 0;
    for (int i = 0; i < did_size[did_flag]; i++)
      did |= (uint64_t)src[pos + i] << (8 * i);
    if (did) fail("zstd frame names a dictionary (not supported)");
    pos += did_size[did_flag];
    int64_t fcs = -1;
    if (fcs_size) {
      uint64_t v = 0;
      for (int i = 0; i < fcs_size; i++)
        v |= (uint64_t)src[pos + i] << (8 * i);
      if (fcs_size == 2) v += 256;
      fcs = (int64_t)v;
      pos += fcs_size;
    }
    Frame fr;
    frame_start = n;
    while (true) {
      if (pos + 3 > avail) fail("truncated block header");
      uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
      pos += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (size > (1 << 17)) fail("block larger than 128 KiB");
      if (type == 0) {
        if (pos + size > avail) fail("truncated raw block");
        need(size);
        memcpy(dst + n, src + pos, size);
        n += size;
        pos += size;
      } else if (type == 1) {
        if (pos + 1 > avail) fail("truncated RLE block");
        need(size);
        memset(dst + n, src[pos], size);
        n += size;
        pos += 1;
      } else if (type == 2) {
        if (pos + size > avail) fail("truncated compressed block");
        block(fr, src + pos, size);
        pos += size;
      } else {
        fail("reserved block type");
      }
      if (last) break;
    }
    if (fcs >= 0 && n - frame_start != fcs)
      fail("frame content size does not match its data");
    if (checksum) {
      if (pos + 4 > avail) fail("truncated content checksum");
      uint32_t want = le32(src + pos);
      uint32_t got = (uint32_t)xxh64(dst + frame_start, n - frame_start, 0);
      if (want != got) fail("zstd content checksum mismatch");
      pos += 4;
    }
    return pos;
  }
};

const uint32_t MAGIC = 0xFD2FB528u;

bool skippable(uint32_t m) { return (m & 0xFFFFFFF0u) == 0x184D2A50u; }

}  // namespace

extern "C" int64_t zstd_content_size(const uint8_t *src, int64_t n) {
  int64_t pos = 0, total = 0;
  bool any = false;
  while (pos < n) {
    if (pos + 4 > n) return -2;
    uint32_t m = le32(src + pos);
    if (skippable(m)) {
      if (pos + 8 > n) return -2;
      pos += 8 + (int64_t)le32(src + pos + 4);
      continue;
    }
    if (m != MAGIC || pos + 5 > n) return -2;
    int fhd = src[pos + 4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
    static const int did_size[4] = {0, 1, 2, 4};
    int64_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    if (!fcs_size) return -1;
    int64_t p = pos + 5 + (single ? 0 : 1) + did_size[fhd & 3];
    if (p + fcs_size > n) return -2;
    uint64_t v = 0;
    for (int i = 0; i < fcs_size; i++) v |= (uint64_t)src[p + i] << (8 * i);
    if (fcs_size == 2) v += 256;
    if (v > ((uint64_t)1 << 50)) return -2;
    total += (int64_t)v;
    any = true;
    // walk the blocks to the next frame
    p += fcs_size;
    while (true) {
      if (p + 3 > n) return -2;
      uint32_t bh = src[p] | (src[p + 1] << 8) | (src[p + 2] << 16);
      int type = (bh >> 1) & 3;
      p += 3 + (type == 1 ? 1 : (int64_t)(bh >> 3));
      if (bh & 1) break;
    }
    pos = p + (((fhd >> 2) & 1) ? 4 : 0);
  }
  return any ? total : 0;
}

extern "C" int64_t zstd_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                                   int64_t cap, char *err, int errlen) {
  Decoder d{dst, cap};
  try {
    int64_t pos = 0;
    bool any = false;
    while (pos < n) {
      if (pos + 4 > n) fail("truncated frame magic");
      uint32_t m = le32(src + pos);
      if (skippable(m)) {
        if (pos + 8 > n) fail("truncated skippable frame");
        int64_t sz = le32(src + pos + 4);
        if (pos + 8 + sz > n) fail("truncated skippable frame");
        pos += 8 + sz;
        continue;
      }
      if (m != MAGIC) fail(any ? "bytes after the last frame are not zstd"
                               : "not zstd (bad magic number)");
      pos += d.frame(src + pos, n - pos);
      any = true;
    }
    if (!any) fail("no zstd frame");
    return d.n;
  } catch (const OutOfRoom &) {
    return -2;
  } catch (const Error &e) {
    if (err && errlen > 0) snprintf(err, errlen, "%s", e.msg.c_str());
    return -1;
  } catch (const std::exception &e) {
    if (err && errlen > 0) snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

extern "C" int64_t zstd_compress_bound(int64_t n) {
  return n + 3 * (n / 64 + n / (1 << 17) + 4) + 32;
}

namespace {

const int64_t BLOCK = 1 << 17, MIN_RUN = 64;

struct Writer {
  uint8_t *dst;
  int64_t cap, n = 0;
  int64_t last_hdr = -1;  // where the previous block header is
  void header(int type, int64_t size) {
    if (n + 3 > cap) throw OutOfRoom{};
    uint32_t h = (uint32_t)(type << 1) | (uint32_t)(size << 3);
    last_hdr = n;
    dst[n++] = h & 255;
    dst[n++] = (h >> 8) & 255;
    dst[n++] = (h >> 16) & 255;
  }
  void raw(const uint8_t *p, int64_t k) {
    while (k > 0) {
      int64_t b = k < BLOCK ? k : BLOCK;
      header(0, b);
      if (n + b > cap) throw OutOfRoom{};
      memcpy(dst + n, p, b);
      n += b;
      p += b;
      k -= b;
    }
  }
  void rle(uint8_t v, int64_t k) {
    while (k > 0) {
      int64_t b = k < BLOCK ? k : BLOCK;
      header(1, b);
      if (n + 1 > cap) throw OutOfRoom{};
      dst[n++] = v;
      k -= b;
    }
  }
};

}  // namespace

extern "C" int64_t zstd_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                                 int64_t cap, int checksum) {
  Writer w{dst, cap};
  try {
    if (cap < 18) throw OutOfRoom{};
    int fcs_flag = (n >= 256 && n < 65536 + 256) ? 1
                   : (n < ((int64_t)1 << 32))    ? 2
                                                 : 3;
    dst[0] = 0x28;
    dst[1] = 0xB5;
    dst[2] = 0x2F;
    dst[3] = 0xFD;
    dst[4] = (uint8_t)((fcs_flag << 6) | (checksum ? 4 : 0));
    dst[5] = (17 - 10) << 3;  // a 128 KiB window: one block, no matches
    w.n = 6;
    uint64_t v = fcs_flag == 1 ? (uint64_t)(n - 256) : (uint64_t)n;
    for (int i = 0; i < (1 << fcs_flag); i++) dst[w.n++] = (v >> (8 * i)) & 255;
    // a run of MIN_RUN equal bytes holds a whole 8-byte window at any
    // stride-8 position: test windows, then extend the run both ways
    int64_t start = 0, i = 0;  // raw bytes from start wait to be written
    while (i + 8 <= n) {
      uint64_t word;
      memcpy(&word, src + i, 8);
      uint8_t v = src[i];
      if (word != 0x0101010101010101ULL * v) {
        i += 8;
        continue;
      }
      int64_t b = i, e = i + 8;
      while (b > start && src[b - 1] == v) b--;
      for (uint64_t next; e + 8 <= n; e += 8) {
        memcpy(&next, src + e, 8);
        if (next != word) break;
      }
      while (e < n && src[e] == v) e++;
      if (e - b >= MIN_RUN) {
        w.raw(src + start, b - start);
        w.rle(v, e - b);
        start = e;
      }
      i = e;
    }
    w.raw(src + start, n - start);
    if (w.last_hdr < 0) w.header(0, 0);  // empty input: one empty block
    dst[w.last_hdr] |= 1;  // the last block
    if (checksum) {
      if (w.n + 4 > cap) throw OutOfRoom{};
      uint32_t h = (uint32_t)xxh64(src, n, 0);
      for (int k = 0; k < 4; k++) dst[w.n++] = (h >> (8 * k)) & 255;
    }
    return w.n;
  } catch (const OutOfRoom &) {
    return -2;
  }
}

extern "C" uint64_t zstd_xxh64(const uint8_t *src, int64_t n, uint64_t seed) {
  return xxh64(src, n, seed);
}

extern "C" uint32_t crc32c(const uint8_t *src, int64_t n) {
  init_crc();
  uint32_t c = 0xFFFFFFFFu;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t a = c ^ le32(src + i);
    uint32_t b = le32(src + i + 4);
    c = g_crc[7][a & 255] ^ g_crc[6][(a >> 8) & 255] ^
        g_crc[5][(a >> 16) & 255] ^ g_crc[4][a >> 24] ^ g_crc[3][b & 255] ^
        g_crc[2][(b >> 8) & 255] ^ g_crc[1][(b >> 16) & 255] ^
        g_crc[0][b >> 24];
  }
  for (; i < n; i++) c = (c >> 8) ^ g_crc[0][(c ^ src[i]) & 255];
  return c ^ 0xFFFFFFFFu;
}
