// Block-compressed texture decoders for the DDS, FTEX and BLP readers
// (data/dds.py, ftex.py, blp.py): BC1-BC7 as Pillow 12.1.0's BcnDecode.c
// computes them (the array JAX's providers see through Image.open), the
// DXT1, DXT3 and DXT5 decoders BlpImagePlugin.py writes in Python (they
// round differently: no bit replication of 5:6:5 colours, DXT3 alpha times
// 17), and the masked-RGB pixels of DdsImagePlugin's DdsRgbDecoder.
//
// C interface (ctypes):
//   int64_t bcn_decode(const uint8_t *src, int64_t n, int codec, int sign,
//                      int64_t width, int64_t height, uint8_t *out)
//     a whole surface of 4x4 blocks in row-major order, cropped at the
//     right and bottom edges into out [height, width, C]: codec 1 (BC1,
//     DXT1: RGBA), 2 (BC2, DXT3: RGBA), 3 (BC3, DXT5: RGBA), 4 (BC4: L),
//     5 (BC5: RGB, blue 0, or 128 when sign), 6 (BC6H: RGB, signed halves
//     when sign), 7 (BC7: RGBA).  Returns the bytes read, or -1 when src
//     holds fewer blocks than the surface.
//   int64_t blp_dxt(const uint8_t *src, int64_t n, int kind, int alpha,
//                   int64_t bw, int64_t bh, uint8_t *out)
//     BLP2's decode_dxt1 (kind 1; RGBA with alpha, else RGB), decode_dxt3
//     (3) or decode_dxt5 (5) (RGBA) of bh rows of bw blocks into out [4 bh,
//     4 bw, C], uncropped, as the plugin concatenates its rows.  Returns
//     the bytes read, or -1 when src is short.
//   void dds_rgb(const uint8_t *src, int64_t n, int64_t bytecount,
//                const uint32_t *masks, int nmasks, int64_t pixels,
//                uint8_t *out)
//     pixels of bytecount bytes (little-endian), each mask's field scaled
//     as int(field / (mask >> shift) * 255) in doubles; a pixel past the
//     data's end reads the bytes that are left, then none (zeros), as the
//     plugin's file reads do.
//   int bc6h_layout(int mode, uint8_t *out)
//     the endpoint bits of BC6H mode 0-13 (Pillow's numbering: 0, 1 the
//     two-bit modes, 2-9 the five-bit modes ending in 10, 10-13 the
//     one-region modes): 75 bytes, each (endpoint word << 4) | bit, the
//     words r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3; returns the count used
//     (75, 72 or 60) or -1.  The test side writes BC6H blocks with it.
//
// The BC6H packings, the BC7 partitions and anchors and the interpolation
// weights are the constants of the D3D11 BC6H/BC7 format specification,
// in BcnDecode.c's encoding.

#include <array>
#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

// BC6H endpoint bits of each mode, in block order from the first bit after
// the mode bits: (endpoint word << 4) | bit
const uint8_t BC6_PACKING[14][75] = {
    {0x74, 0x84, 0xb4, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08,
     0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20,
     0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32,
     0x33, 0x34, 0xa4, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44,
     0xb0, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0xb1, 0x80,
     0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92,
     0x93, 0x94, 0xb3},
    {0x75, 0xa4, 0xa5, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0xb0, 0xb1,
     0x84, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x85, 0xb2, 0x74, 0x20,
     0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0xb3, 0xb5, 0xb4, 0x30, 0x31, 0x32,
     0x33, 0x34, 0x35, 0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44,
     0x45, 0xa0, 0xa1, 0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x80,
     0x81, 0x82, 0x83, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x90, 0x91, 0x92,
     0x93, 0x94, 0x95},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x0a,
     0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x1a, 0xb0, 0xa0, 0xa1,
     0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x2a, 0xb1, 0x80, 0x81, 0x82, 0x83,
     0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x0a, 0xa4,
     0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0x1a, 0xa0, 0xa1,
     0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x2a, 0xb1, 0x80, 0x81, 0x82, 0x83,
     0x60, 0x61, 0x62, 0x63, 0xb0, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x74, 0xb3,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x0a, 0x84,
     0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x1a, 0xb0, 0xa0, 0xa1,
     0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0x2a, 0x80, 0x81, 0x82, 0x83,
     0x60, 0x61, 0x62, 0x63, 0xb1, 0xb2, 0x90, 0x91, 0x92, 0x93, 0xb4, 0xb3,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x84, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x74, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0x28, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0xa4,
     0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0xb0, 0xa0, 0xa1,
     0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0xb1, 0x80, 0x81, 0x82, 0x83,
     0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xa4, 0x84, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0xb2, 0x74, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0xb3, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35,
     0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0xb0, 0xa0, 0xa1,
     0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0xb1, 0x80, 0x81, 0x82, 0x83,
     0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x90, 0x91, 0x92, 0x93, 0x94, 0x95,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xb0, 0x84, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x75, 0x74, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0xa5, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0xa4,
     0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0xa0, 0xa1,
     0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0xb1, 0x80, 0x81, 0x82, 0x83,
     0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xb1, 0x84, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x85, 0x74, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0xb5, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0xa4,
     0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0xb0, 0xa0, 0xa1,
     0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x80, 0x81, 0x82, 0x83,
     0x60, 0x61, 0x62, 0x63, 0x64, 0xb2, 0x90, 0x91, 0x92, 0x93, 0x94, 0xb3,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0xa4, 0xb0, 0xb1, 0x84, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x75, 0x85, 0xb2, 0x74, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0xa5, 0xb3, 0xb5, 0xb4, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35,
     0x70, 0x71, 0x72, 0x73, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0xa0, 0xa1,
     0xa2, 0xa3, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x80, 0x81, 0x82, 0x83,
     0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x90, 0x91, 0x92, 0x93, 0x94, 0x95,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35,
     0x36, 0x37, 0x38, 0x39, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47,
     0x48, 0x49, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35,
     0x36, 0x37, 0x38, 0x0a, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47,
     0x48, 0x1a, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x2a,
     0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x34, 0x35,
     0x36, 0x37, 0x0b, 0x0a, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47,
     0x1b, 0x1a, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x2b, 0x2a,
     0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x00, 0x00, 0x00},
    {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11,
     0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23,
     0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x30, 0x31, 0x32, 0x33, 0x0f, 0x0e,
     0x0d, 0x0c, 0x0b, 0x0a, 0x40, 0x41, 0x42, 0x43, 0x1f, 0x1e, 0x1d, 0x1c,
     0x1b, 0x1a, 0x50, 0x51, 0x52, 0x53, 0x2f, 0x2e, 0x2d, 0x2c, 0x2b, 0x2a,
     0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
     0x00, 0x00, 0x00},
};

// BC7 anchor indices: the second subset of two (A2), the second and third
// of three (A3a, A3b)
const uint8_t BC7_ANCHOR2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
};
const uint8_t BC7_ANCHOR3A[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
};
const uint8_t BC7_ANCHOR3B[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
};
// BC7 partitions: a subset bit a pixel (two subsets), two bits (three)
const uint16_t BC7_PARTITION2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22,
};
const uint32_t BC7_PARTITION3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254,
};

// BC6H modes: regions, delta-coded endpoints, partition bits, endpoint
// bits, then the red, green and blue delta bits
struct Bc6Mode {
  int8_t ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode BC6_MODES[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// BC7 modes: subsets, partition bits, rotation bits, index-selector bits,
// colour bits, alpha bits, per-endpoint p-bits, shared p-bits, index bits,
// second index bits
struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode BC7_MODES[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

const uint8_t WEIGHTS2[4] = {0, 21, 43, 64};
const uint8_t WEIGHTS3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t WEIGHTS4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                              34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t *weights(int bits) {
  return bits == 2 ? WEIGHTS2 : bits == 3 ? WEIGHTS3 : WEIGHTS4;
}

int subset(int ns, int partition, int i) {
  if (ns == 2) return 1 & (BC7_PARTITION2[partition] >> i);
  if (ns == 3) return 3 & (BC7_PARTITION3[partition] >> (2 * i));
  return 0;
}

inline int get_bit(const uint8_t *src, int bit) {
  return (src[bit >> 3] >> (bit & 7)) & 1;
}

// count (<= 8) bits from bit on, LSB first
inline int get_bits(const uint8_t *src, int bit, int count) {
  if (!count) return 0;
  int by = bit >> 3;
  bit &= 7;
  int x = bit + count <= 8 ? src[by] : src[by] | (src[by + 1] << 8);
  return (x >> bit) & ((1 << count) - 1);
}

Rgba decode_565(unsigned x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  return {uint8_t(r | r >> 5), uint8_t(g | g >> 6), uint8_t(b | b >> 5),
          0xff};
}

// a BC1 colour block; BC2 and BC3 always take the four-colour form
void bc1_colour(Rgba *col, const uint8_t *src, bool separate_alpha) {
  unsigned c0 = src[0] | src[1] << 8, c1 = src[2] | src[3] << 8;
  uint32_t lut = src[4] | src[5] << 8 | src[6] << 16 | uint32_t(src[7]) << 24;
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3),
            uint8_t((2 * b0 + b1) / 3), 0xff};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3),
            uint8_t((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2),
            uint8_t((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) col[n] = p[3 & (lut >> (2 * n))];
}

// BC3's alpha block (BC4's and BC5's channels), into byte o of each of the
// 16 pixels of stride bytes; signed: the endpoints as int8 + 128
void bc3_alpha(uint8_t *dst, const uint8_t *src, int stride, int o,
               bool sign) {
  int a0 = sign ? int8_t(src[0]) + 128 : src[0];
  int a1 = sign ? int8_t(src[1]) + 128 : src[1];
  int lut1 = src[2] | src[3] << 8 | src[4] << 16;
  int lut2 = src[5] | src[6] << 8 | src[7] << 16;
  uint8_t a[8];
  a[0] = uint8_t(a0);
  a[1] = uint8_t(a1);
  if (a0 > a1) {
    for (int k = 1; k <= 6; k++) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k <= 4; k++) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++)
    dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

void bc2_block(Rgba *col, const uint8_t *src) {
  bc1_colour(col, src + 8, true);
  for (int n = 0; n < 16; n++) {
    int av = 0xf & (src[n >> 1] >> ((n & 1) * 4));
    col[n].a = uint8_t(av << 4 | av);
  }
}

uint8_t expand(int v, int bits) {
  uint8_t x = uint8_t(v << (8 - bits));
  return uint8_t(x | x >> bits);
}

void bc7_lerp(Rgba *dst, const Rgba *e, int s0, int s1) {
  int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = uint8_t((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = uint8_t((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = uint8_t((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = uint8_t((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba *col, const uint8_t *src) {
  if (!src[0]) {            // no mode bit in the first byte: opaque black
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) mode++;
  int bit = mode + 1;
  const Bc7Mode &m = BC7_MODES[mode];
  int cb = m.cb, ab = m.ab;
  const uint8_t *cw = weights(m.ib);
  const uint8_t *aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;
  int numep = m.ns * 2;
  int ep[6][4];             // r, g, b, a of each endpoint
  for (int c = 0; c < 3; c++)
    for (int i = 0; i < numep; i++, bit += cb) ep[i][c] = get_bits(src, bit, cb);
  for (int i = 0; i < numep; i++) {
    ep[i][3] = ab ? get_bits(src, bit, ab) : 255;
    if (ab) bit += ab;
  }
  if (m.epb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) {
      int p = get_bit(src, bit++);
      for (int c = 0; c < (ab ? 4 : 3); c++) ep[i][c] = ep[i][c] << 1 | p;
    }
  }
  if (m.spb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i += 2) {
      int p = get_bit(src, bit++);
      for (int j = 0; j < 2; j++)
        for (int c = 0; c < (ab ? 4 : 3); c++)
          ep[i + j][c] = ep[i + j][c] << 1 | p;
    }
  }
  Rgba e[6];
  for (int i = 0; i < numep; i++) {
    e[i].r = expand(ep[i][0], cb);
    e[i].g = expand(ep[i][1], cb);
    e[i].b = expand(ep[i][2], cb);
    e[i].a = ab ? expand(ep[i][3], ab) : uint8_t(ep[i][3]);
  }
  int cibit = bit, aibit = cibit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; i++) {
    int s = subset(m.ns, partition, i) << 1;
    int ib = m.ib;
    if (i == 0)
      ib--;
    else if (m.ns == 2 && i == BC7_ANCHOR2[partition])
      ib--;
    else if (m.ns == 3 &&
             (i == BC7_ANCHOR3A[partition] || i == BC7_ANCHOR3B[partition]))
      ib--;
    int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && m.ib2) {
      int ib2 = i == 0 ? m.ib2 - 1 : m.ib2;
      int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[i], &e[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &e[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &e[s], cw[i0], cw[i0]);
    }
    uint8_t t = col[i].a;
    if (rotation == 1) {
      col[i].a = col[i].r;
      col[i].r = t;
    } else if (rotation == 2) {
      col[i].a = col[i].g;
      col[i].g = t;
    } else if (rotation == 3) {
      col[i].a = col[i].b;
      col[i].b = t;
    }
  }
}

uint16_t sign_extend(uint16_t v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  return uint16_t(x);
}

int bc6_unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15) return v;
    if (!v) return 0;
    if (v == (1 << prec) - 1) return 0xffff;
    return ((v << 16) + 0x8000) >> prec;
  }
  if (prec >= 16) return v;
  bool neg = false;
  if (v & 0x8000) {
    neg = true;
    v = uint16_t(-v);
  }
  if (v) {
    if (v >= (1 << (prec - 1)) - 1)
      v = 0x7fff;
    else
      v = uint16_t(((v << 15) + 0x4000) >> (prec - 1));
  }
  return neg ? -int(v) : int(v);
}

float half_to_float(uint16_t h) {
  uint32_t u = uint32_t(h & 0x7fff) << 13, mu = 0x77800000;
  float f, m;
  memcpy(&f, &u, 4);
  memcpy(&m, &mu, 4);
  f *= m;
  mu = 0x47800000;
  memcpy(&m, &mu, 4);
  memcpy(&u, &f, 4);
  if (f >= m) u |= 255u << 23;
  u |= uint32_t(h & 0x8000) << 16;
  memcpy(&f, &u, 4);
  return f;
}

// the half bits of an interpolated endpoint value
uint16_t bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return uint16_t(0x8000 | ((-v) * 31) / 32);
    return uint16_t((v * 31) / 32);
  }
  return uint16_t((v * 31) / 64);
}

uint8_t bc6_clamp(float v) {
  if (v < 0.0f) return 0;
  if (v > 1.0f) return 255;
  return uint8_t(v * 255.0f);
}

// bc6_clamp(half_to_float(h)) for every half h that bc6_finalize gives
// (none has an exponent of 31), built once
const uint8_t *half_to_u8() {
  static const std::array<uint8_t, 65536> table = [] {
    std::array<uint8_t, 65536> t{};
    for (int h = 0; h < 65536; h++)
      if ((h & 0x7c00) != 0x7c00) t[h] = bc6_clamp(half_to_float(uint16_t(h)));
    return t;
  }();
  return table.data();
}

void bc6_block(Rgba *col, const uint8_t *src, bool sign) {
  int bit = 5, epbits = 75, ib = 3;
  int mode = src[0] & 0x1f;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {         // a reserved mode: black
    memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const Bc6Mode &m = BC6_MODES[mode];
  const uint8_t *cw = weights(ib);
  int numep = m.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {0};
  for (int i = 0; i < epbits; i++) {
    int di = BC6_PACKING[mode][i];
    ep[di >> 4] |= uint16_t(get_bit(src, bit + i) << (di & 15));
  }
  bit += epbits;
  int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  int mask = (1 << m.epb) - 1;
  if (sign)
    for (int c = 0; c < 3; c++) ep[c] = sign_extend(ep[c], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; i += 3) {
      ep[i] = sign_extend(ep[i], m.rb);
      ep[i + 1] = sign_extend(ep[i + 1], m.gb);
      ep[i + 2] = sign_extend(ep[i + 2], m.bb);
    }
  if (m.tr) {
    for (int i = 3; i < numep; i++)
      ep[i] = uint16_t((ep[i] + ep[i % 3]) & mask);
  }
  int u[12];
  for (int i = 0; i < numep; i++) u[i] = bc6_unquantize(ep[i], m.epb, sign);
  const uint8_t *lut = half_to_u8();
  for (int i = 0; i < 16; i++) {
    int s = subset(m.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0 || (m.ns == 2 && i == BC7_ANCHOR2[partition])) ib2--;
    int w = cw[get_bits(src, bit, ib2)];
    bit += ib2;
    int t = 64 - w;
    col[i].r = lut[bc6_finalize((u[s] * t + u[s + 3] * w) >> 6, sign)];
    col[i].g = lut[bc6_finalize((u[s + 1] * t + u[s + 4] * w) >> 6, sign)];
    col[i].b = lut[bc6_finalize((u[s + 2] * t + u[s + 5] * w) >> 6, sign)];
    col[i].a = 255;
  }
}

// BlpImagePlugin.unpack_565
void blp_565(unsigned c, int *rgb) {
  rgb[0] = ((c >> 11) & 0x1f) << 3;
  rgb[1] = ((c >> 5) & 0x3f) << 2;
  rgb[2] = (c & 0x1f) << 3;
}

// the colour of code 0-3 in BLP2's four-colour form (DXT3, DXT5, and
// DXT1 with color0 > color1)
void blp_colour(int code, const int *c0, const int *c1, uint8_t *px) {
  for (int k = 0; k < 3; k++)
    px[k] = uint8_t(code == 0   ? c0[k]
                    : code == 1 ? c1[k]
                    : code == 2 ? (2 * c0[k] + c1[k]) / 3
                                : (2 * c1[k] + c0[k]) / 3);
}

}  // namespace

extern "C" int64_t bcn_decode(const uint8_t *src, int64_t n, int codec,
                              int sign, int64_t width, int64_t height,
                              uint8_t *out) {
  int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
  int bsize = codec == 1 || codec == 4 ? 8 : 16;
  int C = codec == 4 ? 1 : codec == 5 || codec == 6 ? 3 : 4;
  if (n < bw * bh * bsize) return -1;
  Rgba col[16];
  uint8_t lum[16];
  const uint8_t *p = src;
  for (int64_t by = 0; by < bh; by++)
    for (int64_t bx = 0; bx < bw; bx++, p += bsize) {
      switch (codec) {
        case 1: bc1_colour(col, p, false); break;
        case 2: bc2_block(col, p); break;
        case 3:
          bc1_colour(col, p + 8, true);
          bc3_alpha(&col[0].r, p, 4, 3, false);
          break;
        case 4: bc3_alpha(lum, p, 1, 0, false); break;
        case 5:
          memset(col, sign ? 128 : 0, sizeof col);
          bc3_alpha(&col[0].r, p, 4, 0, sign);
          bc3_alpha(&col[0].r, p + 8, 4, 1, sign);
          break;
        case 6: bc6_block(col, p, sign); break;
        default: bc7_block(col, p); break;
      }
      for (int j = 0; j < 4; j++) {
        int64_t y = by * 4 + j;
        if (y >= height) break;
        for (int i = 0; i < 4; i++) {
          int64_t x = bx * 4 + i;
          if (x >= width) break;
          uint8_t *d = out + (y * width + x) * C;
          if (C == 1)
            d[0] = lum[j * 4 + i];
          else
            memcpy(d, &col[j * 4 + i], C);
        }
      }
    }
  return p - src;
}

extern "C" int64_t blp_dxt(const uint8_t *src, int64_t n, int kind,
                           int alpha, int64_t bw, int64_t bh, uint8_t *out) {
  int bsize = kind == 1 ? 8 : 16;
  int C = kind == 1 && !alpha ? 3 : 4;
  if (n < bw * bh * bsize) return -1;
  int64_t W = bw * 4;
  const uint8_t *p = src;
  for (int64_t by = 0; by < bh; by++)
    for (int64_t bx = 0; bx < bw; bx++, p += bsize) {
      const uint8_t *cb = kind == 1 ? p : p + 8;
      unsigned c0 = cb[0] | cb[1] << 8, c1 = cb[2] | cb[3] << 8;
      uint32_t code =
          cb[4] | cb[5] << 8 | cb[6] << 16 | uint32_t(cb[7]) << 24;
      int rgb0[3], rgb1[3];
      blp_565(c0, rgb0);
      blp_565(c1, rgb1);
      uint64_t a_bits = 0;
      for (int k = 0; k < 6; k++) a_bits |= uint64_t(p[2 + k]) << (8 * k);
      for (int q = 0; q < 16; q++) {
        uint8_t *d = out + ((by * 4 + q / 4) * W + bx * 4 + q % 4) * C;
        int cc = (code >> (2 * q)) & 3;
        int a = 255;
        if (kind == 1 && c0 <= c1) {
          if (cc == 3) {
            d[0] = d[1] = d[2] = 0;
            a = 0;
          } else {
            for (int k = 0; k < 3; k++)
              d[k] = uint8_t(cc == 0   ? rgb0[k]
                             : cc == 1 ? rgb1[k]
                                       : (rgb0[k] + rgb1[k]) / 2);
          }
        } else {
          blp_colour(cc, rgb0, rgb1, d);
        }
        if (kind == 3) {
          int v = (p[q / 2] >> ((q & 1) * 4)) & 0xf;
          a = v * 17;
        } else if (kind == 5) {
          int a0 = p[0], a1 = p[1], ac = int((a_bits >> (3 * q)) & 7);
          a = ac == 0   ? a0
              : ac == 1 ? a1
              : a0 > a1 ? ((8 - ac) * a0 + (ac - 1) * a1) / 7
              : ac == 6 ? 0
              : ac == 7 ? 255
                        : ((6 - ac) * a0 + (ac - 1) * a1) / 5;
        }
        if (C == 4) d[3] = uint8_t(a);
      }
    }
  return p - src;
}

extern "C" void dds_rgb(const uint8_t *src, int64_t n, int64_t bytecount,
                        const uint32_t *masks, int nmasks, int64_t pixels,
                        uint8_t *out) {
  int shift[4];
  uint32_t total[4];
  for (int i = 0; i < nmasks; i++) {
    uint32_t m = masks[i];
    int s = 0;
    if (m)
      while (s < 31 && !(m & (1u << s))) s++;
    shift[i] = s;
    total[i] = m >> s;
  }
  int64_t pos = 0;
  for (int64_t p = 0; p < pixels; p++, pos += bytecount) {
    uint32_t v = 0;
    for (int64_t k = 0; k < 4 && k < bytecount && pos + k < n; k++)
      v |= uint32_t(src[pos + k]) << (8 * k);
    for (int i = 0; i < nmasks; i++)
      out[p * nmasks + i] =
          total[i] ? uint8_t(int(double((v & masks[i]) >> shift[i]) /
                                 double(total[i]) * 255.0))
                   : 0;
  }
}

extern "C" int bc6h_layout(int mode, uint8_t *out) {
  if (mode < 0 || mode >= 14) return -1;
  memcpy(out, BC6_PACKING[mode], 75);
  return mode < 2 ? 75 : mode < 10 ? 72 : 60;
}
