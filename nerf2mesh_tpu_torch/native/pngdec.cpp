// PNG row unfiltering (PNG specification, section 9) for data/png.py: the
// five filter types over `rows` rows of `stride` bytes, each row preceded
// by its filter-type byte, with `bpp` bytes between a byte and the one it
// is predicted from (at least 1).  The Paeth and Average filters depend on
// the row's own output byte by byte, which numpy cannot vectorize.
//
// C interface (ctypes):
//   int64_t png_unfilter(const uint8_t *in, int64_t rows, int64_t stride,
//                    int bpp, uint8_t *out)
// out receives rows * stride bytes.  Returns 0, or 1 + the row whose
// filter type is not 0-4.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int64_t png_unfilter(const uint8_t *in, int64_t rows,
                                int64_t stride, int bpp, uint8_t *out) {
  for (int64_t y = 0; y < rows; y++) {
    const uint8_t *f = in + y * (stride + 1);
    int kind = f[0];
    f++;
    uint8_t *o = out + y * stride;
    const uint8_t *up = y ? o - stride : nullptr;
    switch (kind) {
      case 0:
        memcpy(o, f, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; i++)
          o[i] = (uint8_t)(f[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; i++)
          o[i] = (uint8_t)(f[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          o[i] = (uint8_t)(f[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = (uint8_t)(f[i] + pred);
        }
        break;
      default:
        return 1 + y;
    }
  }
  return 0;
}
