// Undo the row filters of an 8-bit PNG image (PNG specification, 9.2), for
// ``recurrent_flows_tpu_torch/data/png.py``: the Average and Paeth filters
// need the byte to the left, just decoded, so a row is a loop in which
// each byte depends on the one before; here it is a loop in C++ instead of
// in Python. Built with g++ on first use (``data/_native.py``), bound by
// ctypes.
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

// raw: height rows of 1 filter byte + stride bytes; out: height * stride
// bytes; bpp: bytes per pixel. Returns 0, or y + 1 where row y names a
// filter other than 0-4 (out is then incomplete).
extern "C" int64_t png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                                int64_t stride, int64_t bpp) {
  const uint8_t* prior = nullptr;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const uint8_t kind = *line++;
    uint8_t* cur = out + y * stride;
    switch (kind) {
      case 0:
        std::memcpy(cur, line, static_cast<size_t>(stride));
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (prior ? prior[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0, up = prior ? prior[i] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0, up = prior ? prior[i] : 0;
          const int up_left = (prior && i >= bpp) ? prior[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + paeth(left, up, up_left));
        }
        break;
      default:
        return y + 1;
    }
    prior = cur;
  }
  return 0;
}
