// PNG scanline unfilter (ISO/IEC 15948, section 9): the Sub, Average and
// Paeth filters predict a byte from its left neighbour as reconstructed,
// so a row is sequential along its length.  Built with g++ at first use by
// reforge_tpu_torch/io/png.py and called through ctypes.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src: `height` rows of 1 + row_bytes bytes (the filter type, then the
// filtered row); dst: height * row_bytes reconstructed bytes.  `bpp` is
// the bytes of one pixel.  Returns 0, or 1 + the index of the first row
// whose filter type is not 0-4 (dst is then incomplete).
int64_t rf_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height, int64_t row_bytes,
                        int64_t bpp) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (row_bytes + 1);
    const uint8_t type = *in++;
    uint8_t* out = dst + y * row_bytes;
    switch (type) {
      case 0:
        std::memcpy(out, in, row_bytes);
        break;
      case 1:
        for (int64_t x = 0; x < row_bytes; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < row_bytes; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < row_bytes; ++x) {
          const int left = x >= bpp ? out[x - bpp] : 0;
          const int up = prev ? prev[x] : 0;
          out[x] = static_cast<uint8_t>(in[x] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[x] = static_cast<uint8_t>(in[x] + pred);
        }
        break;
      default:
        return y + 1;
    }
    prev = out;
  }
  return 0;
}

}  // extern "C"
