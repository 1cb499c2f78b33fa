// PNG row filters of the port's host engine: the reconstruction of a
// non-interlaced 8-bit image's rows from zlib's output (a filter byte and
// the filtered bytes of each row), as the PNG specification defines the
// five filters (None, Sub, Up, Average, Paeth). data/png.py inflates the
// stream with zlib and calls this; in C++ the rows are one pass, outside
// the interpreter's lock, where numpy needed a step per anti-diagonal.
//
// Built by data/native.py with the engine's other sources into one
// library; C ABI.

#include <cstdint>
#include <cstdlib>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// `raw`: h rows of 1 + w * bpp bytes; `out`: h * w * bpp bytes. Returns 0,
// or 1 + the row index of a filter type above 4.
int sft_png_unfilter(const uint8_t* raw, int h, int w, int bpp, uint8_t* out) {
  const int stride = w * bpp;
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + static_cast<size_t>(y) * (stride + 1);
    const int kind = in[0];
    ++in;
    uint8_t* row = out + static_cast<size_t>(y) * stride;
    const uint8_t* prev = y ? row - stride : nullptr;
    for (int i = 0; i < stride; ++i) {
      const int a = i >= bpp ? row[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = prev && i >= bpp ? prev[i - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return y + 1;
      }
      row[i] = static_cast<uint8_t>(in[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
