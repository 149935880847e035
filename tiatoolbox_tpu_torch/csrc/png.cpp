// PNG row unfiltering for the port's image decoder (utils/imagecodec.py),
// the step libpng's png_read_filter_row does for cv2.imdecode in JAX
// (tiatoolbox_tpu/utils/misc.py:41-60). Built with g++ into a shared
// library with a plain C interface and loaded with ctypes
// (tiatoolbox_tpu_torch/native).
//
// Each of `rows` rows of `raw` is a filter-type byte and `row_bytes` bytes;
// `bpp` is the bytes of one pixel (at least 1). The five filter types of
// the PNG specification (section 9): none, sub, up, average, Paeth, with
// the row above the first one taken as zeros. Returns 0, or -1 for an
// unknown filter type (the stream is corrupt).

#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* raw, int64_t rows, int64_t row_bytes, int32_t bpp,
                            uint8_t* out) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < rows; ++y) {
        const uint8_t* line = raw + y * (row_bytes + 1);
        const int kind = line[0];
        ++line;
        uint8_t* cur = out + y * row_bytes;
        for (int64_t x = 0; x < row_bytes; ++x) {
            const int left = x >= bpp ? cur[x - bpp] : 0;
            const int up = prev != nullptr ? prev[x] : 0;
            const int up_left = (prev != nullptr && x >= bpp) ? prev[x - bpp] : 0;
            int pred = 0;
            switch (kind) {
                case 0: pred = 0; break;
                case 1: pred = left; break;
                case 2: pred = up; break;
                case 3: pred = (left + up) >> 1; break;
                case 4: {
                    const int p = left + up - up_left;
                    const int pa = std::abs(p - left);
                    const int pb = std::abs(p - up);
                    const int pc = std::abs(p - up_left);
                    pred = (pa <= pb && pa <= pc) ? left : (pb <= pc ? up : up_left);
                    break;
                }
                default: return -1;
            }
            cur[x] = static_cast<uint8_t>(line[x] + pred);
        }
        prev = cur;
    }
    return 0;
}
