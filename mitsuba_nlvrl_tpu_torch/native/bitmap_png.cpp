// PNG row unfiltering: the five filters (none, sub, up, average, paeth)
// of a non-interlaced image, or of one Adam7 pass of an interlaced one.
//
// The native stage of utils/io.py's read_png; utils/io.py's
// _png_unfilter_plain is its plain version, which the tests hold it to.
// A plain C ABI for ctypes. Every read of `raw` is checked against its
// length, and every write lands in `out` (H x stride bytes).

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline int paeth(int left, int up, int ul) {
    const int pa = std::abs(up - ul), pb = std::abs(left - ul),
              pc = std::abs(left + up - 2 * ul);
    const int b = pb <= pc ? up : ul;        // |p - left| = |up - ul|, ...
    return (pa <= pb && pa <= pc) ? left : b;
}

}  // namespace

// Returns 0, or the plain version's failure: 1 a row's filter byte lies
// past the data (IndexError), 2 a row is short (ValueError), 3 an unknown
// filter type, stored in *bad (ValueError).
extern "C" int mnt_png_unfilter(const uint8_t *raw, int64_t len, int64_t H,
                                int64_t stride, int64_t bpp, uint8_t *out,
                                int64_t *bad) {
    int64_t pos = 0;
    const std::vector<uint8_t> zeros(static_cast<size_t>(stride), 0);
    const uint8_t *prior = zeros.data();   // the row above; zeros at the top
    for (int64_t y = 0; y < H; ++y) {
        if (pos >= len) return 1;
        const int ftype = raw[pos];
        if (stride > len - pos - 1) return 2;
        const uint8_t *row = raw + pos + 1;
        uint8_t *cur = out + y * stride;
        pos += stride + 1;
        switch (ftype) {
        case 0:
            for (int64_t i = 0; i < stride; ++i) cur[i] = row[i];
            break;
        case 1:
            for (int64_t i = 0; i < stride; ++i)
                cur[i] = uint8_t(row[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:
            for (int64_t i = 0; i < stride; ++i)
                cur[i] = uint8_t(row[i] + prior[i]);
            break;
        case 3:
            for (int64_t i = 0; i < stride && i < bpp; ++i)
                cur[i] = uint8_t(row[i] + (prior[i] >> 1));
            for (int64_t i = bpp; i < stride; ++i)
                cur[i] = uint8_t(row[i] + ((cur[i - bpp] + prior[i]) >> 1));
            break;
        case 4:
            for (int64_t i = 0; i < stride && i < bpp; ++i)
                cur[i] = uint8_t(row[i] + prior[i]);   // Paeth of (0, up, 0)
            for (int64_t i = bpp; i < stride; ++i)
                cur[i] = uint8_t(row[i] + paeth(cur[i - bpp], prior[i],
                                                prior[i - bpp]));
            break;
        default:
            *bad = ftype;
            return 3;
        }
        prior = cur;
    }
    return 0;
}
