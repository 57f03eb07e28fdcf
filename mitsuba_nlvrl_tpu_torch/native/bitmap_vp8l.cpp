// WebP lossless (VP8L): the entropy-coded pixels of one image, and the
// predictor transform undone; and the gradient filter of an alpha plane
// (the ALPH chunk, utils/webp.py) undone.
//
// The native stages of utils/vp8l.py; _pixels_plain and _unpredict_plain
// there are their plain versions, which the tests hold them to.
// mnt_vp8l_pixels decodes from a bit position of the stream (LSB first)
// with the prefix codes that utils/vp8l.py read: five tables a group, each
// entry (symbol << 4 | length) at the next `mask + 1` bits' index; the
// colour cache (filled before each lookup with the pixels decoded since
// the last, as libwebp's is), meta codes (a group for each tile of the
// entropy image) and LZ77 with the 120-entry distance map. Bits past the
// end read as zeros and fail the decode, as in the plain version. Every
// table lookup, back-reference and cache key is checked against its
// bounds.

#include <cstdint>
#include <cstdlib>

namespace {

const int8_t NEAR[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

enum { OK = 0, TRUNCATED = 1, BACKREF = 2, CACHE_KEY = 3, GROUP = 4 };

struct Reader {
    const uint8_t *data;
    int64_t len, pos;     // the next byte to load
    uint64_t val;         // loaded bits, least significant first
    int nb;               // their count; negative once past the end

    void fill() {
        while (nb <= 56 && pos < len) {
            val |= uint64_t(data[pos++]) << nb;
            nb += 8;
        }
    }
    // n <= 32 bits
    uint32_t read(int n) {
        if (nb < 32) fill();
        const uint32_t v = uint32_t(val & ((uint64_t(1) << n) - 1));
        val >>= n;
        nb -= n;
        return v;
    }
    int symbol(const int32_t *tab, int32_t mask) {
        if (nb < 32) fill();
        const int32_t e = tab[val & uint64_t(mask)];
        const int n = e & 15;
        val >>= n;
        nb -= n;
        return e >> 4;
    }
    // LZ77 length or distance of prefix symbol s
    uint32_t extra(int s) {
        if (s < 4) return s + 1;
        const int k = (s - 2) >> 1;
        return ((2u + (s & 1)) << k) + read(k) + 1;
    }
};

inline uint32_t add(uint32_t a, uint32_t b) {
    return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
           (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}

inline uint32_t avg(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b);
}

inline int ch(uint32_t v, int s) { return int((v >> s) & 255); }

inline uint32_t select(uint32_t t, uint32_t left, uint32_t tl) {
    int d = 0;
    for (int s = 0; s < 32; s += 8)
        d += std::abs(ch(left, s) - ch(tl, s)) - std::abs(ch(t, s) - ch(tl, s));
    return d <= 0 ? t : left;
}

inline int clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline uint32_t clamp_full(uint32_t left, uint32_t t, uint32_t tl) {
    uint32_t v = 0;
    for (int s = 0; s < 32; s += 8)
        v |= uint32_t(clamp255(ch(left, s) + ch(t, s) - ch(tl, s))) << s;
    return v;
}

inline uint32_t clamp_half(uint32_t a, uint32_t tl) {
    uint32_t v = 0;
    for (int s = 0; s < 32; s += 8) {
        const int x = ch(a, s);
        v |= uint32_t(clamp255(x + (x - ch(tl, s)) / 2)) << s;
    }
    return v;
}

}  // namespace

// The w x h ARGB words of an entropy-coded image into out, read from bit
// *bitpos of data[0:len] (advanced past them on success). tables holds
// every prefix code's table; group g's code j (green with lengths and
// cache keys, red, blue, alpha, distance) starts at offsets[5g + j] with
// masks[5g + j]. mbits, mxs and ent[nent]: the meta codes' tile bits,
// tiles a row and each tile's group (one group: mbits 30, mxs 1, ent {0}).
// Returns 0 or an error: 1 past the end, 2 a back-reference out of range,
// 3 a colour cache key past the cache, 4 a tile's group past the groups.
extern "C" int mnt_vp8l_pixels(const uint8_t *data, int64_t len,
                               int64_t *bitpos, int64_t w, int64_t h,
                               int cache_bits, const int32_t *tables,
                               const int64_t *offsets, const int32_t *masks,
                               int64_t ngroups, int mbits, int64_t mxs,
                               const int32_t *ent, int64_t nent,
                               uint32_t *out) {
    if (cache_bits < 0 || cache_bits > 11) return CACHE_KEY;
    Reader br{data, len, *bitpos >> 3, 0, 0};
    br.fill();
    br.read(int(*bitpos & 7));
    const int64_t n = w * h;
    const int64_t csize = cache_bits ? int64_t(1) << cache_bits : 0;
    uint32_t cache[1 << 11] = {};
    const int cshift = 32 - cache_bits;
    int64_t cached = 0;
    const int64_t mmask = (int64_t(1) << mbits) - 1;
    const int32_t *tab[5] = {};
    int32_t msk[5] = {};
    auto pick = [&](int64_t x, int64_t y) -> bool {
        const int64_t t = (y >> mbits) * mxs + (x >> mbits);
        if (t < 0 || t >= nent || ent[t] < 0 || ent[t] >= ngroups)
            return false;
        for (int j = 0; j < 5; ++j) {
            tab[j] = tables + offsets[5 * ent[t] + j];
            msk[j] = masks[5 * ent[t] + j];
        }
        return true;
    };
    int64_t i = 0, x = 0, y = 0;
    while (i < n) {
        if (!(x & mmask) && !pick(x, y)) return GROUP;
        const int code = br.symbol(tab[0], msk[0]);
        if (code < 256) {
            const uint32_t red = br.symbol(tab[1], msk[1]);
            const uint32_t blue = br.symbol(tab[2], msk[2]);
            const uint32_t alpha = br.symbol(tab[3], msk[3]);
            out[i++] = alpha << 24 | red << 16 | uint32_t(code) << 8 | blue;
            if (++x == w) {
                x = 0;
                ++y;
            }
        } else if (code < 280) {
            const int64_t length = br.extra(code - 256);
            int64_t dist = br.extra(br.symbol(tab[4], msk[4]));
            if (dist > 120) {
                dist -= 120;
            } else {
                dist = NEAR[dist - 1][1] * w + NEAR[dist - 1][0];
                if (dist < 1) dist = 1;
            }
            if (br.nb < 0) break;
            if (dist > i || i + length > n) return BACKREF;
            for (int64_t j = 0; j < length; ++j) out[i + j] = out[i + j - dist];
            i += length;
            x += length;
            if (x >= w) {
                y += x / w;
                x %= w;
            }
            if ((x & mmask) && !pick(x, y)) return GROUP;
        } else {
            const int64_t key = code - 280;
            if (key >= csize) return CACHE_KEY;
            for (; cached < i; ++cached)
                cache[(out[cached] * 0x1e35a7bdu) >> cshift] = out[cached];
            out[i++] = cache[key];
            if (++x == w) {
                x = 0;
                ++y;
            }
        }
        if (br.nb < 0) break;
    }
    if (br.nb < 0) return TRUNCATED;
    *bitpos = 8 * br.pos - br.nb;
    return OK;
}

// Undo the predictor transform of the h x w residuals res into out: the
// top-left pixel predicted by opaque black, the rest of the top row by L,
// the left column by T, every other pixel by its tile's mode (tiles: the
// (h >> bits) x tw tile image, the mode in the green byte's low 4 bits; 14
// and 15 act as 0, as in libwebp). The top-right neighbour of a row's last
// pixel is the row's first, as in libwebp's buffer.
extern "C" void mnt_vp8l_unpredict(const uint32_t *res, int64_t w, int64_t h,
                                   int bits, const uint32_t *tiles,
                                   int64_t tw, uint32_t *out) {
    out[0] = add(res[0], 0xFF000000u);
    for (int64_t x = 1; x < w; ++x) out[x] = add(res[x], out[x - 1]);
    for (int64_t y = 1; y < h; ++y) {
        const uint32_t *top = out + (y - 1) * w;
        const uint32_t *r = res + y * w;
        uint32_t *cur = out + y * w;
        const uint32_t *trow = tiles + (y >> bits) * tw;
        cur[0] = add(r[0], top[0]);
        for (int64_t x = 1; x < w; ++x) {
            const uint32_t left = cur[x - 1], t = top[x], tl = top[x - 1];
            const uint32_t tr = x + 1 < w ? top[x + 1] : cur[0];
            uint32_t p;
            switch ((trow[x >> bits] >> 8) & 15) {
            case 1: p = left; break;
            case 2: p = t; break;
            case 3: p = tr; break;
            case 4: p = tl; break;
            case 5: p = avg(avg(left, tr), t); break;
            case 6: p = avg(left, tl); break;
            case 7: p = avg(left, t); break;
            case 8: p = avg(tl, t); break;
            case 9: p = avg(t, tr); break;
            case 10: p = avg(avg(left, tl), avg(t, tr)); break;
            case 11: p = select(t, left, tl); break;
            case 12: p = clamp_full(left, t, tl); break;
            case 13: p = clamp_half(avg(left, t), tl); break;
            default: p = 0xFF000000u; break;
            }
            cur[x] = add(r[x], p);
        }
    }
}

// Undo the cross-colour transform of the h x w pixels px into out: green
// to red, green to blue and red to blue, each a signed 3.5 fixed-point
// factor of the pixel's tile (tiles: (h >> bits) x tw).
extern "C" void mnt_vp8l_uncross(const uint32_t *px, int64_t w, int64_t h,
                                 int bits, const uint32_t *tiles, int64_t tw,
                                 uint32_t *out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint32_t *trow = tiles + (y >> bits) * tw;
        for (int64_t x = 0; x < w; ++x) {
            const uint32_t m = trow[x >> bits], p = px[y * w + x];
            const int g2r = int8_t(m & 255), g2b = int8_t((m >> 8) & 255),
                      r2b = int8_t((m >> 16) & 255);
            const int green = int8_t((p >> 8) & 255);
            const int red = (int((p >> 16) & 255) + ((g2r * green) >> 5)) & 255;
            const int blue = (int(p & 255) + ((g2b * green) >> 5) +
                              ((r2b * int8_t(red)) >> 5)) & 255;
            out[y * w + x] = (p & 0xFF00FF00u) | uint32_t(red) << 16 |
                             uint32_t(blue);
        }
    }
}

// Undo the gradient filter of an h x w alpha plane a (h >= 1) into out,
// mod 256: the top row predicted from the left (its first pixel from 0),
// the left column from above, the rest from left + top - top-left clipped
// to 0..255 (utils/webp.py's _unfilter_gradient_plain).
extern "C" void mnt_alpha_ungradient(const uint8_t *a, int64_t h, int64_t w,
                                     uint8_t *out) {
    int left = 0;
    for (int64_t x = 0; x < w; ++x) out[x] = uint8_t(left += a[x]);
    for (int64_t y = 1; y < h; ++y) {
        const uint8_t *top = out + (y - 1) * w, *row = a + y * w;
        uint8_t *cur = out + y * w;
        int tl = w ? top[0] : 0;
        left = tl;
        for (int64_t x = 0; x < w; ++x) {
            const int t = top[x], g = left + t - tl;
            left = (row[x] + (g < 0 ? 0 : g > 255 ? 255 : g)) & 255;
            tl = t;
            cur[x] = uint8_t(left);
        }
    }
}
