// JPEG: the Huffman decoding of one scan into the components' quantized
// coefficients, and the dequantisation, islow IDCT and range limit of a
// component's blocks.
//
// The native stages of utils/jpeg.py (read_jpeg_mode); _decode_scan_plain
// and _idct_plane_plain there are their plain versions, which the tests
// hold them to, failures included. mnt_jpeg_scan follows libjpeg's
// jdhuff.c (sequential) and jdphuff.c (progressive: DC and AC, first and
// refinement scans, EOB runs) as the plain version does: the scan is split
// at its restart markers, each segment unstuffed (FF00 -> FF) and read as
// if followed by 1-bits (the JPEG fill); each segment restarts the DC
// predictors and the EOB run. Coefficients are stored as int16, libjpeg's
// JCOEF, wrapping as its (JCOEF) casts do. mnt_jpeg_idct is jidctint.c's
// islow IDCT in 64-bit integers (13-bit constants, two passes with 2 bits
// between them) and its 10-bit range limit.
//
// Every read of the scan and every index into a coefficient array is
// checked against its bounds; a failure returns the plain version's
// exception as a code.

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

const int ZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum {
    OK = 0,
    BAD_CODE = 1,      // ValueError("corrupt JPEG: bad Huffman code")
    PAST_END = 2,      // IndexError: a window past the segment's fill
    BAD_SHIFT = 3,     // ValueError: a DC category over 16
    PAST_BLOCK = 4,    // IndexError: a coefficient index over 63
    NO_TABLE = 5,      // KeyError: (class, id) in info[0:2]
    PAST_ARRAY = 6,    // IndexError: a block outside its array
};

inline int16_t jcoef(int64_t v) { return int16_t(uint16_t(uint64_t(v))); }

// One unstuffed entropy segment, read 16 bits at a time from any bit.
struct Segment {
    std::vector<uint8_t> bytes;   // unstuffed, then 8 bytes of 0xFF
    int64_t windows = 0;          // the plain version's window count

    void load(const uint8_t *p, int64_t n) {
        bytes.clear();
        bytes.reserve(n + 8);
        for (int64_t i = 0; i < n; ++i) {
            bytes.push_back(p[i]);
            if (p[i] == 0xFF && i + 1 < n && p[i + 1] == 0x00) ++i;
        }
        windows = 8 * int64_t(bytes.size()) + 16;
        bytes.insert(bytes.end(), 8, 0xFF);
    }
    // the 16 bits from bit `pos` (pos < windows: at most 4 bytes past the
    // data, inside the fill)
    uint32_t at(int64_t pos) const {
        const uint8_t *q = bytes.data() + (pos >> 3);
        const uint32_t w = uint32_t(q[0]) << 24 | uint32_t(q[1]) << 16 |
                           uint32_t(q[2]) << 8 | q[3];
        return (w << (pos & 7)) >> 16;
    }
};

// Load the entropy segment of `scan` that starts at byte `i` into `seg`:
// up to a restart marker (FF D0-D7), `i` moving past it, or to the scan's
// end; returns whether it was the last.
bool next_segment(const uint8_t *scan, int64_t len, int64_t &i,
                  Segment &seg) {
    const int64_t start = i;
    int64_t end = len;
    bool last = true;
    while (true) {
        int64_t j = i;
        while (j < len && scan[j] != 0xFF) ++j;
        if (j >= len || j + 1 >= len) break;
        if (scan[j + 1] >= 0xD0 && scan[j + 1] <= 0xD7) {
            end = j;
            i = j + 2;
            last = false;
            break;
        }
        i = j + 2;
    }
    seg.load(scan + start, end - start);
    return last;
}

struct Entry {          // one component of the scan
    int16_t *coef;      // (rows, cols, 64) natural order
    int64_t rows, cols;
    int h, v, comp;
    const uint8_t *dc_len, *dc_sym, *ac_len, *ac_sym;
    int td, ta;
};

struct Scan {
    const Segment *seg;
    int64_t pos;
    int ss, se, ah, al;
    int64_t eobrun;
    int64_t *info;

#define WIN(var)                                          \
    if (pos >= seg->windows) return PAST_END;             \
    const uint32_t var = seg->at(pos)

    int dc_first(const Entry &e, int16_t *blk, int64_t &pred) {
        if (!e.dc_len) {
            info[0] = 0;
            info[1] = e.td;
            return NO_TABLE;
        }
        WIN(win);
        const int n = e.dc_len[win];
        if (n == 0) return BAD_CODE;
        const int s = e.dc_sym[win];
        pos += n;
        int64_t diff = 0;
        if (s) {
            WIN(w2);
            if (s > 16) return BAD_SHIFT;
            diff = w2 >> (16 - s);
            pos += s;
            if (diff < (int64_t(1) << (s - 1))) diff -= (int64_t(1) << s) - 1;
        }
        pred += diff;
        blk[0] = jcoef(pred * (int64_t(1) << al));
        return OK;
    }

    int ac_first(const Entry &e, int16_t *blk) {
        if (eobrun) {
            --eobrun;
            return OK;
        }
        int k = ss > 1 ? ss : 1;
        while (k <= se) {
            WIN(win);
            const int n = e.ac_len[win];
            if (n == 0) return BAD_CODE;
            const int rs = e.ac_sym[win];
            pos += n;
            const int r = rs >> 4, s = rs & 15;
            if (s == 0) {
                if (r != 15) {
                    if (ss) {                          // an EOB run
                        eobrun = int64_t(1) << r;
                        if (r) {
                            WIN(w2);
                            eobrun += w2 >> (16 - r);
                            pos += r;
                        }
                        eobrun -= 1;
                    }
                    break;
                }
                k += 16;
                continue;
            }
            k += r;
            WIN(w2);
            int64_t val = w2 >> (16 - s);
            pos += s;
            if (val < (int64_t(1) << (s - 1))) val -= (int64_t(1) << s) - 1;
            if (k >= 64) return PAST_BLOCK;
            blk[ZIGZAG[k]] = jcoef(val * (int64_t(1) << al));
            ++k;
        }
        return OK;
    }

    // jdphuff.c's decode_mcu_AC_refine on one block
    int ac_refine(const Entry &e, int16_t *blk) {
        const int64_t p1 = int64_t(1) << al, m1 = -p1;
        int k = ss;
        if (eobrun == 0) {
            while (k <= se) {
                WIN(win);
                const int n = e.ac_len[win];
                if (n == 0) return BAD_CODE;
                const int rs = e.ac_sym[win];
                pos += n;
                int r = rs >> 4;
                int64_t s = rs & 15;
                if (s) {
                    WIN(w2);
                    s = (w2 >> 15) ? p1 : m1;
                    pos += 1;
                } else if (r != 15) {
                    eobrun = int64_t(1) << r;
                    if (r) {
                        WIN(w2);
                        eobrun += w2 >> (16 - r);
                        pos += r;
                    }
                    break;
                }
                while (k <= se) {
                    if (k >= 64) return PAST_BLOCK;
                    const int z = ZIGZAG[k];
                    const int64_t c = blk[z];
                    if (c) {
                        WIN(w2);
                        if ((w2 >> 15) && !(c & p1))
                            blk[z] = jcoef(c + (c >= 0 ? p1 : m1));
                        pos += 1;
                    } else {
                        if (--r < 0) break;
                    }
                    ++k;
                }
                if (s) {
                    if (k >= 64) return PAST_BLOCK;
                    blk[ZIGZAG[k]] = jcoef(s);
                }
                ++k;
            }
        }
        if (eobrun > 0) {
            while (k <= se) {
                if (k >= 64) return PAST_BLOCK;
                const int z = ZIGZAG[k];
                const int64_t c = blk[z];
                if (c) {
                    WIN(w2);
                    if ((w2 >> 15) && !(c & p1))
                        blk[z] = jcoef(c + (c >= 0 ? p1 : m1));
                    pos += 1;
                }
                ++k;
            }
            eobrun -= 1;
        }
        return OK;
    }
#undef WIN

    int block(const Entry &e, int64_t by, int64_t bx, int64_t &pred) {
        if (by < 0 || bx < 0 || by >= e.rows || bx >= e.cols)
            return PAST_ARRAY;
        int16_t *blk = e.coef + (by * e.cols + bx) * 64;
        if (ss == 0 && ah) {                                // DC refinement
            if (pos >= seg->windows) return PAST_END;
            if (seg->at(pos) >> 15) blk[0] = jcoef(blk[0] | (int64_t(1) << al));
            pos += 1;
            return OK;
        }
        if (ss == 0) {                                      // DC first
            const int err = dc_first(e, blk, pred);
            if (err || se == 0) return err;
        }
        if (!e.ac_len) {
            info[0] = 1;
            info[1] = e.ta;
            return NO_TABLE;
        }
        return ah ? ac_refine(e, blk) : ac_first(e, blk);
    }
};

}  // namespace

// Decode one scan (the bytes between its SOS header and the next marker
// that is not a restart) into the coefficient arrays of its `ns`
// components. Per component i: coef[i], geo[4i:4i+4] = (rows, cols, h, v)
// of its array, comp[i] its index in the frame (its DC predictor), luts[4i:
// 4i+4] its DC and AC tables' code length and symbol of every 16-bit
// window (null where the file defined none), tid[2i:2i+2] their ids.
// grid = (blocks a row, blocks) of a one-component scan, else (MCUs a row,
// MCUs). Returns 0 or an error code (see the enum; info holds a missing
// table's class and id).
extern "C" int mnt_jpeg_scan(const uint8_t *scan, int64_t len, int ns,
                             int16_t *const *coef, const int64_t *geo,
                             const int32_t *comp, const uint8_t *const *luts,
                             const int32_t *tid, int64_t restart,
                             int64_t per_row, int64_t n_mcu, int ss, int se,
                             int ah, int al, int64_t *info) {
    std::vector<Entry> ents(ns);
    for (int i = 0; i < ns; ++i)
        ents[i] = Entry{coef[i], geo[4 * i], geo[4 * i + 1],
                        int(geo[4 * i + 2]), int(geo[4 * i + 3]), comp[i],
                        luts[4 * i], luts[4 * i + 1], luts[4 * i + 2],
                        luts[4 * i + 3], tid[2 * i], tid[2 * i + 1]};
    const bool single = ns == 1;
    // the blocks of an MCU: (entry, v, h)
    std::vector<int64_t> blocks;
    for (int i = 0; i < ns; ++i) {
        const int nv = single ? 1 : ents[i].v, nh = single ? 1 : ents[i].h;
        for (int v = 0; v < nv; ++v)
            for (int h = 0; h < nh; ++h) {
                blocks.push_back(i);
                blocks.push_back(v);
                blocks.push_back(h);
            }
    }
    const int64_t per_seg = restart ? restart : n_mcu;
    Segment seg;
    Scan sc{&seg, 0, ss, se, ah, al, 0, info};
    int64_t pred[256];
    int64_t mcu = 0, i = 0;
    bool last = false;
    while (!last && mcu < n_mcu) {
        last = next_segment(scan, len, i, seg);
        sc.pos = 0;
        sc.eobrun = 0;
        for (int k = 0; k < 256; ++k) pred[k] = 0;
        const int64_t todo = per_seg < n_mcu - mcu ? per_seg : n_mcu - mcu;
        for (int64_t t = 0; t < todo; ++t, ++mcu) {
            const int64_t my = mcu / per_row, mx = mcu % per_row;
            for (size_t b = 0; b < blocks.size(); b += 3) {
                const Entry &e = ents[blocks[b]];
                const int64_t by = single ? my : my * e.v + blocks[b + 1];
                const int64_t bx = single ? mx : mx * e.h + blocks[b + 2];
                const int err = sc.block(e, by, bx, pred[e.comp & 255]);
                if (err) return err;
            }
        }
    }
    return OK;
}

// Dequantize (q: 64 natural-order quantizers) and inverse-transform the
// (rows, cols) blocks of `coef` into out, (rows * 8, cols * 8) samples.
extern "C" void mnt_jpeg_idct(const int16_t *coef, int64_t rows, int64_t cols,
                              const int64_t *q, uint8_t *out) {
    const int CB = 13, P1 = 2;
    const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;
    // one pass of 8 points c[0..7] (stride sc) to o[0..7] (stride so)
    auto pass = [&](const int64_t *c, int sc, int64_t *o, int so, int n) {
        int64_t z2 = c[2 * sc], z3 = c[6 * sc];
        int64_t z1 = (z2 + z3) * F0_541;
        const int64_t tmp2 = z1 - z3 * F1_847, tmp3 = z1 + z2 * F0_765;
        const int64_t tmp0 = (c[0] + c[4 * sc]) * (int64_t(1) << CB);
        const int64_t tmp1 = (c[0] - c[4 * sc]) * (int64_t(1) << CB);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3,
                      tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        int64_t t0 = c[7 * sc], t1 = c[5 * sc], t2 = c[3 * sc],
                t3 = c[1 * sc];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        int64_t z4 = t1 + t3;
        const int64_t z5 = (z3 + z4) * F1_175;
        t0 *= F0_298;
        t1 *= F2_053;
        t2 *= F3_072;
        t3 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 = z3 * -F1_961 + z5;
        z4 = z4 * -F0_390 + z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int64_t r[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1,
                              tmp13 + t0, tmp13 - t0, tmp12 - t1,
                              tmp11 - t2, tmp10 - t3};
        const int64_t half = int64_t(1) << (n - 1);
        for (int k = 0; k < 8; ++k) o[k * so] = (r[k] + half) >> n;
    };
    const int64_t W = cols * 8;
    for (int64_t by = 0; by < rows; ++by)
        for (int64_t bx = 0; bx < cols; ++bx) {
            const int16_t *blk = coef + (by * cols + bx) * 64;
            int64_t in[64], ws[64], res[64];
            for (int k = 0; k < 64; ++k) in[k] = int64_t(blk[k]) * q[k];
            for (int u = 0; u < 8; ++u)          // columns: ws[y][u]
                pass(in + u, 8, ws + u, 8, CB - P1);
            for (int y = 0; y < 8; ++y)          // rows: res[y][x]
                pass(ws + 8 * y, 1, res + 8 * y, 1, CB + P1 + 3);
            uint8_t *o = out + by * 8 * W + bx * 8;
            for (int y = 0; y < 8; ++y)
                for (int x = 0; x < 8; ++x) {
                    const int64_t j = res[8 * y + x] & 1023;
                    o[y * W + x] = uint8_t(j < 128   ? j + 128
                                           : j < 512 ? 255
                                           : j < 896 ? 0
                                                     : j - 896);
                }
        }
}

// Upsample a component's (dh, dw) samples by (rh, rv) to out, (H, W), as
// libjpeg's defaults do (jdsample.c): h2v1 and h2v2 by the fancy
// (triangular) filters where the component is over two samples wide, h1v2
// by its fancy filter, any other integer ratio by box replication.
extern "C" void mnt_jpeg_upsample(const uint8_t *p, int64_t dh, int64_t dw,
                                  int rh, int rv, int64_t W, int64_t H,
                                  uint8_t *out) {
    const bool fancy = ((rh == 2 && (rv == 1 || rv == 2)) && dw > 2) ||
                       (rh == 1 && rv == 2);
    for (int64_t y = 0; y < H; ++y) {
        uint8_t *o = out + y * W;
        if (!fancy) {
            const uint8_t *src = p + (y / rv) * dw;
            for (int64_t x = 0; x < W; ++x) o[x] = src[x / rh];
            continue;
        }
        // the row's vertical sums (3 nearer + farther) or the row itself
        const int64_t i = rv == 2 ? y >> 1 : y;
        const uint8_t *near = p + i * dw;
        const uint8_t *far = nullptr;
        if (rv == 2) {
            const int64_t f = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1)
                                      : (i > 0 ? i - 1 : 0);
            far = p + f * dw;
        }
        auto r = [&](int64_t j) -> int {
            return rv == 2 ? 3 * near[j] + far[j] : near[j];
        };
        for (int64_t x = 0; x < W; ++x) {
            if (rh == 1) {                               // h1v2
                o[x] = uint8_t((r(x) + ((y & 1) ? 2 : 1)) >> 2);
                continue;
            }
            const int64_t j = x >> 1;
            if (!(x & 1)) {
                const int l = r(j > 0 ? j - 1 : 0);
                o[x] = uint8_t(rv == 2 ? (3 * r(j) + l + 8) >> 4
                                       : (3 * r(j) + l + 1) >> 2);
            } else {
                const int rr = r(j + 1 < dw ? j + 1 : dw - 1);
                o[x] = uint8_t(rv == 2 ? (3 * r(j) + rr + 7) >> 4
                                       : (3 * r(j) + rr + 2) >> 2);
            }
        }
    }
}

// jdcolor.c's ycc_rgb_convert (16-bit fixed point) of n samples into
// out, (n, 3) RGB
extern "C" void mnt_jpeg_ycc_rgb(const uint8_t *y, const uint8_t *cb,
                                 const uint8_t *cr, int64_t n, uint8_t *out) {
    auto clip = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int64_t k = 0; k < n; ++k) {
        const int Y = y[k], b = cb[k] - 128, r = cr[k] - 128;
        out[3 * k] = clip(Y + ((91881 * r + 32768) >> 16));
        out[3 * k + 1] = clip(Y + ((-22554 * b + 32768 - 46802 * r) >> 16));
        out[3 * k + 2] = clip(Y + ((116130 * b + 32768) >> 16));
    }
}

// A lossless (SOF3) scan of `ns` components, each of W x H samples:
// Huffman-coded differences (categories 0-16, 16 meaning 32768; luts: a
// length and a symbol table a component, null where the table is
// missing), added mod 2^16 to predictor `psv` of the neighbours left (a),
// above (b) and above-left (c) (0 acts as 7, as the plain version's
// tuple index -1 does); the first row of each restart interval (`restart`
// samples, whole rows; 0: none) predicts from the left, the first column
// from above, the first sample from 2^(7 - pt). out: ns planes of
// ((sample << pt) & 255). Fails as _decode_lossless_plain: first in the
// differences (codes 1-5 of mnt_jpeg_scan, info[1] the missing table's
// id), then code 3 for pt > 7, then 7 (IndexError) for psv > 7.
extern "C" int mnt_jpeg_lossless(const uint8_t *scan, int64_t len, int ns,
                                 const uint8_t *const *luts,
                                 const int32_t *td, int64_t restart,
                                 int64_t W, int64_t H, int psv, int pt,
                                 uint8_t *out, int64_t *info) {
    const int64_t n = W * H, per_seg = restart ? restart : n;
    std::vector<int32_t> diff(size_t(n) * ns, 0);
    Segment seg;
    int64_t k = 0, i = 0;
    bool last = false;
    while (!last && k < n) {
        last = next_segment(scan, len, i, seg);
        int64_t pos = 0;
        const int64_t todo = per_seg < n - k ? per_seg : n - k;
        for (int64_t t = 0; t < todo; ++t, ++k) {
            for (int j = 0; j < ns; ++j) {
                const uint8_t *dl = luts[2 * j], *ds = luts[2 * j + 1];
                if (!dl) {
                    info[0] = 0;
                    info[1] = td[j];
                    return NO_TABLE;
                }
                if (pos >= seg.windows) return PAST_END;
                const uint32_t win = seg.at(pos);
                const int m = dl[win];
                if (m == 0) return BAD_CODE;
                const int s = ds[win];
                pos += m;
                int64_t d = 0;
                if (s == 16) {
                    d = 32768;
                } else if (s) {
                    if (pos >= seg.windows) return PAST_END;
                    const uint32_t w2 = seg.at(pos);
                    if (s > 16) return BAD_SHIFT;
                    d = w2 >> (16 - s);
                    pos += s;
                    if (d < (int64_t(1) << (s - 1))) d -= (int64_t(1) << s) - 1;
                }
                diff[size_t(k) * ns + j] = int32_t(d);
            }
        }
    }
    if (ns > 0 && pt > 7) return BAD_SHIFT;
    const int64_t rows_per = per_seg / W;
    const int p = psv == 0 ? 7 : psv;
    if (ns > 0 && p > 7 && W > 1 && rows_per > 1 && H > 1) return 7;
    std::vector<int64_t> prior(static_cast<size_t>(W)),
        cur(static_cast<size_t>(W));
    for (int j = 0; j < ns; ++j) {
        uint8_t *o = out + size_t(j) * size_t(n);
        for (int64_t y = 0; y < H; ++y) {
            const bool first = y % rows_per == 0;
            const int32_t *d = diff.data() + size_t(y) * W * ns + j;
            for (int64_t x = 0; x < W; ++x) {
                int64_t pred;
                if (first) {
                    pred = x ? cur[x - 1] : int64_t(1) << (7 - pt);
                } else if (x == 0) {
                    pred = prior[0];
                } else {
                    const int64_t a = cur[x - 1], b = prior[x],
                                  c = prior[x - 1];
                    switch (p) {
                    case 1: pred = a; break;
                    case 2: pred = b; break;
                    case 3: pred = c; break;
                    case 4: pred = a + b - c; break;
                    case 5: pred = a + ((b - c) >> 1); break;
                    case 6: pred = b + ((a - c) >> 1); break;
                    default: pred = (a + b) >> 1; break;
                    }
                }
                cur[x] = (pred + d[size_t(x) * ns]) & 0xFFFF;
                o[y * W + x] = uint8_t((cur[x] << pt) & 0xFF);
            }
            std::swap(prior, cur);
        }
    }
    return OK;
}
