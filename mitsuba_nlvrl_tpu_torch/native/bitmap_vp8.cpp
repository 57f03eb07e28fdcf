// WebP lossy (a VP8 key frame): every macroblock's modes, tokens,
// reconstruction and loop filter, from the frame header that
// utils/vp8.py read, to the filtered Y, U and V planes.
//
// The native stage of utils/vp8.py's decode_yuv; _frame_plain there is its
// plain version, which the tests hold it to. It decodes as libwebp does
// where libwebp departs from RFC 6386, as the plain version does: the
// boolean decoder keeps range - 1 and loading past a partition's last
// byte fails the decode (libwebp's premature end); coefficients and the
// Walsh-Hadamard outputs are stored in 16 bits; prediction reads the
// unfiltered neighbours of libwebp's work buffer (127 above the frame,
// 129 left of it, the above-right pixels replicated down the right
// subblocks); the inverse transform is computed in wrapping 32-bit
// integers; the loop filter runs in macroblock order on the whole frame,
// its DoFilter2 without the RFC's clamp. Every index is inside the planes
// the caller allocated (16 * mbh x 16 * mbw luma, 8 * mbh x 8 * mbw
// chroma).

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

enum { DC = 0, TM = 1, VE = 2, HE = 3 };
enum { OK = 0, PREMATURE_END = 1 };

const int YMODES_INTRA4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3,
                               5, -4, -5, -6, 7, -7, 8, -8, -9};
const int ZIGZAG[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t CAT3[] = {173, 148, 140};
const uint8_t CAT4[] = {176, 155, 140, 135};
const uint8_t CAT5[] = {180, 157, 141, 134, 130};
const uint8_t CAT6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129};
const uint8_t *const CAT3456[4] = {CAT3, CAT4, CAT5, CAT6};
const int CAT_LEN[4] = {3, 4, 5, 11};
const int YB = 21, CB = 9;     // the work buffers' strides

// RFC 6386's boolean decoder in libwebp's form (range kept less one)
struct BoolDec {
    const uint8_t *d = nullptr;
    int64_t pos = 0, end = 0;
    uint64_t value = 0;
    int bits = -8;
    uint32_t rng = 254;
    bool eof = false;

    int bit(int prob) {
        if (eof) return 0;
        if (bits < 0) {
            const int64_t n = end - pos < 7 ? end - pos : 7;
            if (n <= 0) {
                eof = true;
                return 0;
            }
            for (int64_t i = 0; i < n; ++i) value = (value << 8) | d[pos + i];
            bits += int(8 * n);
            pos += n;
        }
        const uint32_t split = (rng * uint32_t(prob)) >> 8;
        uint32_t r;
        int v;
        if ((value >> bits) > split) {
            r = rng - split;
            value -= uint64_t(split + 1) << bits;
            v = 1;
        } else {
            r = split + 1;
            v = 0;
        }
        const int s = __builtin_clz(r) - 24;   // 8 - bit length of r
        rng = (r << s) - 1;
        bits -= s;
        return v;
    }
};

struct Mode {
    int seg, skip, is_i4, ymode, uvmode;
    uint8_t imodes[16];
};

inline int32_t w32(int64_t v) { return int32_t(uint32_t(uint64_t(v))); }
inline int32_t mul1(int32_t a) {
    return w32((w32(int64_t(a) * 20091) >> 16) + int64_t(a));
}
inline int32_t mul2(int32_t a) { return w32(int64_t(a) * 35468) >> 16; }
inline int16_t i16(int64_t v) { return int16_t(uint16_t(uint64_t(v))); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int clamp(int v, int lo, int hi) {
    return v < lo ? lo : v > hi ? hi : v;
}
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// libwebp's inverse transform of 16 raster coefficients to residuals,
// clipped to +-255 (past which they clip alike once added)
void idct(const int16_t *c, int *res) {
    int32_t t[4][4];
    for (int col = 0; col < 4; ++col) {
        const int32_t c0 = c[col], c1 = c[4 + col], c2 = c[8 + col],
                      c3 = c[12 + col];
        const int32_t a = w32(int64_t(c0) + c2), b = w32(int64_t(c0) - c2);
        const int32_t cc = w32(int64_t(mul2(c1)) - mul1(c3));
        const int32_t d = w32(int64_t(mul1(c1)) + mul2(c3));
        t[0][col] = w32(int64_t(a) + d);
        t[1][col] = w32(int64_t(b) + cc);
        t[2][col] = w32(int64_t(b) - cc);
        t[3][col] = w32(int64_t(a) - d);
    }
    for (int k = 0; k < 4; ++k) {
        const int32_t dc = w32(int64_t(t[k][0]) + 4);
        const int32_t a = w32(int64_t(dc) + t[k][2]),
                      b = w32(int64_t(dc) - t[k][2]);
        const int32_t cc = w32(int64_t(mul2(t[k][1])) - mul1(t[k][3]));
        const int32_t d = w32(int64_t(mul1(t[k][1])) + mul2(t[k][3]));
        const int32_t o[4] = {
            w32(int64_t(a) + d) >> 3, w32(int64_t(b) + cc) >> 3,
            w32(int64_t(b) - cc) >> 3, w32(int64_t(a) - d) >> 3};
        for (int j = 0; j < 4; ++j) res[4 * k + j] = clamp(o[j], -255, 255);
    }
}

void wht(const int16_t *dc, int16_t *out) {
    int64_t tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int64_t a0 = dc[i] + dc[12 + i], a1 = dc[4 + i] + dc[8 + i];
        const int64_t a2 = dc[4 + i] - dc[8 + i], a3 = dc[i] - dc[12 + i];
        tmp[i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int64_t d = tmp[4 * i] + 3;
        const int64_t *t = tmp + 4 * i;
        const int64_t a0 = d + t[3], a1 = t[1] + t[2];
        const int64_t a2 = t[1] - t[2], a3 = d - t[3];
        out[4 * i] = i16((a0 + a1) >> 3);
        out[4 * i + 1] = i16((a3 + a2) >> 3);
        out[4 * i + 2] = i16((a0 - a1) >> 3);
        out[4 * i + 3] = i16((a3 - a2) >> 3);
    }
}

// the coefficient probabilities: [type][position 0-16][ctx][11]
struct Probas {
    const uint8_t *p;
    const uint8_t *at(int t, int n, int ctx) const {
        return p + ((t * 17 + n) * 3 + ctx) * 11;
    }
};

int large(BoolDec &br, const uint8_t *p) {
    if (!br.bit(p[3])) {
        if (!br.bit(p[4])) return 2;
        return 3 + br.bit(p[5]);
    }
    if (!br.bit(p[6])) {
        if (!br.bit(p[7])) return 5 + br.bit(159);
        const int b = br.bit(165);
        return 7 + 2 * b + br.bit(145);
    }
    const int b1 = br.bit(p[8]);
    const int cat = 2 * b1 + br.bit(p[9 + b1]);
    int v = 0;
    for (int i = 0; i < CAT_LEN[cat]; ++i) v = v + v + br.bit(CAT3456[cat][i]);
    return v + 3 + (8 << cat);
}

// one block's tokens from position n, dequantised into out (raster);
// returns libwebp's count
int coeffs(BoolDec &br, const Probas &pr, int t, int ctx, int dq0, int dq1,
           int n, int32_t *out) {
    const uint8_t *p = pr.at(t, n, ctx);
    while (n < 16) {
        if (!br.bit(p[0])) return n;
        while (!br.bit(p[1])) {
            if (++n == 16) return 16;
            p = pr.at(t, n, 0);
        }
        int v;
        if (!br.bit(p[2])) {
            v = 1;
            p = pr.at(t, n + 1, 1);
        } else {
            v = large(br, p);
            p = pr.at(t, n + 1, 2);
        }
        if (br.bit(0x80)) v = -v;
        out[ZIGZAG[n]] = v * (n ? dq1 : dq0);
        ++n;
    }
    return 16;
}

struct Nz {
    uint32_t nz = 0, dc = 0;
};

// libwebp's ParseResiduals: one macroblock's dequantised coefficients
// (24 blocks of 16, stored as int16) and the non-zero contexts; returns
// whether every block came out empty
bool residuals(BoolDec &br, const Probas &pr, const int32_t *q, bool is_i4,
               Nz &top, Nz &left, int16_t *coef) {
    int32_t c[384] = {0};
    bool nz_any = false;
    int first, ac;
    if (!is_i4) {
        int32_t dc[16] = {0};
        const int nz = coeffs(br, pr, 1, int(top.dc + left.dc), q[2], q[3], 0,
                              dc);
        top.dc = left.dc = nz > 0;
        int16_t d16[16], w[16];
        for (int k = 0; k < 16; ++k) d16[k] = i16(dc[k]);
        if (nz > 1) {
            wht(d16, w);
        } else {
            for (int k = 0; k < 16; ++k) w[k] = int16_t((d16[0] + 3) >> 3);
        }
        for (int k = 0; k < 16; ++k) c[16 * k] = w[k];
        first = 1;
        ac = 0;
    } else {
        first = 0;
        ac = 3;
    }
    uint32_t tnz = top.nz & 0x0F, lnz = left.nz & 0x0F;
    for (int y = 0; y < 4; ++y) {
        uint32_t lb = lnz & 1;
        for (int x = 0; x < 4; ++x) {
            const int off = 64 * y + 16 * x;
            const int nz = coeffs(br, pr, ac, int(lb + (tnz & 1)), q[0], q[1],
                                  first, c + off);
            lb = nz > first;
            tnz = (tnz >> 1) | (lb << 7);
            nz_any |= nz > 1 || c[off] != 0;
        }
        tnz >>= 4;
        lnz = (lnz >> 1) | (lb << 7);
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch <= 2; ch += 2) {
        tnz = top.nz >> (4 + ch);
        lnz = left.nz >> (4 + ch);
        for (int y = 0; y < 2; ++y) {
            uint32_t lb = lnz & 1;
            for (int x = 0; x < 2; ++x) {
                const int off = 256 + 32 * ch + 32 * y + 16 * x;
                const int nz = coeffs(br, pr, 2, int(lb + (tnz & 1)), q[4],
                                      q[5], 0, c + off);
                lb = nz > 0;
                tnz = (tnz >> 1) | (lb << 3);
                nz_any |= nz > 1 || c[off] != 0;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (lb << 5);
        }
        out_t |= (tnz << 4) << ch;
        out_l |= (lnz & 0xF0) << ch;
    }
    top.nz = out_t;
    left.nz = out_l;
    for (int k = 0; k < 384; ++k) coef[k] = i16(c[k]);
    return !nz_any;
}

// the 16 pixels (rows of 4) of a 4x4 intra mode at buf[o]
void pred4(const int *buf, int o, int mode, int *d) {
    const int t = o - YB;
    if (mode == DC) {
        int s = 4;
        for (int i = 0; i < 4; ++i) s += buf[t + i] + buf[o - 1 + i * YB];
        for (int i = 0; i < 16; ++i) d[i] = s >> 3;
        return;
    }
    if (mode == TM) {
        const int tl = buf[t - 1];
        for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x)
                d[4 * y + x] = clip255(buf[t + x] + buf[o - 1 + y * YB] - tl);
        return;
    }
    if (mode == VE) {
        for (int x = 0; x < 4; ++x) {
            const int v = avg3(buf[t + x - 1], buf[t + x], buf[t + x + 1]);
            for (int y = 0; y < 4; ++y) d[4 * y + x] = v;
        }
        return;
    }
    const int X = buf[t - 1];
    const int A = buf[t], B = buf[t + 1], C = buf[t + 2], D = buf[t + 3],
              E = buf[t + 4], F = buf[t + 5], G = buf[t + 6], H = buf[t + 7];
    const int I = buf[o - 1], J = buf[o - 1 + YB], K = buf[o - 1 + 2 * YB],
              L = buf[o - 1 + 3 * YB];
    auto s = [&](int x, int y, int v) { d[4 * y + x] = v; };
    int v;
    switch (mode) {
    case HE: {
        const int rows[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                             avg3(K, L, L)};
        for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) d[4 * y + x] = rows[y];
        break;
    }
    case 4:                                                  // RD
        s(0, 3, avg3(J, K, L));
        v = avg3(I, J, K); s(1, 3, v); s(0, 2, v);
        v = avg3(X, I, J); s(2, 3, v); s(1, 2, v); s(0, 1, v);
        v = avg3(A, X, I); s(3, 3, v); s(2, 2, v); s(1, 1, v); s(0, 0, v);
        v = avg3(B, A, X); s(3, 2, v); s(2, 1, v); s(1, 0, v);
        v = avg3(C, B, A); s(3, 1, v); s(2, 0, v);
        s(3, 0, avg3(D, C, B));
        break;
    case 5:                                                  // VR
        v = avg2(X, A); s(0, 0, v); s(1, 2, v);
        v = avg2(A, B); s(1, 0, v); s(2, 2, v);
        v = avg2(B, C); s(2, 0, v); s(3, 2, v);
        s(3, 0, avg2(C, D));
        s(0, 3, avg3(K, J, I));
        s(0, 2, avg3(J, I, X));
        v = avg3(I, X, A); s(0, 1, v); s(1, 3, v);
        v = avg3(X, A, B); s(1, 1, v); s(2, 3, v);
        v = avg3(A, B, C); s(2, 1, v); s(3, 3, v);
        s(3, 1, avg3(B, C, D));
        break;
    case 6:                                                  // LD
        s(0, 0, avg3(A, B, C));
        v = avg3(B, C, D); s(1, 0, v); s(0, 1, v);
        v = avg3(C, D, E); s(2, 0, v); s(1, 1, v); s(0, 2, v);
        v = avg3(D, E, F); s(3, 0, v); s(2, 1, v); s(1, 2, v); s(0, 3, v);
        v = avg3(E, F, G); s(3, 1, v); s(2, 2, v); s(1, 3, v);
        v = avg3(F, G, H); s(3, 2, v); s(2, 3, v);
        s(3, 3, avg3(G, H, H));
        break;
    case 7:                                                  // VL
        s(0, 0, avg2(A, B));
        v = avg2(B, C); s(1, 0, v); s(0, 2, v);
        v = avg2(C, D); s(2, 0, v); s(1, 2, v);
        v = avg2(D, E); s(3, 0, v); s(2, 2, v);
        s(0, 1, avg3(A, B, C));
        v = avg3(B, C, D); s(1, 1, v); s(0, 3, v);
        v = avg3(C, D, E); s(2, 1, v); s(1, 3, v);
        v = avg3(D, E, F); s(3, 1, v); s(2, 3, v);
        s(3, 2, avg3(E, F, G));
        s(3, 3, avg3(F, G, H));
        break;
    case 8:                                                  // HD
        v = avg2(I, X); s(0, 0, v); s(2, 1, v);
        v = avg2(J, I); s(0, 1, v); s(2, 2, v);
        v = avg2(K, J); s(0, 2, v); s(2, 3, v);
        s(0, 3, avg2(L, K));
        s(3, 0, avg3(A, B, C));
        s(2, 0, avg3(X, A, B));
        v = avg3(I, X, A); s(1, 0, v); s(3, 1, v);
        v = avg3(J, I, X); s(1, 1, v); s(3, 2, v);
        v = avg3(K, J, I); s(1, 2, v); s(3, 3, v);
        s(1, 3, avg3(L, K, J));
        break;
    default:                                                 // HU
        s(0, 0, avg2(I, J));
        v = avg2(J, K); s(2, 0, v); s(0, 1, v);
        v = avg2(K, L); s(2, 1, v); s(0, 2, v);
        s(1, 0, avg3(I, J, K));
        v = avg3(J, K, L); s(3, 0, v); s(1, 1, v);
        v = avg3(K, L, L); s(3, 1, v); s(1, 2, v);
        s(3, 2, L); s(2, 2, L); s(0, 3, L); s(1, 3, L); s(2, 3, L);
        s(3, 3, L);
        break;
    }
}

// a 16x16 luma or 8x8 chroma prediction (rows of size) from a work
// buffer of stride bps; DC at the frame's top or left edge averages what
// is there, as in libwebp
void pred_block(const int *buf, int bps, int size, int mode, int64_t mb_x,
                int64_t mb_y, int *d) {
    const int o = bps + 1;
    const int sh = size == 16 ? 4 : 3;
    const int *top = buf + 1;
    auto left = [&](int y) { return buf[o - 1 + y * bps]; };
    if (mode == DC) {
        int st = 0, sl = 0;
        for (int i = 0; i < size; ++i) {
            st += top[i];
            sl += left(i);
        }
        int v;
        if (mb_x && mb_y) v = (st + sl + size) >> (sh + 1);
        else if (mb_y) v = (st + (size >> 1)) >> sh;
        else if (mb_x) v = (sl + (size >> 1)) >> sh;
        else v = 0x80;
        for (int i = 0; i < size * size; ++i) d[i] = v;
        return;
    }
    for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x)
            d[y * size + x] = mode == VE   ? top[x]
                              : mode == HE ? left(y)
                                           : clip255(top[x] + left(y) - buf[0]);
}

// libwebp's edge filters on one line across an edge at p (step: one pixel
// across it). kind: 0 simple, 1 macroblock edge, 2 inner edge.
void filter_line(uint8_t *p, int64_t st, int thresh, int ilevel, int hev_t,
                 int kind) {
    const int p3 = p[-4 * st], p2 = p[-3 * st], p1 = p[-2 * st], p0 = p[-st];
    const int q0 = p[0], q1 = p[st], q2 = p[2 * st], q3 = p[3 * st];
    bool mask = 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= 2 * thresh + 1;
    bool hev;
    if (kind == 0) {
        hev = mask;
    } else {
        mask = mask && std::abs(p3 - p2) <= ilevel &&
               std::abs(p2 - p1) <= ilevel && std::abs(p1 - p0) <= ilevel &&
               std::abs(q3 - q2) <= ilevel && std::abs(q2 - q1) <= ilevel &&
               std::abs(q1 - q0) <= ilevel;
        hev = mask && (std::abs(p1 - p0) > hev_t || std::abs(q1 - q0) > hev_t);
    }
    if (hev) {                       // two taps, the RFC's clamp of a left out
        const int a = 3 * (q0 - p0) + clamp(p1 - q1, -128, 127);
        const int a1 = clamp((a + 4) >> 3, -16, 15);
        const int a2 = clamp((a + 3) >> 3, -16, 15);
        p[-st] = uint8_t(clip255(p0 + a2));
        p[0] = uint8_t(clip255(q0 - a1));
    } else if (mask && kind == 1) {
        const int a = clamp(3 * (q0 - p0) + clamp(p1 - q1, -128, 127), -128,
                            127);
        const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
                  a3 = (9 * a + 63) >> 7;
        p[-3 * st] = uint8_t(clip255(p2 + a3));
        p[-2 * st] = uint8_t(clip255(p1 + a2));
        p[-st] = uint8_t(clip255(p0 + a1));
        p[0] = uint8_t(clip255(q0 - a1));
        p[st] = uint8_t(clip255(q1 - a2));
        p[2 * st] = uint8_t(clip255(q2 - a3));
    } else if (mask && kind == 2) {
        const int a = 3 * (q0 - p0);
        const int a1 = clamp((a + 4) >> 3, -16, 15);
        const int a2 = clamp((a + 3) >> 3, -16, 15);
        const int a3 = (a1 + 1) >> 1;
        p[-2 * st] = uint8_t(clip255(p1 + a3));
        p[-st] = uint8_t(clip255(p0 + a2));
        p[0] = uint8_t(clip255(q0 - a1));
        p[st] = uint8_t(clip255(q1 - a3));
    }
}

// the `size` lines of the edge `off` pixels into the block at (y0, x0) of
// a plane with rows of `stride`: across columns (vertical) or rows
void filter_edge(uint8_t *plane, int64_t stride, int64_t y0, int64_t x0,
                 int size, int off, bool vertical, int thresh, int ilevel,
                 int hev_t, int kind) {
    for (int j = 0; j < size; ++j) {
        if (vertical)
            filter_line(plane + (y0 + j) * stride + x0 + off, 1, thresh,
                        ilevel, hev_t, kind);
        else
            filter_line(plane + (y0 + off) * stride + x0 + j, stride, thresh,
                        ilevel, hev_t, kind);
    }
}

}  // namespace

// Decode a key frame's macroblocks. p0: partition 0 from the boolean
// decoder's state after the header (p0_state: value, bits, range - 1,
// position); parts[part_off[i]:part_off[i + 1]]: the token partitions;
// seg_map and seg_probs: the segment map's presence and probabilities;
// skip_p: the skip probability or -1; bmodes: the 4x4 mode probabilities
// [above][left][9]; probas: the coefficient probabilities [4][17][3][11]
// after the frame's updates; quant: each segment's (y1 dc, y1 ac, y2 dc,
// y2 ac, uv dc, uv ac); filt: 0 none, 1 simple, 2 normal; fstr: each
// segment's (limit, interior limit, hev threshold) for 16x16 and 4x4
// macroblocks. Writes Y (16 mbh x 16 mbw), U and V (8 mbh x 8 mbw).
// Returns 0, or 1 where a partition ran out (libwebp's premature end).
extern "C" int mnt_vp8_frame(const uint8_t *p0, int64_t p0_len,
                             const int64_t *p0_state, const uint8_t *parts,
                             const int64_t *part_off, int nparts, int64_t mbw,
                             int64_t mbh, int seg_map,
                             const int32_t *seg_probs, int skip_p,
                             const uint8_t *bmodes, const uint8_t *probas,
                             const int32_t *quant, int filt,
                             const int32_t *fstr, uint8_t *Y, uint8_t *U,
                             uint8_t *V) {
    BoolDec br;
    br.d = p0;
    br.end = p0_len;
    br.value = uint64_t(p0_state[0]);
    br.bits = int(p0_state[1]);
    br.rng = uint32_t(p0_state[2]);
    br.pos = p0_state[3];
    if (br.pos < 0 || br.pos > br.end || br.bits < -8 || br.bits > 56 ||
        br.rng > 254 || nparts < 1 || (nparts & (nparts - 1)))
        return PREMATURE_END;
    // every macroblock's modes, from partition 0 in raster order
    std::vector<Mode> modes(size_t(mbw * mbh));
    std::vector<uint8_t> top(size_t(4 * mbw));
    for (int64_t my = 0, k = 0; my < mbh; ++my) {
        uint8_t left[4] = {DC, DC, DC, DC};
        for (int64_t mx = 0; mx < mbw; ++mx, ++k) {
            Mode &m = modes[k];
            m.seg = 0;
            if (seg_map)
                m.seg = !br.bit(seg_probs[0]) ? br.bit(seg_probs[1])
                                              : 2 + br.bit(seg_probs[2]);
            m.skip = skip_p >= 0 ? br.bit(skip_p) : 0;
            if (br.bit(145)) {                               // 16x16
                if (br.bit(156)) m.ymode = br.bit(128) ? TM : HE;
                else m.ymode = br.bit(163) ? VE : DC;
                for (int i = 0; i < 4; ++i) {
                    top[4 * mx + i] = uint8_t(m.ymode);
                    left[i] = uint8_t(m.ymode);
                }
                m.is_i4 = 0;
            } else {
                m.is_i4 = 1;
                for (int y = 0; y < 4; ++y) {
                    int ym = left[y];
                    for (int x = 0; x < 4; ++x) {
                        const int o = (top[4 * mx + x] * 10 + ym) * 9;
                        int i = YMODES_INTRA4[br.bit(bmodes[o])];
                        while (i > 0)
                            i = YMODES_INTRA4[2 * i + br.bit(bmodes[o + i])];
                        ym = -i;
                        top[4 * mx + x] = uint8_t(ym);
                        m.imodes[4 * y + x] = uint8_t(ym);
                    }
                    left[y] = uint8_t(ym);
                }
            }
            if (!br.bit(142)) m.uvmode = DC;
            else if (!br.bit(114)) m.uvmode = VE;
            else m.uvmode = br.bit(183) ? TM : HE;
        }
        if (br.eof) return PREMATURE_END;
    }
    std::vector<BoolDec> dec(nparts);
    for (int i = 0; i < nparts; ++i) {
        dec[i].d = parts + part_off[i];
        dec[i].end = part_off[i + 1] - part_off[i];
    }
    const Probas pr{probas};
    const int64_t W = 16 * mbw, CW = 8 * mbw;
    // per macroblock: limit, interior limit, hev threshold, inner edges
    std::vector<int32_t> finfo(size_t(4 * mbw * mbh), 0);
    std::vector<Nz> tops(static_cast<size_t>(mbw));
    int16_t coef[384];
    int buf[17 * YB], cbuf[9 * CB], pred[256], res[16];
    for (int64_t mb_y = 0, k = 0; mb_y < mbh; ++mb_y) {
        BoolDec &tb = dec[mb_y & (nparts - 1)];
        Nz left;
        for (int64_t mb_x = 0; mb_x < mbw; ++mb_x, ++k) {
            const Mode &m = modes[k];
            bool skip = m.skip;
            for (int i = 0; i < 384; ++i) coef[i] = 0;
            if (!skip) {
                skip = residuals(tb, pr, quant + 6 * m.seg, m.is_i4, tops[mb_x],
                                 left, coef);
            } else {
                tops[mb_x].nz = left.nz = 0;
                if (!m.is_i4) tops[mb_x].dc = left.dc = 0;
            }
            if (tb.eof) return PREMATURE_END;
            if (filt) {
                const int32_t *f = fstr + (m.seg * 2 + m.is_i4) * 3;
                finfo[4 * k] = f[0];
                finfo[4 * k + 1] = f[1];
                finfo[4 * k + 2] = f[2];
                finfo[4 * k + 3] = m.is_i4 || !skip;
            }
            // luma: the row above (with four above-right pixels), then each
            // row's left neighbour and 16 pixels
            const int64_t y0 = 16 * mb_y, x0 = 16 * mb_x;
            if (mb_y) {
                const uint8_t *above = Y + (y0 - 1) * W;
                buf[0] = mb_x ? above[x0 - 1] : 129;
                for (int i = 0; i < 16; ++i) buf[1 + i] = above[x0 + i];
                for (int i = 0; i < 4; ++i)
                    buf[17 + i] = mb_x < mbw - 1 ? above[x0 + 16 + i]
                                                 : above[x0 + 15];
            } else {
                for (int i = 0; i < YB; ++i) buf[i] = 127;
            }
            for (int j = 0; j < 16; ++j)
                buf[(j + 1) * YB] = mb_x ? Y[(y0 + j) * W + x0 - 1] : 129;
            if (m.is_i4) {
                for (int j = 3; j < 12; j += 4)
                    for (int i = 0; i < 4; ++i)
                        buf[(j + 1) * YB + 17 + i] = buf[17 + i];
                for (int i = 0; i < 16; ++i) {
                    const int o = (4 * (i >> 2) + 1) * YB + 4 * (i & 3) + 1;
                    pred4(buf, o, m.imodes[i], pred);
                    idct(coef + 16 * i, res);
                    for (int yy = 0; yy < 4; ++yy)
                        for (int xx = 0; xx < 4; ++xx)
                            buf[o + yy * YB + xx] =
                                clip255(pred[4 * yy + xx] + res[4 * yy + xx]);
                }
                for (int j = 0; j < 16; ++j)
                    for (int i = 0; i < 16; ++i)
                        Y[(y0 + j) * W + x0 + i] =
                            uint8_t(buf[(j + 1) * YB + 1 + i]);
            } else {
                pred_block(buf, YB, 16, m.ymode, mb_x, mb_y, pred);
                for (int i = 0; i < 16; ++i) {
                    idct(coef + 16 * i, res);
                    const int by = 4 * (i >> 2), bx = 4 * (i & 3);
                    for (int yy = 0; yy < 4; ++yy)
                        for (int xx = 0; xx < 4; ++xx)
                            Y[(y0 + by + yy) * W + x0 + bx + xx] =
                                uint8_t(clip255(pred[(by + yy) * 16 + bx + xx] +
                                                res[4 * yy + xx]));
                }
            }
            const int64_t c0 = 8 * mb_y, cx = 8 * mb_x;
            for (int pl = 0; pl < 2; ++pl) {
                uint8_t *plane = pl ? V : U;
                if (mb_y) {
                    const uint8_t *above = plane + (c0 - 1) * CW;
                    cbuf[0] = mb_x ? above[cx - 1] : 129;
                    for (int i = 0; i < 8; ++i) cbuf[1 + i] = above[cx + i];
                } else {
                    for (int i = 0; i < CB; ++i) cbuf[i] = 127;
                }
                for (int j = 0; j < 8; ++j)
                    cbuf[(j + 1) * CB] =
                        mb_x ? plane[(c0 + j) * CW + cx - 1] : 129;
                pred_block(cbuf, CB, 8, m.uvmode, mb_x, mb_y, pred);
                for (int i = 0; i < 4; ++i) {
                    idct(coef + 16 * (16 + 4 * pl + i), res);
                    const int by = 4 * (i >> 1), bx = 4 * (i & 1);
                    for (int yy = 0; yy < 4; ++yy)
                        for (int xx = 0; xx < 4; ++xx)
                            plane[(c0 + by + yy) * CW + cx + bx + xx] =
                                uint8_t(clip255(pred[(by + yy) * 8 + bx + xx] +
                                                res[4 * yy + xx]));
                }
            }
        }
    }
    if (!filt) return OK;
    // the loop filter, macroblock by macroblock in raster order: the left
    // edge, the inner vertical edges, the top edge, the inner horizontal
    const int kind_mb = filt == 1 ? 0 : 1, kind_in = filt == 1 ? 0 : 2;
    for (int64_t my = 0, k = 0; my < mbh; ++my)
        for (int64_t mx = 0; mx < mbw; ++mx, ++k) {
            const int limit = finfo[4 * k], il = finfo[4 * k + 1],
                      hev = finfo[4 * k + 2];
            const bool inner = finfo[4 * k + 3] > 0;
            if (limit <= 0) continue;
            for (int vert = 1; vert >= 0; --vert) {
                const bool edge = vert ? mx > 0 : my > 0;
                for (int off = 0; off < 16; off += 4) {
                    if (off ? !inner : !edge) continue;
                    const int thresh = off ? limit : limit + 4;
                    const int kind = off ? kind_in : kind_mb;
                    filter_edge(Y, W, 16 * my, 16 * mx, 16, off, vert, thresh,
                                il, hev, kind);
                    if (filt == 1 || off >= 8) continue;
                    filter_edge(U, CW, 8 * my, 8 * mx, 8, off, vert, thresh,
                                il, hev, kind);
                    filter_edge(V, CW, 8 * my, 8 * mx, 8, off, vert, thresh,
                                il, hev, kind);
                }
            }
        }
    return OK;
}

// libwebp's "fancy" upsampling of both chroma planes and its fixed-point
// VP8YUVToR/G/B (14 bits, then clipped) into out, (h, w, 3) RGB. Each luma
// row lies between its two nearest chroma rows (3:1), each pixel between
// its two nearest chroma columns (3:1), rounded as libwebp's line-pair
// upsampler rounds; the first row, and an even height's last, use one
// chroma row, the first column, and an even width's last, one column. Y
// has rows of ys bytes, U and V rows of cs bytes.
extern "C" void mnt_vp8_yuv_rgb(const uint8_t *Y, const uint8_t *U,
                                const uint8_t *V, int64_t ys, int64_t cs,
                                int64_t w, int64_t h, uint8_t *out) {
    const int64_t cw = (w + 1) >> 1, ch = (h + 1) >> 1, n = (w - 1) >> 1;
    std::vector<int> u(static_cast<size_t>(w)), v(static_cast<size_t>(w));
    auto clip8 = [](int x) -> uint8_t {
        return uint8_t((x & ~16383) == 0 ? x >> 6 : x < 0 ? 0 : 255);
    };
    for (int64_t y = 0; y < h; ++y) {
        const int64_t k = (y + 1) >> 1;
        int64_t tr = k - 1 > 0 ? k - 1 : 0, cr = k < ch - 1 ? k : ch - 1;
        if (y == 0) tr = cr = 0;
        if (y == h - 1 && h % 2 == 0) tr = cr;
        const bool is_top = (y % 2 == 1) || y == 0;
        for (int pl = 0; pl < 2; ++pl) {
            const uint8_t *T = (pl ? V : U) + tr * cs;
            const uint8_t *C = (pl ? V : U) + cr * cs;
            const uint8_t *nr = is_top ? T : C, *fr = is_top ? C : T;
            int *o = pl ? v.data() : u.data();
            o[0] = (3 * nr[0] + fr[0] + 2) >> 2;
            for (int64_t j = 0; j < n; ++j) {
                const int tl = T[j], t = T[j + 1], lft = C[j], cc = C[j + 1];
                const int avg = tl + t + lft + cc + 8;
                const int d12 = (avg + 2 * (t + lft)) >> 3;
                const int d03 = (avg + 2 * (tl + cc)) >> 3;
                o[2 * j + 1] = is_top ? (d12 + tl) >> 1 : (d03 + lft) >> 1;
                o[2 * j + 2] = is_top ? (d03 + t) >> 1 : (d12 + cc) >> 1;
            }
            if (w % 2 == 0)
                o[w - 1] = (3 * nr[cw - 1] + fr[cw - 1] + 2) >> 2;
        }
        const uint8_t *yr = Y + y * ys;
        uint8_t *px = out + y * w * 3;
        for (int64_t x = 0; x < w; ++x) {
            const int yy = (yr[x] * 19077) >> 8;
            px[3 * x] = clip8(yy + ((v[x] * 26149) >> 8) - 14234);
            px[3 * x + 1] =
                clip8(yy - ((u[x] * 6419) >> 8) - ((v[x] * 13320) >> 8) + 8708);
            px[3 * x + 2] = clip8(yy + ((u[x] * 33050) >> 8) - 17685);
        }
    }
}
