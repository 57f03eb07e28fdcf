// BCn block decoding (BC1-BC7) as PIL's `bcn` decoder does it.
//
// The native stage of utils/dds.py (_bcn); _bcn_plain beside it is its
// plain version, which the tests hold it to. BC1's three-colour mode and
// transparent index, BC2's 4-bit alpha, BC3-BC5's interpolated alpha (BC5S
// endpoints as int8 + 128, blue 128), BC6H's 14 modes (no rounding in the
// interpolation; a signed delta endpoint wrapped to the endpoint bits and
// taken as a 16-bit integer; half floats clamped to [0, 1], times 255 in
// float, truncated), BC7's 8 modes (a block with no mode is opaque black).
// Every read lands inside `src` (`len` bytes) and every write inside `out`
// (h x w x 4).

#include <cstdint>
#include <cstring>

namespace {

const uint16_t P2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};
const uint32_t P3[64] = {
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050,
    0x5555A0A0, 0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090,
    0x94949494, 0xA4A4A4A4, 0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054,
    0xA5A5A500, 0x55A0A0A0, 0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500,
    0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414,
    0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050, 0x24242424,
    0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600,
    0xAA444444, 0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580,
    0xAA141414, 0x96960000, 0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000,
    0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254};
const uint8_t ANCHOR2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t ANCHOR3A[64] = {
    3, 3,  15, 15, 8, 3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3, 3,  8,  15, 3, 3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8, 15, 3,  5,  6, 10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3, 15, 5,  5,  5, 8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t ANCHOR3B[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const int W2[4] = {0, 21, 43, 64};
const int W3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int W4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int *weights(int bits) { return bits == 2 ? W2 : bits == 3 ? W3 : W4; }

// an LSB-first reader of one 16-byte block
struct Bits {
    const uint8_t *b;
    int pos = 0;
    explicit Bits(const uint8_t *blk) : b(blk) {}
    uint32_t take(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i, ++pos)
            if (pos < 128) v |= uint32_t((b[pos >> 3] >> (pos & 7)) & 1) << i;
        return v;
    }
};

void subsets(int ns, int part, int *subset, int *anchors) {
    anchors[0] = 0;
    anchors[1] = anchors[2] = -1;
    for (int i = 0; i < 16; ++i)
        subset[i] = ns == 1 ? 0 : ns == 2 ? (P2[part] >> i) & 1
                                          : (P3[part] >> (2 * i)) & 3;
    if (ns == 2) anchors[1] = ANCHOR2[part];
    if (ns == 3) {
        anchors[1] = ANCHOR3A[part];
        anchors[2] = ANCHOR3B[part];
    }
}

bool is_anchor(int i, const int *anchors) {
    return i == anchors[0] || i == anchors[1] || i == anchors[2];
}

// --- BC1-BC5 ---------------------------------------------------------------

// `blp`: PIL's BLP plugin expands 5 and 6 bits without replicating them
void rgb565(uint32_t c, int *p, bool blp) {
    const int r = (c >> 11) & 31, g = (c >> 5) & 63, b = c & 31;
    p[0] = blp ? r << 3 : (r << 3) | (r >> 2);
    p[1] = blp ? g << 2 : (g << 2) | (g >> 4);
    p[2] = blp ? b << 3 : (b << 3) | (b >> 2);
}

void bc1_colour(const uint8_t *s, bool four, uint8_t (*px)[4], bool blp = false) {
    const uint32_t c0 = s[0] | (s[1] << 8), c1 = s[2] | (s[3] << 8);
    int p[4][4];
    rgb565(c0, p[0], blp);
    rgb565(c1, p[1], blp);
    const bool is4 = four || c0 > c1;
    for (int c = 0; c < 3; ++c) {
        p[2][c] = is4 ? (2 * p[0][c] + p[1][c]) / 3 : (p[0][c] + p[1][c]) / 2;
        p[3][c] = is4 ? (p[0][c] + 2 * p[1][c]) / 3 : 0;
    }
    p[0][3] = p[1][3] = p[2][3] = 255;
    p[3][3] = is4 ? 255 : 0;
    const uint32_t lut = s[4] | (s[5] << 8) | (s[6] << 16) | (uint32_t(s[7]) << 24);
    for (int i = 0; i < 16; ++i)
        for (int c = 0; c < 4; ++c) px[i][c] = uint8_t(p[(lut >> (2 * i)) & 3][c]);
}

void bc3_alpha(const uint8_t *s, bool sign, uint8_t (*px)[4], int ch) {
    int a0 = s[0], a1 = s[1];
    if (sign) {
        a0 = (int8_t(s[0]) + 128) & 0xFFFF;
        a1 = (int8_t(s[1]) + 128) & 0xFFFF;
    }
    int a[8] = {a0, a1};
    if (a0 > a1) {
        for (int k = 1; k < 7; ++k) a[k + 1] = ((7 - k) * a0 + k * a1) / 7;
    } else {
        for (int k = 1; k < 5; ++k) a[k + 1] = ((5 - k) * a0 + k * a1) / 5;
        a[6] = 0;
        a[7] = 255;
    }
    const uint32_t lo = s[2] | (s[3] << 8) | (s[4] << 16);
    const uint32_t hi = s[5] | (s[6] << 8) | (s[7] << 16);
    for (int i = 0; i < 16; ++i) {
        const uint32_t idx = i < 8 ? (lo >> (3 * i)) & 7 : (hi >> (3 * (i - 8))) & 7;
        px[i][ch] = uint8_t(a[idx] & 0xFF);
    }
}

// --- BC7 -------------------------------------------------------------------

// subsets, partition bits, rotation bits, index-selection bits, colour
// bits, alpha bits, endpoint p-bits, shared p-bits, index bits, second
// index bits
const int BC7[8][10] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

void bc7_block(const uint8_t *s, uint8_t (*px)[4]) {
    Bits bits(s);
    int mode = 0;
    while (mode < 8 && !bits.take(1)) ++mode;
    if (mode == 8) {
        for (int i = 0; i < 16; ++i) px[i][0] = px[i][1] = px[i][2] = 0, px[i][3] = 255;
        return;
    }
    const int *m = BC7[mode];
    const int ns = m[0], cb = m[4], ab = m[5], ib = m[8], ib2 = m[9];
    const int part = bits.take(m[1]), rot = bits.take(m[2]), sel = bits.take(m[3]);
    int e[6][4];
    for (int k = 0; k < 2 * ns; ++k) e[k][3] = 255;
    for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 2 * ns; ++k) e[k][c] = bits.take(cb);
    if (ab)
        for (int k = 0; k < 2 * ns; ++k) e[k][3] = bits.take(ab);
    int cbits = cb, abits = ab;
    if (m[6] || m[7]) {
        int p[6];
        const int np = m[6] ? 2 * ns : ns;
        for (int k = 0; k < np; ++k) p[k] = bits.take(1);
        for (int k = 0; k < 2 * ns; ++k)
            for (int c = 0; c < (ab ? 4 : 3); ++c)
                e[k][c] = (e[k][c] << 1) | p[m[6] ? k : k / 2];
        cbits = cb + 1;
        abits = ab ? ab + 1 : 0;
    }
    for (int k = 0; k < 2 * ns; ++k)
        for (int c = 0; c < 4; ++c) {
            if (c == 3 && !ab) continue;
            const int nb = c < 3 ? cbits : abits;
            const int v = e[k][c] << (8 - nb);
            e[k][c] = v | (v >> nb);
        }
    int subset[16], anchors[3];
    subsets(ns, part, subset, anchors);
    int idx[16], idx2[16];
    for (int i = 0; i < 16; ++i) idx[i] = bits.take(ib - is_anchor(i, anchors));
    if (ib2)
        for (int i = 0; i < 16; ++i) idx2[i] = bits.take(ib2 - (i == 0));
    for (int i = 0; i < 16; ++i) {
        const int *e0 = e[2 * subset[i]], *e1 = e[2 * subset[i] + 1];
        int wc, wa;
        if (!ib2) {
            wc = wa = weights(ib)[idx[i]];
        } else if (sel) {
            wc = weights(ib2)[idx2[i]];
            wa = weights(ib)[idx[i]];
        } else {
            wc = weights(ib)[idx[i]];
            wa = weights(ib2)[idx2[i]];
        }
        int v[4];
        for (int c = 0; c < 4; ++c) {
            const int w = c < 3 ? wc : wa;
            v[c] = ((64 - w) * e0[c] + w * e1[c] + 32) >> 6;
        }
        if (rot) {
            const int t = v[rot - 1];
            v[rot - 1] = v[3];
            v[3] = t;
        }
        for (int c = 0; c < 4; ++c) px[i][c] = uint8_t(v[c]);
    }
}

// --- BC6H ------------------------------------------------------------------

// each mode: its code, transformed, endpoint bits, delta bits (r, g, b),
// two subsets, and its endpoint bits in stream order as runs (field, from
// bit, to bit): fields r0-r3 0-3, g0-g3 4-7, b0-b3 8-11; a run reads bit
// `from` first and steps towards `to`
struct Run { int8_t f, from, to; };
struct Mode6 {
    int code, transformed, eb, db[3], two, nruns;
    Run runs[24];
};
enum { R0, R1, R2, R3, G0, G1, G2, G3, B0, B1, B2, B3 };
#define B(f, a) {f, a, a}
#define S(f, hi, lo) {f, lo, hi}
const Mode6 MODES6[14] = {
    {0x00, 1, 10, {5, 5, 5}, 1, 19, {B(G2, 4), B(B2, 4), B(B3, 4), S(R0, 9, 0), S(G0, 9, 0), S(B0, 9, 0), S(R1, 4, 0), B(G3, 4), S(G2, 3, 0), S(G1, 4, 0), B(B3, 0), S(G3, 3, 0), S(B1, 4, 0), B(B3, 1), S(B2, 3, 0), S(R2, 4, 0), B(B3, 2), S(R3, 4, 0), B(B3, 3)}},
    {0x01, 1, 7, {6, 6, 6}, 1, 23, {B(G2, 5), B(G3, 4), B(G3, 5), S(R0, 6, 0), B(B3, 0), B(B3, 1), B(B2, 4), S(G0, 6, 0), B(B2, 5), B(B3, 2), B(G2, 4), S(B0, 6, 0), B(B3, 3), B(B3, 5), B(B3, 4), S(R1, 5, 0), S(G2, 3, 0), S(G1, 5, 0), S(G3, 3, 0), S(B1, 5, 0), S(B2, 3, 0), S(R2, 5, 0), S(R3, 5, 0)}},
    {0x02, 1, 11, {5, 4, 4}, 1, 18, {S(R0, 9, 0), S(G0, 9, 0), S(B0, 9, 0), S(R1, 4, 0), B(R0, 10), S(G2, 3, 0), S(G1, 3, 0), B(G0, 10), B(B3, 0), S(G3, 3, 0), S(B1, 3, 0), B(B0, 10), B(B3, 1), S(B2, 3, 0), S(R2, 4, 0), B(B3, 2), S(R3, 4, 0), B(B3, 3)}},
    {0x06, 1, 11, {4, 5, 4}, 1, 20, {S(R0, 9, 0), S(G0, 9, 0), S(B0, 9, 0), S(R1, 3, 0), B(R0, 10), B(G3, 4), S(G2, 3, 0), S(G1, 4, 0), B(G0, 10), S(G3, 3, 0), S(B1, 3, 0), B(B0, 10), B(B3, 1), S(B2, 3, 0), S(R2, 3, 0), B(B3, 0), B(B3, 2), S(R3, 3, 0), B(G2, 4), B(B3, 3)}},
    {0x0A, 1, 11, {4, 4, 5}, 1, 20, {S(R0, 9, 0), S(G0, 9, 0), S(B0, 9, 0), S(R1, 3, 0), B(R0, 10), B(B2, 4), S(G2, 3, 0), S(G1, 3, 0), B(G0, 10), B(B3, 0), S(G3, 3, 0), S(B1, 4, 0), B(B0, 10), S(B2, 3, 0), S(R2, 3, 0), B(B3, 1), B(B3, 2), S(R3, 3, 0), B(B3, 4), B(B3, 3)}},
    {0x0E, 1, 9, {5, 5, 5}, 1, 19, {S(R0, 8, 0), B(B2, 4), S(G0, 8, 0), B(G2, 4), S(B0, 8, 0), B(B3, 4), S(R1, 4, 0), B(G3, 4), S(G2, 3, 0), S(G1, 4, 0), B(B3, 0), S(G3, 3, 0), S(B1, 4, 0), B(B3, 1), S(B2, 3, 0), S(R2, 4, 0), B(B3, 2), S(R3, 4, 0), B(B3, 3)}},
    {0x12, 1, 8, {6, 5, 5}, 1, 19, {S(R0, 7, 0), B(G3, 4), B(B2, 4), S(G0, 7, 0), B(B3, 2), B(G2, 4), S(B0, 7, 0), B(B3, 3), B(B3, 4), S(R1, 5, 0), S(G2, 3, 0), S(G1, 4, 0), B(B3, 0), S(G3, 3, 0), S(B1, 4, 0), B(B3, 1), S(B2, 3, 0), S(R2, 5, 0), S(R3, 5, 0)}},
    {0x16, 1, 8, {5, 6, 5}, 1, 21, {S(R0, 7, 0), B(B3, 0), B(B2, 4), S(G0, 7, 0), B(G2, 5), B(G2, 4), S(B0, 7, 0), B(G3, 5), B(B3, 4), S(R1, 4, 0), B(G3, 4), S(G2, 3, 0), S(G1, 5, 0), S(G3, 3, 0), S(B1, 4, 0), B(B3, 1), S(B2, 3, 0), S(R2, 4, 0), B(B3, 2), S(R3, 4, 0), B(B3, 3)}},
    {0x1A, 1, 8, {5, 5, 6}, 1, 21, {S(R0, 7, 0), B(B3, 1), B(B2, 4), S(G0, 7, 0), B(B2, 5), B(G2, 4), S(B0, 7, 0), B(B3, 5), B(B3, 4), S(R1, 4, 0), B(G3, 4), S(G2, 3, 0), S(G1, 4, 0), B(B3, 0), S(G3, 3, 0), S(B1, 5, 0), S(B2, 3, 0), S(R2, 4, 0), B(B3, 2), S(R3, 4, 0), B(B3, 3)}},
    {0x1E, 0, 6, {6, 6, 6}, 1, 23, {S(R0, 5, 0), B(G3, 4), B(B3, 0), B(B3, 1), B(B2, 4), S(G0, 5, 0), B(G2, 5), B(B2, 5), B(B3, 2), B(G2, 4), S(B0, 5, 0), B(G3, 5), B(B3, 3), B(B3, 5), B(B3, 4), S(R1, 5, 0), S(G2, 3, 0), S(G1, 5, 0), S(G3, 3, 0), S(B1, 5, 0), S(B2, 3, 0), S(R2, 5, 0), S(R3, 5, 0)}},
    {0x03, 0, 10, {10, 10, 10}, 0, 6, {S(R0, 9, 0), S(G0, 9, 0), S(B0, 9, 0), S(R1, 9, 0), S(G1, 9, 0), S(B1, 9, 0)}},
    {0x07, 1, 11, {9, 9, 9}, 0, 9, {S(R0, 9, 0), S(G0, 9, 0), S(B0, 9, 0), S(R1, 8, 0), B(R0, 10), S(G1, 8, 0), B(G0, 10), S(B1, 8, 0), B(B0, 10)}},
    {0x0B, 1, 12, {8, 8, 8}, 0, 9, {S(R0, 9, 0), S(G0, 9, 0), S(B0, 9, 0), S(R1, 7, 0), {R0, 11, 10}, S(G1, 7, 0), {G0, 11, 10}, S(B1, 7, 0), {B0, 11, 10}}},
    {0x0F, 1, 16, {4, 4, 4}, 0, 9, {S(R0, 9, 0), S(G0, 9, 0), S(B0, 9, 0), S(R1, 3, 0), {R0, 15, 10}, S(G1, 3, 0), {G0, 15, 10}, S(B1, 3, 0), {B0, 15, 10}}},
};
#undef B
#undef S

int sext(int v, int bits) { return (v & (1 << (bits - 1))) ? v - (1 << bits) : v; }

int unquantize(int v, int bits, bool sign) {
    if (!sign) {
        if (bits >= 15 || v == 0) return v;
        if (v == (1 << bits) - 1) return 0xFFFF;
        return ((v << 16) + 0x8000) >> bits;
    }
    if (bits >= 16) return v;
    const bool s = v < 0;
    if (s) v = -v;
    int u;
    if (v == 0)
        u = 0;
    else if (v >= (1 << (bits - 1)) - 1)
        u = 0x7FFF;
    else
        u = ((v << 15) + 0x4000) >> (bits - 1);
    return s ? -u : u;
}

float half_to_float(uint32_t h) {
    const uint32_t s = (h >> 15) & 1, e = (h >> 10) & 31, m = h & 1023;
    float f;
    if (e == 0)
        f = float(m) * (1.0f / 16777216.0f);           // m * 2^-24
    else if (e == 31)
        f = m ? __builtin_nanf("") : __builtin_inff();
    else {
        uint32_t bits = ((e + 112) << 23) | (m << 13);
        std::memcpy(&f, &bits, 4);
    }
    return s ? -f : f;
}

uint8_t half_to_8(uint32_t h) {
    const float f = half_to_float(h);
    if (!(f >= 0.0f)) return 0;
    if (f > 1.0f) return 255;
    return uint8_t(f * 255.0f);
}

void bc6h_block(const uint8_t *s, bool sign, uint8_t (*px)[4]) {
    Bits bits(s);
    int code = bits.take(2);
    if (code > 1) code |= bits.take(3) << 2;
    const Mode6 *m = nullptr;
    for (const Mode6 &mm : MODES6)
        if (mm.code == code) m = &mm;
    if (!m) {
        for (int i = 0; i < 16; ++i) px[i][0] = px[i][1] = px[i][2] = 0, px[i][3] = 255;
        return;
    }
    int f[12] = {0};
    for (int r = 0; r < m->nruns; ++r) {
        const Run &run = m->runs[r];
        const int step = run.to >= run.from ? 1 : -1;
        for (int b = run.from;; b += step) {
            f[run.f] |= int(bits.take(1)) << b;
            if (b == run.to) break;
        }
    }
    const int part = m->two ? bits.take(5) : 0;
    const int ne = m->two ? 4 : 2, eb = m->eb, mask = (1 << eb) - 1;
    int e[4][3];
    for (int k = 0; k < ne; ++k)
        for (int c = 0; c < 3; ++c) e[k][c] = f[c * 4 + k];
    for (int c = 0; c < 3; ++c) {
        if (sign) e[0][c] = sext(e[0][c], eb);
        for (int k = 1; k < ne; ++k) {
            if (m->transformed) {
                const int v = (e[0][c] + sext(e[k][c], m->db[c])) & mask;
                e[k][c] = sign ? int(int16_t(uint16_t(v))) : v;
            } else if (sign) {
                e[k][c] = sext(e[k][c], eb);
            }
        }
    }
    for (int k = 0; k < ne; ++k)
        for (int c = 0; c < 3; ++c) e[k][c] = unquantize(e[k][c], eb, sign);
    int subset[16], anchors[3];
    subsets(m->two ? 2 : 1, part, subset, anchors);
    const int ib = m->two ? 3 : 4;
    for (int i = 0; i < 16; ++i) {
        const int w = weights(ib)[bits.take(ib - is_anchor(i, anchors))];
        const int *e0 = e[2 * subset[i]], *e1 = e[2 * subset[i] + 1];
        for (int c = 0; c < 3; ++c) {
            const int v = ((64 - w) * e0[c] + w * e1[c]) >> 6;
            uint32_t h;
            if (sign)
                h = v < 0 ? 0x8000u | uint32_t((-v * 31) >> 5) : uint32_t((v * 31) >> 5);
            else
                h = uint32_t((v * 31) >> 6);
            px[i][c] = half_to_8(h & 0xFFFF);
        }
        px[i][3] = 255;
    }
}

}  // namespace

// The (h, w, 4) RGBA samples of the BCn (`n` 1-7) blocks in src[0, len)
// into out; `flags` bit 0: BC5S or BC6H SF16, bit 1: BC1-BC3 colours as
// PIL's BLP plugin expands them. Returns 0, or -1 where src holds fewer
// than the image's blocks (the caller raises as for a truncated file) or
// `n` is not a BCn number.
extern "C" int mnt_bcn_decode(const uint8_t *src, int64_t len, int64_t w,
                              int64_t h, int n, int flags, uint8_t *out) {
    const bool sign = flags & 1, blp = flags & 2;
    if (n < 1 || n > 7 || w < 0 || h < 0) return -1;
    const int size = (n == 1 || n == 4) ? 8 : 16;
    const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
    if (len < bw * bh * size) return -1;
    uint8_t px[16][4];
    for (int64_t by = 0; by < bh; ++by)
        for (int64_t bx = 0; bx < bw; ++bx) {
            const uint8_t *s = src + (by * bw + bx) * size;
            std::memset(px, 0, sizeof px);
            switch (n) {
            case 1: bc1_colour(s, false, px, blp); break;
            case 2:
                bc1_colour(s + 8, true, px, blp);
                for (int i = 0; i < 16; ++i)
                    px[i][3] = uint8_t(((s[i >> 1] >> (4 * (i & 1))) & 15) * 17);
                break;
            case 3:
                bc1_colour(s + 8, true, px, blp);
                bc3_alpha(s, false, px, 3);
                break;
            case 4:
                bc3_alpha(s, false, px, 0);
                for (int i = 0; i < 16; ++i) px[i][3] = 255;
                break;
            case 5:
                bc3_alpha(s, sign, px, 0);
                bc3_alpha(s + 8, sign, px, 1);
                for (int i = 0; i < 16; ++i) px[i][2] = sign ? 128 : 0, px[i][3] = 255;
                break;
            case 6: bc6h_block(s, sign, px); break;
            default: bc7_block(s, px); break;
            }
            for (int i = 0; i < 16; ++i) {
                const int64_t y = by * 4 + i / 4, x = bx * 4 + i % 4;
                if (y < h && x < w) std::memcpy(out + (y * w + x) * 4, px[i], 4);
            }
        }
    return 0;
}
