// JPEG 2000's sequential stages, as openjpeg 2.5 decodes for PIL
// (utils/j2k.py): tier 1 of many code-blocks (_t1: the MQ decoder and the
// significance, refinement and cleanup passes), the inverse 5/3 wavelet in
// integers (_idwt53), the inverse 9/7 in float32 (_idwt97), and the
// inverse RCT or ICT with the DC level shift, rounding and clamping
// (_finish). The `_plain` function beside each wrapper is its plain
// version, which the tests hold it to, failures included. utils/j2k.py
// checks every descriptor before a call, so every read lands inside the
// data and every write inside the output.
//
// The 9/7 and the ICT round each float32 operation on its own, as
// openjpeg's SSE code does: no multiply-add may be fused here.
#pragma GCC optimize("fp-contract=off")

#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// --- the MQ decoder (ISO 15444-1 C.3, openjpeg's mqc) ---------------------

const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12,
                          13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                          25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
                          37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18,
                          20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
                          22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                          34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
const int CTX_RL = 17, CTX_UNI = 18;

struct MQ {
    const uint8_t *data = nullptr;
    int64_t p = 0, end = 0;
    uint32_t a = 0, c = 0;
    int ct = 0;
    uint8_t state[19], mps[19];

    MQ() { reset(); }
    // every context to its initial state (RESET: after each MQ pass)
    void reset() {
        std::memset(state, 0, sizeof state);
        std::memset(mps, 0, sizeof mps);
        state[CTX_UNI] = 46;
        state[CTX_RL] = 3;
        state[0] = 4;
    }
    // the bytes past the segment's end read as 0xFF (openjpeg's marker)
    uint32_t byte(int64_t q) const { return q < end ? data[q] : 0xFF; }
    void bytein() {
        if (byte(p) == 0xFF) {
            if (byte(p + 1) > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                ++p;
                c += byte(p) << 9;
                ct = 7;
            }
        } else {
            ++p;
            c += byte(p) << 8;
            ct = 8;
        }
    }
    void init(const uint8_t *d, int64_t start, int64_t stop) {
        data = d;
        p = start;
        end = stop;
        c = (start == stop ? 0xFFu : uint32_t(d[start])) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    int decode(int cx) {
        const int s = state[cx];
        const uint32_t qe = QE[s];
        int d;
        a -= qe;
        if ((c >> 16) < qe) {
            if (a < qe) {
                d = mps[cx];
                state[cx] = NMPS[s];
            } else {
                d = 1 - mps[cx];
                if (SWITCH[s]) mps[cx] = uint8_t(d);
                state[cx] = NLPS[s];
            }
            a = qe;
        } else {
            c -= qe << 16;
            if (a & 0x8000) return mps[cx];
            if (a < qe) {
                d = 1 - mps[cx];
                if (SWITCH[s]) mps[cx] = uint8_t(d);
                state[cx] = NLPS[s];
            } else {
                d = mps[cx];
                state[cx] = NMPS[s];
            }
        }
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
        return d;
    }
};

// openjpeg's raw (bypass) bit reader: after 0xFF a byte gives seven bits,
// and a byte above 0x8F there is not taken; past the end it reads 0xFF.
struct Raw {
    const uint8_t *data = nullptr;
    int64_t p = 0, end = 0;
    uint32_t c = 0;
    int ct = 0;

    void init(const uint8_t *d, int64_t start, int64_t stop) {
        data = d;
        p = start;
        end = stop;
        c = 0;
        ct = 0;
    }
    uint32_t byte() const { return p < end ? data[p] : 0xFF; }
    int decode() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (byte() > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = byte();
                    ++p;
                    ct = 7;
                }
            } else {
                c = byte();
                ++p;
                ct = 8;
            }
        }
        --ct;
        return int((c >> ct) & 1);
    }
};

// --- tier 1 -----------------------------------------------------------------

// code-block styles
enum : int { LAZY = 1, RESET = 2, VSC = 8, SEGSYM = 32 };

// A sample's flags: its eight neighbours' significance, the signs of its
// four direct neighbours, and its own state.
enum : uint32_t {
    NW = 1u << 0, N = 1u << 1, NE = 1u << 2, W = 1u << 3, E = 1u << 4,
    SW = 1u << 5, S = 1u << 6, SE = 1u << 7, NEIGHBOURS = 0xFFu,
    NEG_N = 1u << 8, NEG_W = 1u << 9, NEG_E = 1u << 10, NEG_S = 1u << 11,
    SIG = 1u << 12, VISIT = 1u << 13, REFINED = 1u << 14
};

struct Luts {
    uint8_t zc[4][256];   // zero coding context by orientation
    uint8_t sc[256];      // sign context (low 5 bits) and its xor bit (<<7)
    Luts() {
        for (int o = 0; o < 4; ++o)
            for (int f = 0; f < 256; ++f) {
                int h = !!(f & W) + !!(f & E), v = !!(f & N) + !!(f & S);
                const int d = !!(f & NW) + !!(f & NE) + !!(f & SW) + !!(f & SE);
                int ctx;
                if (o == 3) {
                    const int hv = h + v;
                    ctx = d >= 3 ? 8 : d == 2 ? (hv >= 1 ? 7 : 6)
                        : d == 1 ? (hv >= 2 ? 5 : hv == 1 ? 4 : 3)
                                 : (hv >= 2 ? 2 : hv == 1 ? 1 : 0);
                } else {
                    if (o == 1) std::swap(h, v);
                    ctx = h == 2 ? 8 : h == 1 ? (v ? 7 : d ? 6 : 5)
                        : v == 2 ? 4 : v == 1 ? 3 : d >= 2 ? 2 : d;
                }
                zc[o][f] = uint8_t(ctx);
            }
        // index: significance of N, W, E, S (bits 0-3), their signs (4-7)
        for (int f = 0; f < 256; ++f) {
            auto contrib = [f](int k) {
                return (f >> k & 1) ? ((f >> (k + 4) & 1) ? -1 : 1) : 0;
            };
            int hc = contrib(1) + contrib(2), vc = contrib(0) + contrib(3);
            hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
            vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
            int x = 0;
            if (hc < 0 || (hc == 0 && vc < 0)) {
                hc = -hc;
                vc = -vc;
                x = 1;
            }
            const int ctx = 9 + (hc == 1 ? (vc == 1 ? 4 : vc == 0 ? 3 : 2)
                                         : (vc ? 1 : 0));
            sc[f] = uint8_t(ctx | (x << 7));
        }
    }
};
const Luts LUTS;

inline int sign_index(uint32_t f) {
    const int sig = int((f & N) >> 1) | int((f & W) >> 2) |
                    int((f & E) >> 2) | int((f & S) >> 3);
    return sig | int((f >> 4) & 0xF0);     // NEG_N..NEG_S: bits 8-11 -> 4-7
}

struct Block {
    int w, h, stride, style;
    bool raw = false;              // the current segment is a bypass one
    std::vector<uint32_t> flags;   // (h + 2) rows of w + 2, a border round
    int32_t *val;                  // w * h samples, row by row
    const uint8_t *zc;
    MQ mq;
    Raw rw;

    uint32_t &at(int x, int y) { return flags[(y + 1) * stride + x + 1]; }
    int bit(int cx) { return raw ? rw.decode() : mq.decode(cx); }

    void significant(int x, int y, int neg, int32_t one) {
        uint32_t *f = &at(x, y);
        *f |= SIG;
        // vertically causal: the stripe above never sees this stripe
        if (!((style & VSC) && y % 4 == 0)) {
            f[-stride - 1] |= SE;
            f[-stride] |= S | (neg ? NEG_S : 0u);
            f[-stride + 1] |= SW;
        }
        f[-1] |= E | (neg ? NEG_E : 0u);
        f[1] |= W | (neg ? NEG_W : 0u);
        f[stride - 1] |= NE;
        f[stride] |= N | (neg ? NEG_N : 0u);
        f[stride + 1] |= NW;
        const int32_t v = one | (one >> 1);
        val[y * w + x] = neg ? -v : v;
    }
    int sign(uint32_t f) {
        if (raw) return rw.decode();
        const int s = LUTS.sc[sign_index(f)];
        return mq.decode(s & 31) ^ (s >> 7);
    }
    void sigpass(int32_t one) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < y0 + 4 && y < h; ++y) {
                    uint32_t &f = at(x, y);
                    if ((f & SIG) || !(f & NEIGHBOURS)) continue;
                    f |= VISIT;
                    if (bit(zc[f & NEIGHBOURS]))
                        significant(x, y, sign(f), one);
                }
    }
    void refpass(int32_t one) {
        const int32_t half = one >> 1;
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x)
                for (int y = y0; y < y0 + 4 && y < h; ++y) {
                    uint32_t &f = at(x, y);
                    if ((f & (SIG | VISIT)) != SIG) continue;
                    const int ctx = (f & REFINED) ? 16
                                  : (f & NEIGHBOURS) ? 15 : 14;
                    const int b = bit(ctx);
                    int32_t &v = val[y * w + x];
                    v += (b ^ (v < 0)) ? half : -half;
                    f |= REFINED;
                }
    }
    void cleanup(int32_t one) {
        for (int y0 = 0; y0 < h; y0 += 4)
            for (int x = 0; x < w; ++x) {
                int y = y0;
                if (y0 + 4 <= h) {
                    bool run = true;
                    for (int k = 0; k < 4 && run; ++k)
                        run = !(at(x, y0 + k) & (SIG | VISIT | NEIGHBOURS));
                    if (run) {
                        if (!mq.decode(CTX_RL)) continue;
                        int r = mq.decode(CTX_UNI) << 1;
                        r |= mq.decode(CTX_UNI);
                        y = y0 + r;
                        significant(x, y, sign(at(x, y)), one);
                        ++y;
                    }
                }
                for (; y < y0 + 4 && y < h; ++y) {
                    const uint32_t f = at(x, y);
                    if (f & (SIG | VISIT)) continue;
                    if (mq.decode(zc[f & NEIGHBOURS]))
                        significant(x, y, sign(f), one);
                }
            }
        for (auto &f : flags) f &= ~VISIT;
        if (style & SEGSYM)
            for (int k = 0; k < 4; ++k) mq.decode(CTX_UNI);
    }
};

}  // namespace

// Tier 1 of `nblocks` code-blocks: row k of `blocks` (8 int64: width,
// height, orientation, bit planes, code-block style, first segment,
// segment count, output offset) decodes its segments (rows of `segs`:
// start, end in `data`, passes) into out[offset, offset + w * h) in
// openjpeg's scaled form: a bypass segment (LAZY, below the top four bit
// planes, significance and refinement) raw, the rest MQ-coded, the
// contexts reset after each MQ pass under RESET. Returns 0.
extern "C" int mnt_j2k_t1(const uint8_t *data, const int64_t *blocks,
                          int64_t nblocks, const int64_t *segs,
                          int32_t *out) {
    for (int64_t k = 0; k < nblocks; ++k) {
        const int64_t *b = blocks + 8 * k;
        Block blk;
        blk.w = int(b[0]);
        blk.h = int(b[1]);
        blk.stride = blk.w + 2;
        blk.style = int(b[4]);
        blk.flags.assign(size_t(blk.stride) * (blk.h + 2), 0);
        blk.val = out + b[7];
        std::memset(blk.val, 0, sizeof(int32_t) * blk.w * blk.h);
        blk.zc = LUTS.zc[b[2]];
        const int numbps = int(b[3]);
        int bpno = numbps, passtype = 2;
        for (int64_t s = b[5]; s < b[5] + b[6]; ++s) {
            const int64_t *sg = segs + 3 * s;
            blk.raw = (blk.style & LAZY) && bpno <= numbps - 4 &&
                      passtype < 2;
            if (blk.raw) blk.rw.init(data, sg[0], sg[1]);
            else blk.mq.init(data, sg[0], sg[1]);
            for (int64_t p = 0; p < sg[2] && bpno >= 1; ++p) {
                const int32_t one = int32_t(1) << bpno;
                if (passtype == 0) blk.sigpass(one);
                else if (passtype == 1) blk.refpass(one);
                else blk.cleanup(one);
                if ((blk.style & RESET) && !blk.raw) blk.mq.reset();
                if (++passtype == 3) {
                    passtype = 0;
                    --bpno;
                }
            }
        }
    }
    return 0;
}

namespace {

// --- the inverse wavelets ----------------------------------------------------

inline int32_t wrap32(int64_t v) { return int32_t(uint32_t(uint64_t(v))); }

// The inverse 5/3 of `g` interleaved lines of n samples each (the first
// sn low-pass), line j's sample i at buf[i * g + j]: openjpeg's
// opj_idwt53_h/v with the edges mirrored.
void lift53(int32_t *buf, int64_t n, int64_t sn, int cas, int64_t g,
            std::vector<int32_t> &tmp) {
    const int64_t dn = n - sn;
    if (n == 1) {
        if (cas)
            for (int64_t j = 0; j < g; ++j) buf[j] = buf[j] / 2;
        return;
    }
    tmp.resize(size_t(n * g));
    const int32_t *lo = buf, *hi = buf + sn * g;
    // low samples at even places (cas 0) or odd ones (cas 1)
    const int lo_at = cas, hi_at = 1 - cas;
    for (int64_t i = 0; i < sn; ++i) {
        const int64_t l = cas ? i : (i > 0 ? i - 1 : 0);
        const int64_t r = cas ? (i + 1 < dn ? i + 1 : dn - 1)
                              : (i < dn ? i : dn - 1);
        int32_t *o = &tmp[(2 * i + lo_at) * g];
        for (int64_t j = 0; j < g; ++j)
            o[j] = wrap32(int64_t(lo[i * g + j]) -
                          ((int64_t(hi[l * g + j]) + hi[r * g + j] + 2) >> 2));
    }
    for (int64_t i = 0; i < dn; ++i) {
        const int64_t l = cas ? (i > 0 ? i - 1 : 0) : i;
        const int64_t r = cas ? (i < sn ? i : sn - 1)
                              : (i + 1 < sn ? i + 1 : sn - 1);
        const int32_t *sl = &tmp[(2 * l + lo_at) * g];
        const int32_t *sr = &tmp[(2 * r + lo_at) * g];
        int32_t *o = &tmp[(2 * i + hi_at) * g];
        for (int64_t j = 0; j < g; ++j)
            o[j] = wrap32(int64_t(hi[i * g + j]) +
                          ((int64_t(sl[j]) + sr[j]) >> 1));
    }
    std::memcpy(buf, tmp.data(), sizeof(int32_t) * n * g);
}

const float ALPHA = -1.586134342f, BETA = -0.052980118f;
const float GAMMA = 0.882911075f, DELTA = 0.443506852f;
const float K = 1.230174105f, TWO_INVK = 1.625732422f;

// One 9/7 lifting step on the samples of parity `at`: x += (left + right)
// * c, the edges mirrored.
void step97(float *w, int64_t n, int at, float c, int64_t g) {
    for (int64_t i = at; i < n; i += 2) {
        const int64_t l = i > 0 ? i - 1 : 1, r = i + 1 < n ? i + 1 : n - 2;
        float *o = w + i * g;
        const float *a = w + l * g, *b = w + r * g;
        for (int64_t j = 0; j < g; ++j) o[j] = o[j] + (a[j] + b[j]) * c;
    }
}

// The inverse 9/7 of `g` interleaved lines (as lift53): openjpeg's
// opj_v8dwt_decode (scale, then the four lifting steps).
void lift97(float *buf, int64_t n, int64_t sn, int cas, int64_t g,
            std::vector<float> &tmp) {
    const int64_t dn = n - sn;
    tmp.resize(size_t(n * g));
    const int lo_at = cas, hi_at = 1 - cas;
    for (int64_t i = 0; i < sn; ++i)
        std::memcpy(&tmp[(2 * i + lo_at) * g], buf + i * g, sizeof(float) * g);
    for (int64_t i = 0; i < dn; ++i)
        std::memcpy(&tmp[(2 * i + hi_at) * g], buf + (sn + i) * g,
                    sizeof(float) * g);
    const bool quiet = cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1);
    if (!quiet) {
        float *w = tmp.data();
        for (int64_t i = lo_at; i < n; i += 2)
            for (int64_t j = 0; j < g; ++j) w[i * g + j] *= K;
        for (int64_t i = hi_at; i < n; i += 2)
            for (int64_t j = 0; j < g; ++j) w[i * g + j] *= TWO_INVK;
        step97(w, n, lo_at, -DELTA, g);
        step97(w, n, hi_at, -GAMMA, g);
        step97(w, n, lo_at, -BETA, g);
        step97(w, n, hi_at, -ALPHA, g);
    }
    std::memcpy(buf, tmp.data(), sizeof(float) * n * g);
}

// Level by level (geom: each resolution's x0, y0, x1, y1), the rows then
// the columns of the plane (row stride `stride`), each line through
// `lift`; columns in groups of `G`, gathered side by side.
template <typename T, typename F>
void idwt(T *a, int64_t stride, const int64_t *geom, int64_t nres, F lift) {
    const int64_t G = 16;
    std::vector<T> line, tmp;
    for (int64_t k = 1; k < nres; ++k) {
        const int64_t *r = geom + 4 * k, *p = geom + 4 * (k - 1);
        const int64_t rw = r[2] - r[0], rh = r[3] - r[1];
        const int64_t sw = p[2] - p[0], sh = p[3] - p[1];
        if (rw == 0 || rh == 0) continue;
        for (int64_t y = 0; y < rh; ++y)
            lift(a + y * stride, rw, sw, int(r[0] & 1), 1, tmp);
        line.resize(size_t(rh * G));
        for (int64_t x0 = 0; x0 < rw; x0 += G) {
            const int64_t g = rw - x0 < G ? rw - x0 : G;
            for (int64_t y = 0; y < rh; ++y)
                for (int64_t j = 0; j < g; ++j)
                    line[y * g + j] = a[y * stride + x0 + j];
            lift(line.data(), rh, sh, int(r[1] & 1), g, tmp);
            for (int64_t y = 0; y < rh; ++y)
                for (int64_t j = 0; j < g; ++j)
                    a[y * stride + x0 + j] = line[y * g + j];
        }
    }
}

}  // namespace

// The inverse 5/3 wavelet of a tile-component's int32 coefficients, in
// place (row stride `stride`; geom: nres rows of x0, y0, x1, y1).
extern "C" void mnt_j2k_idwt53(int32_t *a, int64_t stride,
                               const int64_t *geom, int64_t nres) {
    idwt(a, stride, geom, nres, lift53);
}

// The inverse 9/7 wavelet of float32 coefficients, in place.
extern "C" void mnt_j2k_idwt97(float *a, int64_t stride, const int64_t *geom,
                               int64_t nres) {
    idwt(a, stride, geom, nres, lift97);
}

// The inverse RCT (int32 planes, `reversible`) or ICT (float32) of the
// first three components, in place, n samples each.
extern "C" void mnt_j2k_mct(void *c0, void *c1, void *c2, int64_t n,
                            int reversible) {
    if (reversible) {
        int32_t *y = static_cast<int32_t *>(c0), *u = static_cast<int32_t *>(c1),
                *v = static_cast<int32_t *>(c2);
        for (int64_t i = 0; i < n; ++i) {
            const int32_t g = wrap32(int64_t(y[i]) -
                                     ((int64_t(u[i]) + v[i]) >> 2));
            const int32_t r = wrap32(int64_t(v[i]) + g);
            const int32_t b = wrap32(int64_t(u[i]) + g);
            y[i] = r;
            u[i] = g;
            v[i] = b;
        }
        return;
    }
    float *y = static_cast<float *>(c0), *u = static_cast<float *>(c1),
          *v = static_cast<float *>(c2);
    for (int64_t i = 0; i < n; ++i) {
        const float Y = y[i], U = u[i], V = v[i];
        const float r = Y + V * 1.402f;
        const float g = (Y - U * 0.34413f) - V * 0.71414f;
        const float b = Y + U * 1.772f;
        y[i] = r;
        u[i] = g;
        v[i] = b;
    }
}

// The DC level shift, rounding (half to even) and clamping of n samples
// (int32 where `reversible`, else float32) into out: openjpeg's
// opj_tcd_dc_level_shift_decode, its float path's edges kept (above 2^31
// the maximum; below -2^31, NaN and 2^31 itself the minimum).
extern "C" void mnt_j2k_level(const void *src, int64_t n, int reversible,
                              int64_t shift, int64_t lo, int64_t hi,
                              int32_t *out) {
    if (reversible) {
        const int32_t *s = static_cast<const int32_t *>(src);
        for (int64_t i = 0; i < n; ++i) {
            const int64_t v = wrap32(int64_t(s[i]) + shift);
            out[i] = int32_t(v < lo ? lo : v > hi ? hi : v);
        }
        return;
    }
    const float *s = static_cast<const float *>(src);
    for (int64_t i = 0; i < n; ++i) {
        const float x = s[i];
        if (x > 2147483648.0f) {
            out[i] = int32_t(hi);
        } else if (!(x >= -2147483648.0f) || x == 2147483648.0f) {
            out[i] = int32_t(lo);
        } else {
            const int64_t v = int64_t(std::nearbyint(double(x))) + shift;
            out[i] = int32_t(v < lo ? lo : v > hi ? hi : v);
        }
    }
}
