// A Zstandard frame decoder (RFC 8878) for TIFF's compression 50000
// (utils/zstd.py, decompress). zstd.decompress_plain is its plain version,
// which the tests hold it to, failures included. Every read lands inside
// `src` (`len` bytes) and every write inside `out` (`cap` bytes).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Corrupt {};
struct Full {};
struct NeedsDictionary {};
struct WindowTooLarge {};

inline void need(bool ok) {
    if (!ok) throw Corrupt();
}

constexpr int64_t kBlockMax = 128 * 1024;
constexpr int kWindowLogMax = 27;

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,    1,    2,     3,     4,     5,     6,    7,    8,
                              9,    10,   11,    12,    13,    14,    15,   16,   18,
                              20,   22,   24,    28,    32,    40,    48,   64,   128,
                              256,  512,  1024,  2048,  4096,  8192,  16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,   4,   5,    6,    7,    8,    9,    10,    11,    12,   13,
                              14,  15,  16,   17,   18,   19,   20,   21,    22,    23,   24,
                              25,  26,  27,   28,   29,   30,   31,   32,    33,    34,   35,
                              37,  39,  41,   43,   47,   51,   59,   67,    83,    99,   131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

inline int bit_length(uint64_t v) {
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

uint64_t le(const uint8_t *p, int n) {
    uint64_t v = 0;
    for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
    return v;
}

// XXH64 (seed 0)
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t *p, int64_t n) {
    int64_t pos = 0;
    uint64_t h;
    if (n >= 32) {
        uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
        for (; pos + 32 <= n; pos += 32)
            for (int i = 0; i < 4; ++i) v[i] = xround(v[i], le(p + pos + 8 * i, 8));
        h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
        for (int i = 0; i < 4; ++i) h = (h ^ xround(0, v[i])) * P1 + P4;
    } else {
        h = P5;
    }
    h += uint64_t(n);
    for (; pos + 8 <= n; pos += 8) h = rotl(h ^ xround(0, le(p + pos, 8)), 27) * P1 + P4;
    if (pos + 4 <= n) {
        h = rotl(h ^ (le(p + pos, 4) * P1), 23) * P2 + P3;
        pos += 4;
    }
    for (; pos < n; ++pos) h = rotl(h ^ (p[pos] * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// bits of data[start, end) read LSB first; bits past `end` read as zeros
struct Forward {
    const uint8_t *data;
    int64_t end, bit;
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i, ++bit) {
            const int64_t byte = bit >> 3;
            if (byte < end && (data[byte] >> (bit & 7) & 1)) v |= 1u << i;
        }
        return v;
    }
    int64_t close() const {
        const int64_t pos = (bit + 7) >> 3;
        need(pos <= end);
        return pos;
    }
};

// a backward bit stream data[start, end): from its last set bit toward
// its first byte, MSB first; bits before the start read as zeros
struct Backward {
    const uint8_t *p;
    int64_t size, pos;
    Backward(const uint8_t *data, int64_t start, int64_t end) {
        need(end > start && data[end - 1] != 0);
        p = data + start;
        size = end - start;
        pos = size * 8 - 8 + bit_length(data[end - 1]) - 1;
    }
    uint32_t peek(int n) const {
        if (n == 0) return 0;
        const int64_t lo = pos - n;
        if (lo >= 0) {
            const int64_t b0 = lo >> 3;
            uint64_t v;
            if (b0 + 8 <= size) {
                std::memcpy(&v, p + b0, 8);  // little-endian hosts
            } else {
                v = le(p + b0, int(size - b0));
            }
            return uint32_t((v >> (lo & 7)) & ((1ull << n) - 1));
        }
        if (pos <= 0) return 0;
        const uint64_t v = le(p, int(((pos - 1) >> 3) + 1));
        return uint32_t((v & ((1ull << pos) - 1)) << -lo);
    }
    uint32_t read(int n) {
        const uint32_t v = peek(n);
        pos -= n;
        return v;
    }
};

struct Fse {
    std::vector<uint8_t> sym, nb;
    std::vector<uint16_t> base;
    int log = 0;
    bool valid = false;
};

struct Huf {
    std::vector<uint8_t> sym, nb;
    int max_bits = 0;
    bool valid = false;
};

// an FSE table description at data[pos, end): normalised counts and
// accuracy log; returns the position after it
int64_t fse_header(const uint8_t *data, int64_t pos, int64_t end, int max_sym, int max_log,
                   std::vector<int> &probs, int &log) {
    Forward rd{data, end, pos * 8};
    log = int(rd.read(4)) + 5;
    need(log <= max_log);
    int remaining = (1 << log) + 1, threshold = 1 << log, bits = log + 1;
    probs.clear();
    while (remaining > 1) {
        need(int(probs.size()) <= max_sym);
        const int low = int(rd.read(bits - 1));
        const int top = 2 * threshold - 1 - remaining;
        int count;
        if (low < top) {
            count = low;
        } else {
            count = low | int(rd.read(1)) << (bits - 1);
            if (count >= threshold) count -= top;
        }
        --count;
        remaining -= count < 0 ? -count : count;
        probs.push_back(count);
        if (count == 0) {
            for (;;) {
                const int rep = int(rd.read(2));
                for (int i = 0; i < rep; ++i) probs.push_back(0);
                if (rep != 3) break;
                need(int(probs.size()) <= max_sym + 1);
            }
            need(int(probs.size()) <= max_sym + 1);
        }
        while (remaining < threshold && threshold > 1) {
            --bits;
            threshold >>= 1;
        }
    }
    need(remaining == 1 && int(probs.size()) <= max_sym + 1);
    return rd.close();
}

void fse_table(const int *probs, int n, int log, Fse &t) {
    const int size = 1 << log;
    int total = 0;
    for (int s = 0; s < n; ++s) total += probs[s] < 0 ? -probs[s] : probs[s];
    need(total == size);
    t.sym.assign(size, 0);
    t.nb.assign(size, 0);
    t.base.assign(size, 0);
    t.log = log;
    std::vector<int> nxt(n);
    int high = size - 1;
    for (int s = 0; s < n; ++s) {
        if (probs[s] == -1) {
            t.sym[high--] = uint8_t(s);
            nxt[s] = 1;
        } else {
            nxt[s] = probs[s];
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3;
    int pos = 0;
    for (int s = 0; s < n; ++s)
        for (int i = 0; i < probs[s]; ++i) {
            t.sym[pos] = uint8_t(s);
            pos = (pos + step) & (size - 1);
            while (pos > high) pos = (pos + step) & (size - 1);
        }
    need(pos == 0);
    for (int u = 0; u < size; ++u) {
        const int s = t.sym[u];
        const int x = nxt[s]++;
        const int nb = log - (bit_length(uint64_t(x)) - 1);
        t.nb[u] = uint8_t(nb);
        t.base[u] = uint16_t((x << nb) - size);
    }
    t.valid = true;
}

// a Huffman tree description at data[pos, end); returns the position
// after it
int64_t huffman_table(const uint8_t *data, int64_t pos, int64_t end, Huf &huf) {
    need(pos < end);
    const int head = data[pos++];
    std::vector<int> weights;
    if (head >= 128) {
        const int n = head - 127;
        need(pos + (n + 1) / 2 <= end);
        for (int i = 0; i < n; ++i) weights.push_back(data[pos + i / 2] >> (4 * (1 - i % 2)) & 15);
        pos += (n + 1) / 2;
    } else {
        need(head > 0 && pos + head <= end);
        std::vector<int> probs;
        int log;
        const int64_t hdr_end = fse_header(data, pos, pos + head, 255, 6, probs, log);
        Fse t;
        fse_table(probs.data(), int(probs.size()), log, t);
        Backward rd(data, hdr_end, pos + head);
        int st[2];
        st[0] = int(rd.read(log));
        st[1] = int(rd.read(log));
        for (int k = 0;; k = 1 - k) {
            need(weights.size() < 254);
            weights.push_back(t.sym[st[k]]);
            st[k] = t.base[st[k]] + int(rd.read(t.nb[st[k]]));
            if (rd.pos < 0) {
                weights.push_back(t.sym[st[1 - k]]);
                break;
            }
        }
        pos += head;
    }
    int64_t total = 0;
    for (int w : weights) {
        need(w <= 11);
        if (w) total += int64_t(1) << (w - 1);
    }
    need(total > 0);
    const int max_bits = bit_length(uint64_t(total));
    need(max_bits <= 11);
    const int64_t rest = (int64_t(1) << max_bits) - total;
    need((rest & (rest - 1)) == 0);
    weights.push_back(bit_length(uint64_t(rest)));
    int ones = 0;
    for (int w : weights) ones += w == 1;
    need(weights.size() <= 256 && ones >= 2 && ones % 2 == 0);
    huf.sym.assign(size_t(1) << max_bits, 0);
    huf.nb.assign(size_t(1) << max_bits, 0);
    size_t at = 0;
    for (int w = 1; w <= max_bits; ++w)
        for (size_t s = 0; s < weights.size(); ++s)
            if (weights[s] == w)
                for (size_t i = 0; i < (size_t(1) << (w - 1)); ++i) {
                    huf.sym[at] = uint8_t(s);
                    huf.nb[at++] = uint8_t(max_bits + 1 - w);
                }
    huf.max_bits = max_bits;
    huf.valid = true;
    return pos;
}

void huffman_stream(const uint8_t *data, int64_t start, int64_t end, int64_t n, const Huf &huf,
                    uint8_t *out) {
    Backward rd(data, start, end);
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t v = rd.peek(huf.max_bits);
        out[i] = huf.sym[v];
        rd.pos -= huf.nb[v];
    }
    need(rd.pos == 0);
}

struct FrameState {
    Huf huf;
    Fse ll, of, ml;
    int64_t rep[3] = {1, 4, 8};
};

// the literals section at data[pos, end) into lits; returns the position
// after it
int64_t literals(const uint8_t *data, int64_t pos, int64_t end, FrameState &st,
                 std::vector<uint8_t> &lits) {
    need(pos < end);
    const int b0 = data[pos], kind = b0 & 3, fmt = b0 >> 2 & 3;
    if (kind < 2) {
        const int head = fmt == 1 ? 2 : fmt == 3 ? 3 : 1;
        need(pos + head <= end);
        const uint64_t v = le(data + pos, head);
        const int64_t size = int64_t(head == 1 ? v >> 3 : v >> 4);
        need(size <= kBlockMax);
        pos += head;
        if (kind == 0) {
            need(pos + size <= end);
            lits.assign(data + pos, data + pos + size);
            return pos + size;
        }
        need(pos < end);
        lits.assign(size_t(size), data[pos]);
        return pos + 1;
    }
    const int head = fmt < 2 ? 3 : fmt + 2;
    need(pos + head <= end);
    const uint64_t v = le(data + pos, head);
    const int bits = head == 3 ? 10 : head == 4 ? 14 : 18;
    const int64_t size = int64_t(v >> 4 & ((1ull << bits) - 1));
    const int64_t csize = int64_t(v >> (4 + bits) & ((1ull << bits) - 1));
    need(size <= kBlockMax);
    pos += head;
    const int64_t stop = pos + csize;
    need(stop <= end);
    if (kind == 2)
        pos = huffman_table(data, pos, stop, st.huf);
    else
        need(st.huf.valid);
    lits.resize(size_t(size));
    if (fmt == 0) {
        huffman_stream(data, pos, stop, size, st.huf, lits.data());
    } else {
        // libzstd: a jump table and a byte a stream, six literals
        need(stop - pos >= 10 && size >= 6);
        int64_t sizes[4], sum = 0;
        for (int i = 0; i < 3; ++i) sum += sizes[i] = int64_t(le(data + pos + 2 * i, 2));
        pos += 6;
        sizes[3] = stop - pos - sum;
        need(sizes[3] >= 0);
        const int64_t seg = (size + 3) / 4;
        need(size >= 3 * seg);
        for (int i = 0; i < 4; ++i) {
            huffman_stream(data, pos, pos + sizes[i], i < 3 ? seg : size - 3 * seg, st.huf,
                           lits.data() + i * seg);
            pos += sizes[i];
        }
    }
    return stop;
}

// a sequence symbol table of `mode` (0 predefined, 1 RLE, 2 FSE, 3
// repeat) into t; returns the position after it
int64_t seq_table(int mode, const uint8_t *data, int64_t pos, int64_t end, int max_sym,
                  int max_log, const int16_t *dflt, int n_dflt, int dflt_log, Fse &t) {
    if (mode == 0) {
        std::vector<int> probs(dflt, dflt + n_dflt);
        fse_table(probs.data(), n_dflt, dflt_log, t);
    } else if (mode == 1) {
        need(pos < end && data[pos] <= max_sym);
        t.sym.assign(1, data[pos]);
        t.nb.assign(1, 0);
        t.base.assign(1, 0);
        t.log = 0;
        t.valid = true;
        ++pos;
    } else if (mode == 2) {
        std::vector<int> probs;
        int log;
        pos = fse_header(data, pos, end, max_sym, max_log, probs, log);
        fse_table(probs.data(), int(probs.size()), log, t);
    } else {
        need(t.valid);
    }
    return pos;
}

// a compressed block data[pos, end) appended at out[*n], its frame from
// out[base]
void block(const uint8_t *data, int64_t pos, int64_t end, uint8_t *out, int64_t cap,
           int64_t *n, int64_t base, FrameState &st, int64_t block_max,
           std::vector<uint8_t> &lits) {
    pos = literals(data, pos, end, st, lits);
    const int64_t nlit = int64_t(lits.size());
    need(nlit <= block_max);
    need(pos < end);
    const int b0 = data[pos];
    int64_t nseq;
    if (b0 < 128) {
        nseq = b0;
        pos += 1;
    } else if (b0 < 255) {
        need(pos + 2 <= end);
        nseq = ((b0 - 128) << 8) + data[pos + 1];
        pos += 2;
    } else {
        need(pos + 3 <= end);
        nseq = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00;
        pos += 3;
    }
    const int64_t start = *n;
    int64_t o = *n;
    if (nseq == 0) {
        need(pos == end);
        if (o + nlit > cap) throw Full();
        std::memcpy(out + o, lits.data(), size_t(nlit));
        *n = o + nlit;
        return;
    }
    need(pos < end);
    const int modes = data[pos++];
    need((modes & 3) == 0);
    pos = seq_table(modes >> 6, data, pos, end, 35, 9, kLLDefault, 36, 6, st.ll);
    pos = seq_table(modes >> 4 & 3, data, pos, end, 31, 8, kOFDefault, 29, 5, st.of);
    pos = seq_table(modes >> 2 & 3, data, pos, end, 52, 9, kMLDefault, 53, 6, st.ml);
    Backward rd(data, pos, end);
    int sll = int(rd.read(st.ll.log)), sof = int(rd.read(st.of.log)),
        sml = int(rd.read(st.ml.log));
    int64_t *rep = st.rep;
    int64_t lit = 0;
    for (int64_t k = 0; k < nseq; ++k) {
        const int ofc = st.of.sym[sof], llc = st.ll.sym[sll], mlc = st.ml.sym[sml];
        need(ofc <= 31);
        const int64_t ofv = (int64_t(1) << ofc) + rd.read(ofc);
        const int64_t mlv = kMLBase[mlc] + rd.read(kMLBits[mlc]);
        const int64_t llv = kLLBase[llc] + rd.read(kLLBits[llc]);
        if (k + 1 < nseq) {
            sll = st.ll.base[sll] + int(rd.read(st.ll.nb[sll]));
            sml = st.ml.base[sml] + int(rd.read(st.ml.nb[sml]));
            sof = st.of.base[sof] + int(rd.read(st.of.nb[sof]));
        }
        int64_t offset;
        if (ofv > 3) {
            offset = ofv - 3;
            rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = offset;
        } else {
            const int64_t idx = ofv - 1 + (llv == 0);
            if (idx == 0) {
                offset = rep[0];
            } else if (idx == 3) {
                offset = rep[0] - 1;
                need(offset > 0);
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else if (idx == 1) {
                offset = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else {
                offset = rep[2];
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            }
        }
        need(lit + llv <= nlit);
        if (o + llv > cap) throw Full();
        std::memcpy(out + o, lits.data() + lit, size_t(llv));
        o += llv;
        lit += llv;
        need(offset > 0 && offset <= o - base);
        need(o + mlv - start <= block_max);
        if (o + mlv > cap) throw Full();
        const uint8_t *src = out + o - offset;
        if (offset >= mlv) {
            std::memcpy(out + o, src, size_t(mlv));
        } else {
            for (int64_t i = 0; i < mlv; ++i) out[o + i] = src[i];
        }
        o += mlv;
    }
    need(rd.pos == 0);
    const int64_t rest = nlit - lit;
    if (o + rest > cap) throw Full();
    std::memcpy(out + o, lits.data() + lit, size_t(rest));
    o += rest;
    need(o - start <= block_max);
    *n = o;
}

}  // namespace

// The content of the Zstandard frames in src[0, len) into out[0, cap):
// every frame, or the first `frames` (skippable ones counted) where
// frames >= 0, stopping at the first block boundary at or past `limit`
// bytes where limit >= 0. Returns the bytes written, or -1 (corrupt or
// truncated data), -2 (a frame that names a dictionary), -3 (the content
// outgrew `cap`) or -4 (a window over 2^27 bytes).
extern "C" int64_t mnt_zstd_decompress(const uint8_t *src, int64_t len, uint8_t *out,
                                       int64_t cap, int64_t limit, int64_t frames) {
    int64_t pos = 0, n = 0;
    std::vector<uint8_t> lits;
    FrameState st;
    try {
        while (pos < len && frames != 0 && !(limit >= 0 && n >= limit)) {
            --frames;
            need(pos + 4 <= len);
            const uint32_t magic = uint32_t(le(src + pos, 4));
            if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
                need(pos + 8 <= len);
                const int64_t size = int64_t(le(src + pos + 4, 4));
                need(size <= len - pos - 8);
                pos += 8 + size;
                continue;
            }
            need(magic == 0xFD2FB528u && pos + 5 <= len);
            const int fhd = src[pos + 4];
            pos += 5;
            const int fcs_flag = fhd >> 6, single = fhd >> 5 & 1, checksum = fhd >> 2 & 1;
            need((fhd & 8) == 0);
            const int did_size = (fhd & 3) == 3 ? 4 : (fhd & 3);
            const int fcs_size = fcs_flag == 0 ? single : 1 << fcs_flag;
            need(pos + (1 - single) + did_size + fcs_size <= len);
            uint64_t window = 0;
            if (!single) {
                const int wd = src[pos++];
                const int log = 10 + (wd >> 3);
                window = (uint64_t(1) << log) + ((uint64_t(1) << log) >> 3) * uint64_t(wd & 7);
            }
            const uint64_t did = le(src + pos, did_size);
            pos += did_size;
            if (did) throw NeedsDictionary();
            const uint64_t fcs = fcs_size ? le(src + pos, fcs_size) + (fcs_size == 2 ? 256 : 0) : 0;
            pos += fcs_size;
            if (single) window = fcs;
            if (window > (uint64_t(1) << kWindowLogMax)) throw WindowTooLarge();
            const int64_t block_max = int64_t(window) < kBlockMax ? int64_t(window) : kBlockMax;
            const int64_t base = n;
            st = FrameState();
            bool stopped = false;
            for (;;) {
                need(pos + 3 <= len);
                const uint32_t bh = uint32_t(le(src + pos, 3));
                pos += 3;
                const int last = bh & 1, kind = bh >> 1 & 3;
                const int64_t size = bh >> 3;
                need(kind != 3 && size <= block_max);
                if (kind == 0) {
                    need(pos + size <= len);
                    if (n + size > cap) throw Full();
                    std::memcpy(out + n, src + pos, size_t(size));
                    n += size;
                    pos += size;
                } else if (kind == 1) {
                    need(pos < len);
                    if (n + size > cap) throw Full();
                    std::memset(out + n, src[pos], size_t(size));
                    n += size;
                    pos += 1;
                } else {
                    need(pos + size <= len);
                    block(src, pos, pos + size, out, cap, &n, base, st, block_max, lits);
                    pos += size;
                }
                if (!last && limit >= 0 && n >= limit) {
                    stopped = true;
                    break;
                }
                if (last) break;
            }
            if (stopped) break;
            need(!fcs_size || uint64_t(n - base) == fcs);
            if (checksum) {
                need(pos + 4 <= len);
                need((xxh64(out + base, n - base) & 0xFFFFFFFFull) == le(src + pos, 4));
                pos += 4;
            }
        }
    } catch (const Corrupt &) {
        return -1;
    } catch (const NeedsDictionary &) {
        return -2;
    } catch (const Full &) {
        return -3;
    } catch (const WindowTooLarge &) {
        return -4;
    }
    return n;
}
