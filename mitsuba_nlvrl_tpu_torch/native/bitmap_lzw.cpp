// LZW: TIFF's (MSB-first codes, clear 256, end 257, the width growing one
// code early) and GIF's (LSB-first codes from a minimum code size).
//
// The native stages of utils/tiff.py (_lzw) and utils/gif.py (_lzw);
// _lzw_plain beside each is its plain version, which the tests hold it
// to, failures included. Each string is a code's entry of the table
// (prefix entry, last byte, length), written backwards from its last byte.
// Every write lands inside `out` (`cap` bytes): output past it is counted,
// not stored, as the callers keep only that many bytes.

#include <cstdint>
#include <vector>

namespace {

struct Table {
    std::vector<int32_t> prefix;
    std::vector<uint8_t> last, first;
    std::vector<int32_t> length;

    explicit Table(int n) : prefix(n), last(n), first(n), length(n) {}

    // append entry e's string at out[pos...], keeping what fits in cap
    void emit(int32_t e, uint8_t *out, int64_t pos, int64_t cap) const {
        const int32_t n = length[e];
        for (int64_t j = pos + n - 1; j >= pos; --j) {
            if (j < cap) out[j] = last[e];
            e = prefix[e];
        }
    }
};

}  // namespace

// TIFF LZW of src[0, len) into out: returns the bytes the plain version
// decodes (at least `cap` where the stream holds that many; the caller
// keeps `cap`), or -1 where it raises IndexError (a code past the table
// right after a clear). The table grows past 4,096 entries without a
// clear, as the plain version's list does; only its first 4,096 can be
// named by a 12-bit code, so only those are stored.
extern "C" int64_t mnt_tiff_lzw(const uint8_t *src, int64_t len,
                                uint8_t *out, int64_t cap) {
    Table t(4096);
    for (int i = 0; i < 256; ++i) {
        t.prefix[i] = -1;
        t.last[i] = t.first[i] = uint8_t(i);
        t.length[i] = 1;
    }
    int64_t size = 258, n = 0, pos = 0;   // size: the plain table's length
    int width = 9, nacc = 0;
    uint64_t acc = 0;
    int32_t prev = -1;
    while (n < cap) {
        while (nacc < width && pos < len) {
            acc = (acc << 8) | src[pos++];
            nacc += 8;
        }
        if (nacc < width) break;
        nacc -= width;
        const int32_t code = int32_t((acc >> nacc) & ((1u << width) - 1));
        acc &= (uint64_t(1) << nacc) - 1;
        if (code == 256) {
            size = 258;
            width = 9;
            prev = -1;
            continue;
        }
        if (code == 257) break;
        int32_t e;
        if (prev < 0) {
            if (code >= size) return -1;
            e = code;
        } else if (code < size) {
            e = code;
            if (size < 4096) {
                t.prefix[size] = prev;
                t.last[size] = t.first[code];
                t.first[size] = t.first[prev];
                t.length[size] = t.length[prev] + 1;
            }
            ++size;
        } else {                           // KwKwK: prev + its first byte
            e = int32_t(size);             // size < 4096: code is 12 bits
            t.prefix[e] = prev;
            t.last[e] = t.first[prev];
            t.first[e] = t.first[prev];
            t.length[e] = t.length[prev] + 1;
            ++size;
        }
        t.emit(e, out, n, cap);
        n += t.length[e];
        prev = e;
        if (size >= (int64_t(1) << width) - 1 && width < 12) ++width;
    }
    return n;
}

// GIF LZW of codes[0, len) (minimum code size `bits`, 0-12) into out:
// returns the indices decoded, at most `cap` (the frame's pixels), or -1
// where the plain version raises OSError (a first code that is no root,
// a code past the next entry), -2 where it raises ValueError (a first
// code over 255 that its byte array refuses), -3 where it raises
// IndexError (at a minimum code size of 12, a repeated code 4,098).
extern "C" int64_t mnt_gif_lzw(const uint8_t *codes, int64_t len, int bits,
                               uint8_t *out, int64_t cap) {
    const int32_t clear = 1 << bits, eoi = clear + 1;
    Table t(4096);
    for (int i = 0; i < 4096; ++i) {
        t.prefix[i] = i;
        t.last[i] = t.first[i] = uint8_t(i & 0xFF);
        t.length[i] = 1;
    }
    int32_t next = eoi + 1, prev = -1;
    int size = bits + 1, nacc = 0;
    uint64_t acc = 0;
    int64_t n = 0, pos = 0;
    while (n < cap) {
        while (nacc < size && pos < len) {
            acc |= uint64_t(codes[pos++]) << nacc;
            nacc += 8;
        }
        if (nacc < size) break;
        const int32_t code = int32_t(acc & ((uint64_t(1) << size) - 1));
        acc >>= size;
        nacc -= size;
        if (code == clear) {
            next = eoi + 1;
            size = bits + 1;
            prev = -1;
            continue;
        }
        if (code == eoi) break;
        if (prev < 0) {
            if (code >= clear) return -1;
            if (code > 255) return -2;
            out[n++] = uint8_t(code);
            prev = code;
            continue;
        }
        uint8_t c;
        if (code < next) {
            t.emit(code, out, n, cap);
            n += t.length[code];
            c = t.first[code];
        } else if (code == next) {                 // KwKwK
            if (prev >= 4096) return -3;   // 12-bit codes: past the table
            t.emit(prev, out, n, cap);
            c = t.first[prev];
            n += t.length[prev];
            if (n < cap) out[n] = c;
            ++n;
        } else {
            return -1;
        }
        if (next < 4096) {
            t.prefix[next] = prev;
            t.last[next] = c;
            t.first[next] = t.first[prev];
            t.length[next] = t.length[prev] + 1;
            if (next == (1 << size) - 1 && size < 12) ++size;
            ++next;
        }
        prev = code;
    }
    return n < cap ? n : cap;
}
