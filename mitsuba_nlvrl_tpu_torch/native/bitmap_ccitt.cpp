// CCITT bilevel decoding for TIFF: modified Huffman (compression 2), T.4
// (compression 3, 1-D and 2-D) and T.6 (compression 4), as libtiff
// decodes them under PIL.
//
// The native stage of utils/ccitt.py (decode); decode_plain beside it is
// its plain version, which the tests hold it to, failures included. The
// code tables are the same strings. Every read lands inside `src` (`len`
// bytes) and every write inside `out` (rows x ceil(width / 8) bytes).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <sstream>
#include <string>
#include <vector>

namespace {

const char *W_TERM =
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100";
const char *W_MAKEUP =
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011";
const char *B_TERM =
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111";
const char *B_MAKEUP =
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101";
const char *EXT_MAKEUP =
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111";
const char *EOL = "000000000001";

const int EOL_RUN = -1, NONE = -2;
// 2-D modes: vertical offsets -3..3, then pass, horizontal, extension
const int PASS = 100, HORIZ = 101, EXT = 102;

// a table of prefix codes at most `longest` bits long, looked up on the
// next `longest` bits: value and code length of each entry
struct Table {
    int longest;
    std::vector<int> value, length;
    explicit Table(int n) : longest(n), value(1 << n, NONE), length(1 << n, 0) {}
    void add(const std::string &code, int v) {
        const int L = int(code.size());
        int c = 0;
        for (char ch : code) c = (c << 1) | (ch == '1');
        for (int k = 0; k < (1 << (longest - L)); ++k) {
            value[(c << (longest - L)) | k] = v;
            length[(c << (longest - L)) | k] = L;
        }
    }
    void add_list(const char *codes, int first, int step) {
        std::istringstream in(codes);
        std::string code;
        for (int v = first; in >> code; v += step) add(code, v);
    }
};

struct Tables {
    Table white{13}, black{13}, modes{7};
    Tables() {
        for (Table *t : {&white, &black}) {
            t->add_list(t == &white ? W_TERM : B_TERM, 0, 1);
            t->add_list(t == &white ? W_MAKEUP : B_MAKEUP, 64, 64);
            t->add_list(EXT_MAKEUP, 1792, 64);
            t->add(EOL, EOL_RUN);
        }
        modes.add("0001", PASS);
        modes.add("001", HORIZ);
        modes.add("1", 0);
        modes.add("011", 1);
        modes.add("000011", 2);
        modes.add("0000011", 3);
        modes.add("010", -1);
        modes.add("000010", -2);
        modes.add("0000010", -3);
        modes.add("0000001", EXT);
    }
};

const Tables &tables() {
    static const Tables t;
    return t;
}

struct BadCode {};
struct Eof {};

struct Reader {
    const uint8_t *src;
    int64_t nbits, pos = 0;
    // the bytes libtiff's bit accumulator has taken in: it loads a byte
    // at a time until it holds the 12 bits of a white code or the 13 of
    // a black one, as far as the data goes
    int64_t loaded = 0;
    Reader(const uint8_t *s, int64_t len) : src(s), nbits(len * 8) {}
    int bit_at(int64_t p) const { return (src[p >> 3] >> (7 - (p & 7))) & 1; }
    // the value of the next code of `t`
    int code(const Table &t) {
        uint32_t peek = 0;
        for (int k = 0; k < t.longest; ++k)
            peek = (peek << 1) | (pos + k < nbits ? uint32_t(bit_at(pos + k)) : 0u);
        const int L = t.length[peek];
        const int64_t left = nbits - pos;
        if (L == 0 || L > left) {
            if (left < t.longest) throw Eof();
            throw BadCode();
        }
        pos += L;
        return t.value[peek];
    }
    int bit() {
        if (pos >= nbits) throw Eof();
        return bit_at(pos++);
    }
    void sync_eol() {
        for (;;) {
            if (pos + 11 > nbits) throw Eof();
            bool zero = true;
            for (int k = 0; k < 11 && zero; ++k) zero = !bit_at(pos + k);
            if (zero) break;
            ++pos;
        }
        for (;;) {
            if (pos >= nbits) throw Eof();
            if (bit_at(pos++)) return;
        }
    }
};

int64_t run(Reader &rd, int colour) {
    const Table &t = colour ? tables().black : tables().white;
    int64_t total = 0;
    for (;;) {
        const int64_t want = (rd.pos + (colour ? 13 : 12) + 7) / 8, len = rd.nbits / 8;
        if (want > rd.loaded) rd.loaded = want < len ? want : len;
        const int v = rd.code(t);
        if (v == EOL_RUN) throw BadCode();
        total += v;
        if (v < 64) return total;
    }
}

void row_1d(Reader &rd, int64_t width, std::vector<int64_t> &changes) {
    int64_t a0 = 0;
    int colour = 0;
    for (;;) {
        a0 += run(rd, colour);
        if (a0 > width) throw BadCode();
        if (a0 >= width) return;
        changes.push_back(a0);
        colour ^= 1;
    }
}

// `ref` holds the reference row's changes then two sentinels (width)
void row_2d(Reader &rd, int64_t width, const std::vector<int64_t> &ref,
            std::vector<int64_t> &changes) {
    const int64_t last = int64_t(ref.size()) - 1;
    int64_t a0 = -1, j = 0;
    int colour = 0;
    while (a0 < width) {
        j = j > 3 ? j - 3 : 0;
        while (j < last && !(ref[j] > a0 && (j & 1) == colour)) ++j;
        const int64_t b1 = ref[j], b2 = ref[j + 1 <= last ? j + 1 : last];
        const int mode = rd.code(tables().modes);
        if (mode == EXT) break;     // the row's rest keeps the current colour
        if (mode == PASS) {
            a0 = b2;
        } else if (mode == HORIZ) {
            const int64_t start = a0 > 0 ? a0 : 0;
            const int64_t r1 = run(rd, colour);
            const int64_t r2 = run(rd, colour ^ 1);
            if (start + r1 + r2 > width) throw BadCode();
            changes.push_back(start + r1);
            changes.push_back(start + r1 + r2);
            a0 = start + r1 + r2;
        } else {
            const int64_t a1 = b1 + mode;
            if (a1 < (a0 > 0 ? a0 : 0) || a1 > width) throw BadCode();
            changes.push_back(a1);
            a0 = a1;
            colour ^= 1;
        }
    }
    while (!changes.empty() && changes.back() >= width) changes.pop_back();
}

}  // namespace

// `rows` rows of `width` pixels from the CCITT data src[0, len) into out,
// each row packed MSB first from a byte boundary, 1 where the run is
// black: comp 2 (each row from a byte boundary, 1-D), 32771 (1-D, each
// row after the word alignment of libtiff's reader: the bits left in its
// accumulator cut to a multiple of 16, and where none are left and the
// next byte's address is odd, that byte skipped; options bit 0 says the
// data starts at an odd address), 3 (each row after an EOL; with options
// bit 0, a tag bit after it: 1 for 1-D, 0 for 2-D) or 4 (2-D, no EOL).
// `reserved` is 0. A 2-D extension code (uncompressed mode)
// ends its row in the current colour. Returns 0, -1 where the data ends
// inside a row, or -2 for a bad code (one not in its table, an EOL or a
// run past the row's end inside a row).
extern "C" int mnt_ccitt_decode(const uint8_t *src, int64_t len, int comp,
                                int64_t width, int64_t rows, int options,
                                int reserved, uint8_t *out) {
    (void)reserved;
    if (width < 0 || rows < 0 || ((comp < 2 || comp > 4) && comp != 32771)) return -2;
    static std::once_flag once;
    std::call_once(once, [] { tables(); });
    const int64_t stride = (width + 7) / 8;
    std::memset(out, 0, size_t(rows * stride));
    Reader rd(src, len);
    std::vector<int64_t> ref = {width, width}, changes;
    try {
        for (int64_t y = 0; y < rows; ++y) {
            changes.clear();
            if (comp == 2) {
                rd.pos = (rd.pos + 7) / 8 * 8;
                row_1d(rd, width, changes);
            } else if (comp == 32771) {
                if (y) {
                    const int64_t held = (rd.loaded * 8 - rd.pos) & ~int64_t(15);
                    rd.pos = rd.loaded * 8 - held;
                    if (held == 0 && ((rd.loaded + options) & 1)) rd.pos = ++rd.loaded * 8;
                }
                row_1d(rd, width, changes);
            } else if (comp == 3) {
                rd.sync_eol();
                const bool two_d = (options & 1) && rd.bit() == 0;
                if (two_d)
                    row_2d(rd, width, ref, changes);
                else
                    row_1d(rd, width, changes);
            } else {
                row_2d(rd, width, ref, changes);
            }
            uint8_t *row = out + y * stride;
            const size_t n = changes.size();
            for (size_t k = 0; k < n; k += 2) {
                const int64_t a = changes[k], b = k + 1 < n ? changes[k + 1] : width;
                for (int64_t x = a; x < b; ++x) row[x >> 3] |= uint8_t(0x80 >> (x & 7));
            }
            ref = changes;
            ref.push_back(width);
            ref.push_back(width);
        }
    } catch (const Eof &) {
        return -1;
    } catch (const BadCode &) {
        return -2;
    }
    return 0;
}
