// The sequential loops of small raster codings, as PIL decodes them: QOI's
// ops (utils/qoi.py, _qoi), SGI's RLE rows (utils/sgi.py, _sgi_rle), PCX's
// RLE (utils/pcx.py, _pcx_rle), TIFF's ThunderScan coding (utils/tiff.py,
// _thunderscan), as libtiff's tif_thunder.c decodes it, Sun raster's RLE
// (utils/sun.py, _sun_rle), MSP's RLE rows (utils/msp.py, _msp_rle) and
// an FLI/FLC frame's chunks (utils/fli.py, _fli_frame). The `_plain`
// function beside each wrapper is its plain version, which the tests hold
// it to, failures included. Every read lands inside `src` (`len` bytes)
// and every write inside `out`.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

// QOI: the `npix` pixels (`channels` 3 or 4 bytes each) of the ops in
// src[0, len) into out. PIL's decoder: the previous pixel starts opaque
// black, the 64-entry index (hashed on RGBA) is written by every op but a
// run, and an entry never written reads transparent black; a run past the
// image is cut. Returns 0, -1 where an op byte (or LUMA's second byte) is
// missing (IndexError) or -2 where an RGB or RGBA op is cut short
// (ValueError).
extern "C" int mnt_qoi_decode(const uint8_t *src, int64_t len, int64_t npix,
                              int channels, uint8_t *out) {
    uint8_t seen[64][4];
    std::memset(seen, 0, sizeof seen);
    uint8_t prev[4] = {0, 0, 0, 255};
    const int64_t need = npix * channels;
    int64_t n = 0, pos = 0;
    while (n < need) {
        if (pos >= len) return -1;
        const uint8_t b = src[pos++];
        uint8_t v[4];
        if (b == 0xFE) {
            if (pos + 3 > len) return -2;
            v[0] = src[pos];
            v[1] = src[pos + 1];
            v[2] = src[pos + 2];
            v[3] = prev[3];
            pos += 3;
        } else if (b == 0xFF) {
            if (pos + 4 > len) return -2;
            std::memcpy(v, src + pos, 4);
            pos += 4;
        } else if ((b >> 6) == 0) {
            std::memcpy(v, seen[b & 63], 4);
        } else if ((b >> 6) == 1) {
            v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
            v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
            v[2] = uint8_t(prev[2] + (b & 3) - 2);
            v[3] = prev[3];
        } else if ((b >> 6) == 2) {
            if (pos >= len) return -1;
            const uint8_t b2 = src[pos++];
            const int dg = (b & 63) - 32;
            v[0] = uint8_t(prev[0] + dg + (b2 >> 4) - 8);
            v[1] = uint8_t(prev[1] + dg);
            v[2] = uint8_t(prev[2] + dg + (b2 & 15) - 8);
            v[3] = prev[3];
        } else {
            for (int r = (b & 63) + 1; r > 0 && n < need; --r)
                for (int c = 0; c < channels && n < need; ++c) out[n++] = prev[c];
            continue;
        }
        std::memcpy(prev, v, 4);
        std::memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
        for (int c = 0; c < channels && n < need; ++c) out[n++] = v[c];
    }
    return 0;
}

namespace {

// PIL's expandrow (bpc 1) and expandrow2 (bpc 2), one channel of one row
// into row (w pixels of z samples): 0 at the row's end, 1 where the image
// ends quietly, -1 on overrun. `end` is the last byte's index.
int expand_row(const uint8_t *body, int64_t end, int64_t pos, int64_t n,
               uint8_t *row, int ch, int z, int64_t w, int bpc) {
    int64_t x = 0;
    while (n > 0) {
        if (pos + bpc - 1 > end) return -1;
        const uint8_t op = body[pos + bpc - 1];
        pos += bpc;
        if (n == 1 && op != 0) return 1;
        const int count = op & 0x7F;
        if (!count) return 0;
        if (x + count > w) return -1;
        if (op & 0x80) {
            if (pos + int64_t(bpc) * count > end) return -1;
            for (int k = 0; k < count; ++k) row[(x + k) * z + ch] = body[pos + k * bpc];
            pos += int64_t(bpc) * count;
        } else {
            if (pos + (bpc == 1 ? 0 : 2) > end) return -1;
            for (int k = 0; k < count; ++k) row[(x + k) * z + ch] = body[pos];
            pos += bpc;
        }
        x += count;
        --n;
    }
    return 0;
}

}  // namespace

// SGI RLE: the rows of an image (w x h, z channels of bpc bytes: `zb` is
// z | bpc << 8) from body[0, len), the data after the 512-byte header,
// through the offset and length tables `start` and `length` (h * z each,
// offsets from the file's start), into out (h x w x z, top row first; the
// file's first row is the bottom). The row buffer is kept across rows.
// Returns 0 (also where a row's length runs out on a nonzero opcode, which
// ends the image), or -1 on an overrun (OSError).
extern "C" int mnt_sgi_rle_rows(const uint8_t *body, int64_t len,
                                const int64_t *start, const int64_t *length,
                                int64_t w, int64_t h, int zb, uint8_t *out) {
    const int z = zb & 0xFF, bpc = zb >> 8;
    if (z < 1 || (bpc != 1 && bpc != 2) || w < 0 || h < 0) return -1;
    std::vector<uint8_t> row(size_t(w) * z, 0);
    for (int64_t r = 0; r < h; ++r) {
        for (int c = 0; c < z; ++c) {
            const int64_t off = start[r + c * h] - 512, n = length[r + c * h];
            if (off < 0 || off + n > len) return -1;
            const int st = expand_row(body, len - 1, off, n, row.data(), c, z, w, bpc);
            if (st < 0) return -1;
            if (st == 1) return 0;
        }
        std::memcpy(out + (h - 1 - r) * w * z, row.data(), row.size());
    }
    return 0;
}

// PCX RLE: h rows of nbytes bytes from src[0, len) into out. Returns 0, or
// -1 where the data ends before the last row (OSError: truncated); a run
// past a row's end is cut there and sets *overrun (OSError once decoded).
extern "C" int mnt_pcx_rle(const uint8_t *src, int64_t len, int64_t nbytes,
                           int64_t h, uint8_t *out, int64_t *overrun) {
    int64_t x = 0, y = 0, pos = 0;
    *overrun = 0;
    if (nbytes <= 0) return h > 0 ? -1 : 0;
    uint8_t *row = out;
    while (y < h) {
        if (pos >= len) return -1;
        const uint8_t b = src[pos];
        if ((b & 0xC0) == 0xC0) {
            if (pos + 1 >= len) return -1;
            int64_t count = b & 0x3F;
            if (x + count > nbytes) {
                *overrun = 1;
                count = nbytes - x;
            }
            std::memset(row + x, src[pos + 1], size_t(count));
            x += count;
            pos += 2;
        } else {
            row[x++] = b;
            ++pos;
        }
        if (x >= nbytes) {
            x = 0;
            row += nbytes;
            ++y;
        }
    }
    return 0;
}

// ThunderScan (TIFF compression 32809): `rows` rows of `width` 4-bit
// pixels from src[0, len) into out, each row packed high nibble first in
// ceil(width / 2) bytes, as libtiff's ThunderDecode writes them. Each row
// starts with the last pixel 0 and takes codes until it is full: a run
// (0x00 | n) repeats the last pixel n times, 2-bit (0x40) and 3-bit
// (0x80) deltas add to it (skip codes 2 and 4), a raw pixel (0xC0 | v)
// sets it. A run that reaches or passes the row's end writes nothing, as
// there. Returns 0, -1 where the data ends inside a row ("Not enough
// data") or -2 where a run passes the row's end ("Too much data").
extern "C" int mnt_thunderscan(const uint8_t *src, int64_t len, int64_t width, int64_t rows,
                               uint8_t *out) {
    static const int two[4] = {0, 1, 0, -1};
    static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
    const int64_t stride = (width + 1) / 2;
    int64_t pos = 0;
    std::memset(out, 0, size_t(stride * rows));
    for (int64_t r = 0; r < rows; ++r) {
        uint8_t *op = out + r * stride;
        unsigned last = 0;
        int64_t n = 0;
        auto set = [&](unsigned v) {
            last = v & 0xF;
            if (n < width) {
                if (n++ & 1)
                    *op++ |= uint8_t(last);
                else
                    op[0] = uint8_t(last << 4);
            }
        };
        while (pos < len && n < width) {
            int c = src[pos++];
            switch (c & 0xC0) {
                case 0x00: {  // run
                    c &= 0x3F;
                    if (n & 1) {
                        op[0] |= uint8_t(last);
                        last = *op++;
                        ++n;
                        --c;
                    } else {
                        last |= last << 4;
                    }
                    n += c;
                    if (n < width)
                        for (; c > 0; c -= 2) *op++ = uint8_t(last);
                    if (c == -1) *--op &= 0xF0;
                    last &= 0xF;
                    break;
                }
                case 0x40:  // 2-bit deltas
                    for (int sh = 4; sh >= 0; sh -= 2) {
                        const int d = (c >> sh) & 3;
                        if (d != 2) set(unsigned(int(last) + two[d]));
                    }
                    break;
                case 0x80:  // 3-bit deltas
                    for (int sh = 3; sh >= 0; sh -= 3) {
                        const int d = (c >> sh) & 7;
                        if (d != 4) set(unsigned(int(last) + three[d]));
                    }
                    break;
                default:  // raw
                    set(unsigned(c));
            }
        }
        if (n != width) return n < width ? -1 : -2;
    }
    return 0;
}

// Sun raster RLE: h rows of nbytes bytes from src[0, len) into out, as
// PIL's sun_rle decoder: 0x80 n v is n + 1 copies of v (a run past a row
// goes on into the next rows), 0x80 0 one 0x80, any other byte itself.
// Returns 0, or -1 where the data ends before the last row (OSError).
extern "C" int mnt_sun_rle(const uint8_t *src, int64_t len, int64_t nbytes,
                           int64_t h, uint8_t *out) {
    const int64_t total = nbytes * h;
    int64_t at = 0, pos = 0;
    while (at < total) {
        if (pos >= len) return -1;
        const uint8_t b = src[pos];
        if (b != 0x80) {
            out[at++] = b;
            ++pos;
            continue;
        }
        if (pos + 1 >= len) return -1;
        int64_t n = src[pos + 1];
        if (n == 0) {
            out[at++] = 0x80;
            pos += 2;
            continue;
        }
        if (pos + 2 >= len) return -1;
        n = std::min(n + 1, total - at);
        std::memset(out + at, src[pos + 2], size_t(n));
        at += n;
        pos += 3;
    }
    return 0;
}

// MSP version 2 rows, as PIL's MspDecoder: each of the `rows` entries of
// rowmap is the bytes of a row in src (read one after another from its
// start; 0: a row of nbytes 0xFF), whose runs (0 n v: n copies of v;
// n > 0: the next n bytes, cut at the row's end) append to one stream.
// The stream's first `need` bytes go to out. Returns the stream's length
// (at most need), -1 where a row runs past the data (OSError: truncated)
// or -2 where a run's count and value run past its row (OSError).
extern "C" int64_t mnt_msp_rle(const uint8_t *src, int64_t len, const int64_t *rowmap,
                               int64_t rows, int64_t nbytes, uint8_t *out, int64_t need) {
    int64_t at = 0, pos = 0;
    auto put = [&](const uint8_t *p, int64_t n, int v) {
        const int64_t k = std::min(n, need - at);
        if (k <= 0) return;
        if (p)
            std::memcpy(out + at, p, size_t(k));
        else
            std::memset(out + at, v, size_t(k));
        at += k;
    };
    for (int64_t r = 0; r < rows; ++r) {
        const int64_t rowlen = rowmap[r];
        if (rowlen == 0) {
            put(nullptr, nbytes, 0xFF);
            continue;
        }
        if (pos + rowlen > len) return -1;
        const uint8_t *row = src + pos;
        pos += rowlen;
        int64_t idx = 0;
        while (idx < rowlen) {
            const int type = row[idx++];
            if (type == 0) {
                if (idx + 2 > rowlen) return -2;
                put(nullptr, row[idx], row[idx + 1]);
                idx += 2;
            } else {
                put(row + idx, std::min<int64_t>(type, rowlen - idx), 0);
                idx += type;
            }
        }
    }
    return at;
}

namespace {

int i16(const uint8_t *p) { return p[0] | (p[1] << 8); }

int32_t i32(const uint8_t *p) {
    return int32_t(uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
                   (uint32_t(p[3]) << 24));
}

}  // namespace

// One FLI/FLC frame (src[0, len), from its size word) into out (h x w
// indices, zero at the start), as PIL's fli decoder: the chunks SS2 (7),
// LC (12), BLACK (13), BRUN (15) and COPY (16); the colour chunks (4, 11)
// and PSTAMP (18) skipped. Returns 0, -1 where a COPY chunk runs past the
// frame (OSError: truncated), -2 where a read or a row runs past its
// bounds (overrun), -3 for a frame or chunk of another kind, -4 for a
// chunk of size 0.
extern "C" int mnt_fli_frame(const uint8_t *src, int64_t len, int64_t w, int64_t h,
                             uint8_t *out) {
    if (len < 8) return -2;
    if (i16(src + 4) != 0xF1FA) return -3;
    const int chunks = i16(src + 6);
    int64_t ptr = 16, left = len - 16;
#define OOB(k) \
    if (d + (k) > ptr + left) return -2
    for (int c = 0; c < chunks; ++c) {
        if (left < 10) return -2;
        int64_t d = ptr + 6;
        switch (i16(src + ptr + 4)) {
        case 4:
        case 11:
        case 18:
            break;
        case 7: {  // SS2: word deltas
            const int lines = i16(src + d);
            d += 2;
            int64_t y = 0;
            int l = 0;
            for (; l < lines && y < h; ++l, ++y) {
                OOB(2);
                int packets = i16(src + d);
                d += 2;
                while (packets & 0x8000) {
                    if (packets & 0x4000) {
                        y += 65536 - packets;
                        if (y >= h) return -2;
                    } else {
                        out[y * w + w - 1] = uint8_t(packets);
                    }
                    OOB(2);
                    packets = i16(src + d);
                    d += 2;
                }
                uint8_t *row = out + y * w;
                int64_t x = 0;
                int p = 0;
                for (; p < packets; ++p) {
                    OOB(2);
                    x += src[d];
                    if (src[d + 1] >= 128) {
                        OOB(4);
                        const int64_t i = 256 - src[d + 1];
                        if (x + 2 * i > w) break;
                        for (int64_t j = 0; j < i; ++j) {
                            row[x++] = src[d + 2];
                            row[x++] = src[d + 3];
                        }
                        d += 4;
                    } else {
                        const int64_t i = 2 * int64_t(src[d + 1]);
                        if (x + i > w) break;
                        OOB(2 + i);
                        std::memcpy(row + x, src + d + 2, size_t(i));
                        d += 2 + i;
                        x += i;
                    }
                }
                if (p < packets) break;
            }
            if (l < lines) return -2;
            break;
        }
        case 12: {  // LC: byte deltas
            int64_t y = i16(src + d);
            const int64_t ymax = y + i16(src + d + 2);
            d += 4;
            for (; y < ymax && y < h; ++y) {
                uint8_t *row = out + y * w;
                OOB(1);
                const int packets = src[d++];
                int64_t x = 0, i = 0;
                int p = 0;
                for (; p < packets; ++p, x += i) {
                    OOB(2);
                    x += src[d];
                    if (src[d + 1] & 0x80) {
                        i = 256 - src[d + 1];
                        if (x + i > w) break;
                        OOB(3);
                        std::memset(row + x, src[d + 2], size_t(i));
                        d += 3;
                    } else {
                        i = src[d + 1];
                        if (x + i > w) break;
                        OOB(2 + i);
                        std::memcpy(row + x, src + d + 2, size_t(i));
                        d += 2 + i;
                    }
                }
                if (p < packets) break;
            }
            if (y < ymax) return -2;
            break;
        }
        case 13:  // BLACK
            std::memset(out, 0, size_t(w * h));
            break;
        case 15:  // BRUN: byte runs, every row
            for (int64_t y = 0; y < h; ++y) {
                uint8_t *row = out + y * w;
                d += 1;  // the row's packet count, unused
                int64_t x = 0, i = 0;
                for (; x < w; x += i) {
                    OOB(2);
                    if (src[d] & 0x80) {
                        i = 256 - src[d];
                        if (x + i > w) break;
                        OOB(i + 1);
                        std::memcpy(row + x, src + d + 1, size_t(i));
                        d += i + 1;
                    } else {
                        i = src[d];
                        if (x + i > w) break;
                        std::memset(row + x, src[d + 1], size_t(i));
                        d += 2;
                    }
                }
                if (x != w) return -2;
            }
            break;
        case 16:  // COPY
            if (d + w * h > ptr + left) return -1;
            std::memcpy(out, src + d, size_t(w * h));
            break;
        default:
            return -3;
        }
        const int64_t advance = i32(src + ptr);
        if (advance == 0) return -4;
        if (advance < 0 || advance > left) return -2;
        ptr += advance;
        left -= advance;
    }
#undef OOB
    return 0;
}
