"""CCITT bilevel coding for TIFF (compression 2, 32771, 3 and 4), as
libtiff decodes it under PIL: modified Huffman rows (compression 2: 1-D,
each row from a byte boundary, no EOL; 32771, libtiff's ``CCITTRLEW``:
each row from a 16-bit boundary as libtiff's reader finds it, below),
T.4 (compression 3: every row after an EOL, fill bits before it
skipped; 1-D, or with ``T4Options`` bit 0 a tag bit after each EOL
choosing 1-D or 2-D) and T.6 (compression 4: every row 2-D, no EOL).
The reference line of a strip or tile's first 2-D row is white. A
decoded pixel is 1 where its run is black.

``decode`` runs in ``native/bitmap_ccitt.cpp``; ``decode_plain`` is its
plain version, which the tests hold it to, failures included: data that
ends inside a row raises ``OSError`` ("premature EOF"), as does a code
that is no code of its table, an EOL inside a row and a run past the
row's end (where libtiff warns and pads the row). A 2-D extension code
(uncompressed mode, which libtiff does not decode) ends its row in the
current colour, as libtiff leaves it; a T.4 row after it starts at the
next EOL.

libtiff aligns a word-aligned row through its bit accumulator, which
loads a byte at a time until it holds the 12 bits of a white code or the
13 of a black one: at a row's end it keeps the accumulator's bits cut to
a multiple of 16, and where none are left and the next byte's address
is odd, it skips that byte. Where a row ends at an odd byte count with
16 or more bits held, the next row starts at an odd byte, which no
encoder that pads to words would write; a file's rows decode as libtiff
reads them all the same. The data's own address counts (``odd``: the
strip or tile starts at an odd offset in the file, which libtiff maps).
"""
from __future__ import annotations

import numpy as np

# the run-length codes of T.4: white and black terminating (0-63) and
# make-up codes (64-1728), and the extended make-up codes (1792-2560)
# both colours share
W_TERM = (
    '00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 '
    '001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 '
    '0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 '
    '00000010 00000011 00011010 00011011 00010010 00010011 00010100 '
    '00010101 00010110 00010111 00101000 00101001 00101010 00101011 '
    '00101100 00101101 00000100 00000101 00001010 00001011 01010010 '
    '01010011 01010100 01010101 00100100 00100101 01011000 01011001 '
    '01011010 01011011 01001010 01001011 00110010 00110011 00110100')
W_MAKEUP = (
    '11011 10010 010111 0110111 00110110 00110111 01100100 01100101 '
    '01101000 01100111 011001100 011001101 011010010 011010011 011010100 '
    '011010101 011010110 011010111 011011000 011011001 011011010 '
    '011011011 010011000 010011001 010011010 011000 010011011')
B_TERM = (
    '0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 '
    '0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 '
    '0000001000 00001100111 00001101000 00001101100 00000110111 '
    '00000101000 00000010111 00000011000 000011001010 000011001011 '
    '000011001100 000011001101 000001101000 000001101001 000001101010 '
    '000001101011 000011010010 000011010011 000011010100 000011010101 '
    '000011010110 000011010111 000001101100 000001101101 000011011010 '
    '000011011011 000001010100 000001010101 000001010110 000001010111 '
    '000001100100 000001100101 000001010010 000001010011 000000100100 '
    '000000110111 000000111000 000000100111 000000101000 000001011000 '
    '000001011001 000000101011 000000101100 000001011010 000001100110 '
    '000001100111')
B_MAKEUP = (
    '0000001111 000011001000 000011001001 000001011011 000000110011 '
    '000000110100 000000110101 0000001101100 0000001101101 0000001001010 '
    '0000001001011 0000001001100 0000001001101 0000001110010 '
    '0000001110011 0000001110100 0000001110101 0000001110110 '
    '0000001110111 0000001010010 0000001010011 0000001010100 '
    '0000001010101 0000001011010 0000001011011 0000001100100 '
    '0000001100101')
EXT_MAKEUP = (
    '00000001000 00000001100 00000001101 000000010010 000000010011 '
    '000000010100 000000010101 000000010110 000000010111 000000011100 '
    '000000011101 000000011110 000000011111')
EOL = '000000000001'
# 2-D mode codes: pass, horizontal, vertical -3..3, extension
MODES_2D = {'0001': 'P', '001': 'H', '1': 0, '011': 1, '000011': 2,
            '0000011': 3, '010': -1, '000010': -2, '0000010': -3,
            '0000001': 'X'}


def _runs(colour: int) -> dict:
    """{code: run} of one colour (0 white, 1 black)."""
    term, makeup = (W_TERM, W_MAKEUP) if colour == 0 else (B_TERM, B_MAKEUP)
    out = {c: r for r, c in enumerate(term.split())}
    out.update({c: 64 * (k + 1) for k, c in enumerate(makeup.split())})
    out.update({c: 1792 + 64 * k for k, c in enumerate(EXT_MAKEUP.split())})
    return out


def decode(src: bytes, comp: int, width: int, rows: int,
           options: int = 0) -> bytes:
    """``rows`` rows of ``width`` pixels from the CCITT data ``src``
    (``comp`` 2, 32771, 3 or 4; ``options``: the T4Options of
    compression 3, or for 32771 1 where the data starts at an odd file
    offset),
    packed MSB first, each row from a byte boundary; in
    ``native/bitmap_ccitt.cpp``. Fails as ``decode_plain`` does."""
    from ..native import bitmap_library, ptr
    buf = np.frombuffer(src, np.uint8)
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    rc = bitmap_library().mnt_ccitt_decode(ptr(buf), buf.size, comp, width,
                                           rows, options, 0, ptr(out))
    if rc < 0:
        raise OSError("CCITT data: " + ("premature EOF" if rc == -1 else
                                        "bad code"))
    return out.tobytes()


class _Reader:
    def __init__(self, src: bytes):
        self.bits = np.unpackbits(np.frombuffer(src, np.uint8))
        self.pos = 0
        self.loaded = 0             # the bytes libtiff's accumulator took

    def code(self, table: dict, longest: int):
        """The value of the next code of ``table``; raises where the data
        ends first or no code matches."""
        c = ''
        while len(c) < longest:
            if self.pos >= self.bits.size:
                raise OSError("CCITT data: premature EOF")
            c += '1' if self.bits[self.pos] else '0'
            self.pos += 1
            if c in table:
                return table[c]
        raise OSError("CCITT data: bad code")

    def sync_eol(self):
        """libtiff's SYNC_EOL: skip to eleven zero bits, then past the
        zeros to the EOL's one."""
        n = self.bits.size
        while True:
            if self.pos + 11 > n:
                raise OSError("CCITT data: premature EOF")
            if not self.bits[self.pos:self.pos + 11].any():
                break
            self.pos += 1
        while True:
            if self.pos >= n:
                raise OSError("CCITT data: premature EOF")
            bit = self.bits[self.pos]
            self.pos += 1
            if bit:
                return

    def bit(self) -> int:
        if self.pos >= self.bits.size:
            raise OSError("CCITT data: premature EOF")
        self.pos += 1
        return int(self.bits[self.pos - 1])


_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        runs = [_runs(0), _runs(1)]
        for t in runs:
            t[EOL] = 'EOL'
        _TABLES = runs
    return _TABLES


def _run(rd: _Reader, colour: int) -> int:
    total = 0
    while True:
        rd.loaded = max(rd.loaded, min(-(-(rd.pos + 12 + colour) // 8),
                                       rd.bits.size // 8))
        v = rd.code(_tables()[colour], 13)
        if v == 'EOL':
            raise OSError("CCITT data: bad code")
        total += v
        if v < 64:
            return total


def _row_1d(rd: _Reader, width: int) -> list:
    """The changing elements of one 1-D row."""
    changes, a0, colour = [], 0, 0
    while True:
        a0 += _run(rd, colour)
        if a0 > width:
            raise OSError("CCITT data: bad code")
        if a0 >= width:
            return changes
        changes.append(a0)
        colour ^= 1


def _row_2d(rd: _Reader, width: int, ref: list) -> list:
    """The changing elements of one 2-D row against the reference row's
    ``ref`` (a change at an even index turns black, at an odd one
    white)."""
    ref = ref + [width, width]
    last = len(ref) - 1
    changes, a0, colour, j = [], -1, 0, 0
    while a0 < width:
        # b1: the first change of the reference row right of a0 to the
        # colour opposite a0's (a0 only grows, so the search starts three
        # changes back); b2 the next
        j = max(j - 3, 0)
        while j < last and not (ref[j] > a0 and j & 1 == colour):
            j += 1
        b1, b2 = ref[j], ref[min(j + 1, last)]
        mode = rd.code(MODES_2D, 7)
        if mode == 'X':         # the row's rest keeps the current colour
            break
        if mode == 'P':
            a0 = b2
        elif mode == 'H':
            start = max(a0, 0)
            r1 = _run(rd, colour)
            r2 = _run(rd, colour ^ 1)
            if start + r1 + r2 > width:
                raise OSError("CCITT data: bad code")
            changes += [start + r1, start + r1 + r2]
            a0 = start + r1 + r2
        else:
            a1 = b1 + mode
            if a1 < max(a0, 0) or a1 > width:
                raise OSError("CCITT data: bad code")
            changes.append(a1)
            a0 = a1
            colour ^= 1
    return [c for c in changes if c < width]


def decode_plain(src: bytes, comp: int, width: int, rows: int,
                 options: int = 0) -> bytes:
    """``decode`` in Python."""
    rd = _Reader(src)
    stride = (width + 7) // 8
    out = np.zeros((rows, stride * 8), np.uint8)
    ref = []
    for y in range(rows):
        if comp == 2:
            rd.pos = -(-rd.pos // 8) * 8
            changes = _row_1d(rd, width)
        elif comp == 32771:
            if y:
                held = (rd.loaded * 8 - rd.pos) & ~15
                rd.pos = rd.loaded * 8 - held
                if held == 0 and (rd.loaded + options) & 1:
                    rd.loaded += 1
                    rd.pos = rd.loaded * 8
            changes = _row_1d(rd, width)
        elif comp == 3:
            rd.sync_eol()
            two_d = options & 1 and rd.bit() == 0
            changes = _row_2d(rd, width, ref) if two_d else \
                _row_1d(rd, width)
        else:
            changes = _row_2d(rd, width, ref)
        edges = changes + [width] * (len(changes) & 1)
        for a, b in zip(edges[::2], edges[1::2]):
            out[y, a:b] = 1
        ref = changes
    return np.packbits(out, axis=1).tobytes()
