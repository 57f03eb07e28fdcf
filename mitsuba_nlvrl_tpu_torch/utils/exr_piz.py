"""PIZ decompression for OpenEXR files (the port's copy of
``mitsuba_nlvrl_tpu/utils/exr_piz.py``).

Pure-python implementation of the standard OpenEXR PIZ codec's decode path
(public algorithm: bitmap LUT + canonical Huffman coding of 16-bit symbols
with run-length escapes + 2D Haar-style wavelet), so reference assets
(envmap.exr, golden renders) load without the OpenEXR C++ library.
"""
from __future__ import annotations

import struct

import numpy as np

_HUF_ENCBITS = 16
_HUF_ENCSIZE = (1 << _HUF_ENCBITS) + 1
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN

_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


class _BitReader:
    __slots__ = ('data', 'pos', 'c', 'lc')

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def get_bits(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _unpack_enc_table(br: _BitReader, im: int, iM: int):
    """Read RLE-packed 6-bit code lengths (ImfHuf hufUnpackEncTable)."""
    hcode = np.zeros(_HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get_bits(6)
        if l == _LONG_ZEROCODE_RUN:
            zerun = br.get_bits(8) + _SHORTEST_LONG_RUN
            i += zerun
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            hcode[i] = l
            i += 1
    return hcode


def _canonical_codes(hcode: np.ndarray) -> np.ndarray:
    """Assign canonical codes; returns packed (code << 6) | length."""
    n = np.zeros(59, np.int64)
    lens = hcode.astype(np.int64)
    cnt = np.bincount(lens, minlength=59)
    n[:len(cnt[:59])] = cnt[:59]
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    out = lens.copy()
    # assign codes in symbol order per length
    for i in range(_HUF_ENCSIZE):
        l = lens[i]
        if l > 0:
            out[i] = l | (n[l] << 6)
            n[l] += 1
    return out


def _huf_decode(packed: np.ndarray, data: bytes, start_pos: int,
                n_bits: int, rlc: int, n_out: int) -> np.ndarray:
    """Bit-serial canonical Huffman decode with the RLE escape symbol
    (ImfHuf hufDecode); starts byte-aligned at ``start_pos`` (the packed
    code-length table is padded to a byte boundary)."""
    lens = (packed & 63).astype(np.int64)
    codes = (packed >> 6).astype(np.int64)
    table = {}
    for sym in np.nonzero(lens)[0]:
        table[(int(lens[sym]), int(codes[sym]))] = int(sym)

    out = np.zeros(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    pos = start_pos
    consumed = 0
    cur = 0
    curlen = 0
    get = table.get
    nd = len(data)
    while oi < n_out and consumed < n_bits:
        if lc == 0:
            if pos >= nd:
                break
            c = data[pos]
            pos += 1
            lc = 8
        lc -= 1
        cur = (cur << 1) | ((c >> lc) & 1)
        curlen += 1
        consumed += 1
        sym = get((curlen, cur))
        if sym is not None:
            if sym == rlc:
                run = 0
                for _ in range(8):
                    if lc == 0:
                        c = data[pos]
                        pos += 1
                        lc = 8
                    lc -= 1
                    run = (run << 1) | ((c >> lc) & 1)
                    consumed += 1
                prev = out[oi - 1] if oi else 0
                out[oi:oi + run] = prev
                oi += run
            else:
                out[oi] = sym
                oi += 1
            cur = 0
            curlen = 0
    return out


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int64)
    hi = h.astype(np.int16).astype(np.int64)
    ai = ls + (hi & 1) + (hi >> 1)
    a = ai.astype(np.int16).astype(np.uint16)
    b = (ai - hi).astype(np.int16).astype(np.uint16)
    return a, b


def _wdec16(l, h):
    mm = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (mm - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(a: np.ndarray, nx: int, ox: int, ny: int, oy: int,
                 mx: int):
    """2D wavelet decode in place over a flat uint16 array (ImfWav
    wav2Decode), vectorized per level with numpy strides."""
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            iy = ys[:, None] * oy + xs[None, :] * ox
            i01 = iy + ox * p
            i10 = iy + oy * p
            i11 = i10 + ox * p
            v00, v10 = dec(a[iy], a[i10])
            v01, v11 = dec(a[i01], a[i11])
            r00, r01 = dec(v00, v01)
            r10, r11 = dec(v10, v11)
            a[iy] = r00
            a[i01] = r01
            a[i10] = r10
            a[i11] = r11
            if nx & p:
                # odd last column
                px = ys * oy + ox * (len(xs) * p2)
                p10 = px + oy * p
                v00, v10 = dec(a[px], a[p10])
                a[px] = v00
                a[p10] = v10
        if ny & p:
            py = oy * (len(ys) * p2)
            px = py + xs * ox
            p01 = px + ox * p
            v00, v01 = dec(a[px], a[p01])
            a[px] = v00
            a[p01] = v01
            if nx & p:
                i = py + ox * (len(xs) * p2)
                # single corner element: nothing paired
        p2 = p
        p >>= 1


def piz_uncompress(block: bytes, channels, nx: int, ny: int) -> dict:
    """Decompress one PIZ block.

    channels: list of (name, pixel_type) in file order; pixel_type 1=half,
    2=float. Returns {name: (ny, nx*size) uint16 array} channel-major.
    """
    pos = 0
    min_nz, max_nz = struct.unpack_from('<HH', block, pos)
    pos += 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        nbytes = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(block, np.uint8, nbytes,
                                                  pos)
        pos += nbytes
    # reverse LUT
    bits = np.unpackbits(bitmap, bitorder='little')
    bits[0] = 1
    lut = np.nonzero(bits[:65536])[0].astype(np.uint16)
    max_value = len(lut) - 1

    (length,) = struct.unpack_from('<i', block, pos)
    pos += 4
    huf = block[pos:pos + length]

    im, iM, table_len, n_bits, _room = struct.unpack_from('<IIIII', huf, 0)
    br = _BitReader(huf, 20)
    hcode = _unpack_enc_table(br, im, iM)
    packed = _canonical_codes(hcode)

    sizes = {1: 1, 2: 2, 0: 2}          # shorts per pixel (half=1, float=2)
    total = sum(nx * ny * sizes[pt] for _, pt in channels)
    data = _huf_decode(packed, huf, br.pos, n_bits, iM, total)

    # per-channel wavelet decode
    out = {}
    off = 0
    for name, pt in channels:
        size = sizes[pt]
        cnt = nx * ny * size
        chan = data[off:off + cnt].copy()
        for j in range(size):
            _wav2_decode(chan[j:], nx, size, ny, nx * size, max_value)
        # apply LUT
        chan = lut[chan]
        out[name] = chan.reshape(ny, nx * size)
        off += cnt
    return out
