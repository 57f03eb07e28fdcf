"""A WebP lossy (VP8 key frame, RFC 6386) decoder without PIL: the frame
header in Python; every macroblock's modes, tokens, reconstruction and
loop filter (``_macroblocks``), then the upsampling and YUV to RGB
(``yuv_to_rgb``), in host C++ (``native/bitmap_vp8.cpp``), each beside
its numpy twin (``_macroblocks_plain``, ``yuv_to_rgb_plain``), which the
tests hold it to.

Decodes a ``VP8 `` chunk as libwebp does, to the same RGB bytes that
libwebp hands PIL: the boolean decoder; the frame header (segmentation
with its map, quantizer and filter-strength updates, loop-filter deltas,
1, 2, 4 or 8 token partitions, coefficient probability updates, the skip
probability); dequantisation with the Y2 special cases; intra prediction
(16x16 DC, V, H and TM; the ten 4x4 modes, the right-hand subblocks
taking the macroblock's above-right pixels; 8x8 chroma) from unfiltered
neighbours; the inverse Walsh-Hadamard and DCT transforms; the normal and
simple loop filters in macroblock order; then 4:2:0 to RGB by libwebp's
"fancy" upsampling and its fixed-point ``VP8YUVToR/G/B``. Where libwebp
departs from the RFC it is followed: the filter type is the header's bit
(the profile only has to be 0-3), a frame whose filter level is 0 is not
filtered whatever its segments say, and running out of data raises
``OSError`` (libwebp's premature end of partition) rather than reading
zeros.
"""
from __future__ import annotations

import numpy as np

# RFC 6386's kf_bmode_probs, in libwebp's order of the 4x4 modes
# (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU): [above][left][9]
_BMODES_PROBA = bytes.fromhex(
    'e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabda'
    'bd110d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa'
    '2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265'
    '6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b'
    '1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330f'
    'ba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7'
    '75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a62'
    '40221674ce17222ba6496b36201a3301512b1f44196a1640ab24e17222131566'
    '84bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f'
    '70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b43'
    '2d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33'
    '3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6'
    '5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e'
    '16188001361125412049731c801780cd2803097333c01206df572509733b4d40'
    '152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a'
    '8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b'
    '33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58'
    '685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931'
    '26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a55'
    '8065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c045'
    '3c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3'
    '55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808'
    '118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f'
    '069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527'
    '9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404'
    'f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b'
    '769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e'
    '9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc3'
    '80300418')
# default_coeff_probs and coeff_update_probs: [type][band][ctx][11]
_COEFFS_PROBA0 = bytes.fromhex(
    '8080808080808080808080808080808080808080808080808080808080808080'
    '80fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff80'
    '80800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb'
    '80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680'
    '808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ff'
    'ffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3'
    'ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff'
    'c2e080808080800101ff8080808080808080f601ff8080808080808080ff8080'
    '8080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f'
    '92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc780808051'
    '63b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080'
    '175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080'
    '802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff80'
    '80801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080'
    '808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff'
    'ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff80'
    '80808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1'
    'b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa'
    'd3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933db'
    'ffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5'
    'f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be'
    '24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080'
    'f7c0ff8080808080808080f080ff80808080808080800186fcffff8080808080'
    '80d53efaffff808080808080375dff8080808080808080808080808080808080'
    '808080808080808080808080808080808080808080808080ca18d5ebbabfdca0'
    'f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff7'
    '9fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7'
    'f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db'
    'f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fc'
    'cccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8'
    'ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179'
    'ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd80808001'
    '01ff8080808080808080f401ff8080808080808080ee01ff8080808080808080')
_COEFFS_UPDATE = bytes.fromhex(
    'ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff'
    'ffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffff'
    'fffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff'
    'fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffff'
    'fffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffff'
    'fffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff'
    'fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff'
    'ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff'
    'ffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa'
    'f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffee'
    'fdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff'
    'fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff'
    'fffffffffffffffffffffffffffdfefffffffffffffffffcffffffffffffffff'
    'fffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff'
    'fffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff'
    'fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffff'
    'ffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feff'
    'fffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff'
    'fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefe'
    'fffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefe'
    'fffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe'
    'ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff'
    'ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff'
    'ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff'
    'fffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff'
    'fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffff'
    'fffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff'
    'fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff'
    'fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdff'
    'fffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff'
    'fffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffffffff'
    'fdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffff'
    'fffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff')
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20,
    20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67,
    68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84,
    85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108,
    110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138,
    140, 143, 145, 148, 151, 154, 157)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170,
    173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225,
    229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135),
            (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 mode tree: node i's two branches (a leaf holds -mode; DC is 0)
_YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8,
                  -8, -9)
DC, TM, VE, HE = 0, 1, 2, 3


# the normalising shift of a range of 1-255
_SHIFT = bytes([0] + [8 - n.bit_length() for n in range(1, 256)])


class BoolDecoder:
    """RFC 6386's boolean entropy decoder, in libwebp's form: the range is
    kept less one; loading past the last byte is the premature end
    libwebp reports, and raises ``OSError``. ``bit(prob)`` reads one
    bool (a closure, for speed); ``state()`` is (value, bits, range - 1,
    the next byte), where the native decoder takes over."""

    def __init__(self, data: bytes):
        value, bits, rng, pos, end = 0, -8, 254, 0, len(data)
        self.data = data

        def bit(prob: int) -> int:
            nonlocal value, bits, rng, pos
            if bits < 0:
                n = min(7, end - pos)
                if n <= 0:
                    raise OSError("premature end of a VP8 partition")
                value = (value << (8 * n)) | int.from_bytes(
                    data[pos:pos + n], 'big')
                bits += 8 * n
                pos += n
            split = (rng * prob) >> 8
            if (value >> bits) > split:
                r = rng - split
                value -= (split + 1) << bits
                s = _SHIFT[r]
                rng = (r << s) - 1
                bits -= s
                return 1
            r = split + 1
            s = _SHIFT[r]
            rng = (r << s) - 1
            bits -= s
            return 0
        self.bit = bit
        self.state = lambda: (value, bits, rng, pos)

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v

    def flag_value(self, n: int, signed: bool = False, default: int = 0):
        """A value behind a flag bit (``default`` when the flag is 0)."""
        if not self.bit(0x80):
            return default
        return self.signed(n) if signed else self.value_bits(n)


def _large(bit, p) -> int:
    """A coefficient's magnitude past 1 (the token tree's right side)."""
    if not bit(p[3]):
        if not bit(p[4]):
            return 2
        return 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        return 7 + 2 * bit(165) + bit(145)
    b1 = bit(p[8])
    cat = 2 * b1 + bit(p[9 + b1])
    v = 0
    for prob in _CAT3456[cat]:
        v = v + v + bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(bit, bands, ctx: int, dq0: int, dq1: int, n: int, out: list,
            off: int) -> int:
    """One block's tokens from position ``n``, dequantised into ``out``
    at ``off`` in raster order; returns libwebp's count (the position
    after the last non-zero coefficient, 16 after a run of zeros to the
    end)."""
    p = bands[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n
        while not bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not bit(p[2]):
            v = 1
            p = bands[n + 1][1]
        else:
            v = _large(bit, p)
            p = bands[n + 1][2]
        if bit(0x80):
            v = -v
        out[off + _ZIGZAG[n]] = v * (dq1 if n else dq0)
        n += 1
    return 16


def _i16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _wht(dc: list) -> list:
    """The inverse Walsh-Hadamard transform of the Y2 block: the 16 DC
    coefficients of the luma blocks."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[3 + 4 * i]
        a1 = tmp[1 + 4 * i] + tmp[2 + 4 * i]
        a2 = tmp[1 + 4 * i] - tmp[2 + 4 * i]
        a3 = d - tmp[3 + 4 * i]
        out[4 * i:4 * i + 4] = [_i16((a0 + a1) >> 3), _i16((a3 + a2) >> 3),
                                _i16((a0 - a1) >> 3), _i16((a3 - a2) >> 3)]
    return out


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """libwebp's inverse DCT of (..., 16) raster coefficients to (..., 4,
    4) residuals, each added to its prediction and clipped."""
    c = c.reshape(c.shape[:-1] + (4, 4)).astype(np.int32)
    a = c[..., 0, :] + c[..., 2, :]
    b = c[..., 0, :] - c[..., 2, :]
    cc = _mul2(c[..., 1, :]) - _mul1(c[..., 3, :])
    d = _mul1(c[..., 1, :]) + _mul2(c[..., 3, :])
    t = np.stack([a + d, b + cc, b - cc, a - d], -2)   # [k][column]
    dc = t[..., 0] + 4
    a = dc + t[..., 2]
    b = dc - t[..., 2]
    cc = _mul2(t[..., 1]) - _mul1(t[..., 3])
    d = _mul1(t[..., 1]) + _mul2(t[..., 3])
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3


# --- intra prediction on libwebp's work buffer ----------------------------
# A macroblock's luma is predicted in a buffer of 17 rows of 21 (the row
# above, the column to the left and four above-right pixels), its chroma
# in two of 9 x 9; ``o`` is the index of the block's top-left pixel.
_YB, _CB = 21, 9


# clip(v) at index v + 255, for v in -255..510
_CLIP = [0] * 255 + list(range(256)) + [255] * 255


def _clip(v: int) -> int:
    return _CLIP[v + 255]


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(buf: list, o: int, mode: int) -> list:
    """The 16 pixels (rows of 4) of a 4x4 intra mode at ``o``."""
    B = _YB
    t = o - B
    if mode == DC:
        v = (sum(buf[t:t + 4]) + sum(buf[o - 1 + y * B] for y in range(4))
             + 4) >> 3
        return [v] * 16
    if mode == TM:
        tl = buf[t - 1]
        return [_clip(buf[t + x] + buf[o - 1 + y * B] - tl)
                for y in range(4) for x in range(4)]
    if mode == VE:
        top = buf[t - 1:t + 5]
        return [_avg3(top[x], top[x + 1], top[x + 2]) for x in range(4)] * 4
    X = buf[t - 1]
    A, Bt, C, D, E, F, G, H = buf[t:t + 8]
    I, J, K, L = (buf[o - 1 + y * B] for y in range(4))
    if mode == HE:
        rows = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                _avg3(K, L, L))
        return [v for v in rows for _ in range(4)]
    d = [0] * 16

    def s(x, y, v):
        d[4 * y + x] = v
    if mode == 4:                                            # RD
        s(0, 3, _avg3(J, K, L))
        v = _avg3(I, J, K); s(1, 3, v); s(0, 2, v)
        v = _avg3(X, I, J); s(2, 3, v); s(1, 2, v); s(0, 1, v)
        v = _avg3(A, X, I); s(3, 3, v); s(2, 2, v); s(1, 1, v); s(0, 0, v)
        v = _avg3(Bt, A, X); s(3, 2, v); s(2, 1, v); s(1, 0, v)
        v = _avg3(C, Bt, A); s(3, 1, v); s(2, 0, v)
        s(3, 0, _avg3(D, C, Bt))
    elif mode == 5:                                          # VR
        v = _avg2(X, A); s(0, 0, v); s(1, 2, v)
        v = _avg2(A, Bt); s(1, 0, v); s(2, 2, v)
        v = _avg2(Bt, C); s(2, 0, v); s(3, 2, v)
        s(3, 0, _avg2(C, D))
        s(0, 3, _avg3(K, J, I))
        s(0, 2, _avg3(J, I, X))
        v = _avg3(I, X, A); s(0, 1, v); s(1, 3, v)
        v = _avg3(X, A, Bt); s(1, 1, v); s(2, 3, v)
        v = _avg3(A, Bt, C); s(2, 1, v); s(3, 3, v)
        s(3, 1, _avg3(Bt, C, D))
    elif mode == 6:                                          # LD
        s(0, 0, _avg3(A, Bt, C))
        v = _avg3(Bt, C, D); s(1, 0, v); s(0, 1, v)
        v = _avg3(C, D, E); s(2, 0, v); s(1, 1, v); s(0, 2, v)
        v = _avg3(D, E, F); s(3, 0, v); s(2, 1, v); s(1, 2, v); s(0, 3, v)
        v = _avg3(E, F, G); s(3, 1, v); s(2, 2, v); s(1, 3, v)
        v = _avg3(F, G, H); s(3, 2, v); s(2, 3, v)
        s(3, 3, _avg3(G, H, H))
    elif mode == 7:                                          # VL
        s(0, 0, _avg2(A, Bt))
        v = _avg2(Bt, C); s(1, 0, v); s(0, 2, v)
        v = _avg2(C, D); s(2, 0, v); s(1, 2, v)
        v = _avg2(D, E); s(3, 0, v); s(2, 2, v)
        s(0, 1, _avg3(A, Bt, C))
        v = _avg3(Bt, C, D); s(1, 1, v); s(0, 3, v)
        v = _avg3(C, D, E); s(2, 1, v); s(1, 3, v)
        v = _avg3(D, E, F); s(3, 1, v); s(2, 3, v)
        s(3, 2, _avg3(E, F, G))
        s(3, 3, _avg3(F, G, H))
    elif mode == 8:                                          # HD
        v = _avg2(I, X); s(0, 0, v); s(2, 1, v)
        v = _avg2(J, I); s(0, 1, v); s(2, 2, v)
        v = _avg2(K, J); s(0, 2, v); s(2, 3, v)
        s(0, 3, _avg2(L, K))
        s(3, 0, _avg3(A, Bt, C))
        s(2, 0, _avg3(X, A, Bt))
        v = _avg3(I, X, A); s(1, 0, v); s(3, 1, v)
        v = _avg3(J, I, X); s(1, 1, v); s(3, 2, v)
        v = _avg3(K, J, I); s(1, 2, v); s(3, 3, v)
        s(1, 3, _avg3(L, K, J))
    else:                                                    # HU
        s(0, 0, _avg2(I, J))
        v = _avg2(J, K); s(2, 0, v); s(0, 1, v)
        v = _avg2(K, L); s(2, 1, v); s(0, 2, v)
        s(1, 0, _avg3(I, J, K))
        v = _avg3(J, K, L); s(3, 0, v); s(1, 1, v)
        v = _avg3(K, L, L); s(3, 1, v); s(1, 2, v)
        for x, y in ((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)):
            s(x, y, L)
    return d


def _pred_block(buf: list, bps: int, size: int, mode: int, mb_x: int,
                mb_y: int) -> list:
    """A 16x16 luma or 8x8 chroma prediction (rows of ``size``); DC at
    the frame's top or left edge averages what is there, as in libwebp."""
    o = bps + 1
    top = buf[1:1 + size]
    left = [buf[o - 1 + y * bps] for y in range(size)]
    sh = size.bit_length() - 1                     # log2(size)
    if mode == DC:
        if mb_x and mb_y:
            v = (sum(top) + sum(left) + size) >> (sh + 1)
        elif mb_y:                                 # no left
            v = (sum(top) + (size >> 1)) >> sh
        elif mb_x:                                 # no top
            v = (sum(left) + (size >> 1)) >> sh
        else:
            v = 0x80
        return [v] * (size * size)
    if mode == VE:
        return top * size
    if mode == HE:
        return [v for v in left for _ in range(size)]
    tl = buf[0]
    return [_clip(t + v - tl) for v in left for t in top]


def _probas(br: BoolDecoder) -> list:
    """The coefficient probabilities after the frame's updates, as
    [type][position 0-16][ctx] -> 11 probabilities (a position's band
    looked up once)."""
    out = []
    for t in range(4):
        bands = []
        for b in range(8):
            ctxs = []
            for c in range(3):
                o = ((t * 8 + b) * 3 + c) * 11
                ctxs.append([br.value_bits(8) if br.bit(_COEFFS_UPDATE[o + p])
                             else _COEFFS_PROBA0[o + p] for p in range(11)])
            bands.append(ctxs)
        out.append([bands[_BANDS[n]] for n in range(17)])
    return out


def _filter_strengths(seg, level, sharpness, ref_delta, mode_delta,
                      use_delta) -> list:
    """libwebp's per-segment, per-(i16, i4) filter parameters: (limit,
    interior limit, hev threshold), limit 0 meaning no filtering."""
    out = []
    for s in range(4):
        if seg['use']:
            base = seg['filter'][s] + (0 if seg['absolute'] else level)
        else:
            base = level
        row = []
        for i4 in (0, 1):
            lv = base
            if use_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4 else 0)
            lv = min(max(lv, 0), 63)
            if lv == 0:
                row.append((0, 0, 0))
                continue
            il = lv
            if sharpness > 0:
                il >>= 2 if sharpness > 4 else 1
                il = min(il, 9 - sharpness)
            il = max(il, 1)
            row.append((2 * lv + il, il, 2 if lv >= 40 else
                        1 if lv >= 15 else 0))
        out.append(row)
    return out


def _quant(br: BoolDecoder, seg) -> list:
    """Each segment's (y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac)."""
    q0 = br.value_bits(7)
    dy1, dy2dc, dy2ac, duvdc, duvac = (br.flag_value(4, True)
                                       for _ in range(5))
    out = []
    for s in range(4):
        if seg['use']:
            q = seg['quant'][s] + (0 if seg['absolute'] else q0)
        else:
            q = q0

        def clip(v, m=127):
            return min(max(v, 0), m)
        out.append((_DC_TABLE[clip(q + dy1)], _AC_TABLE[clip(q)],
                    _DC_TABLE[clip(q + dy2dc)] * 2,
                    max((_AC_TABLE[clip(q + dy2ac)] * 101581) >> 16, 8),
                    _DC_TABLE[clip(q + duvdc, 117)],
                    _AC_TABLE[clip(q + duvac)]))
    return out


def _residuals(bit, probas, q, is_i4, top, left, coef) -> int:
    """One macroblock's tokens (libwebp's ``ParseResiduals``): the
    dequantised coefficients of its 16 luma and 8 chroma blocks into
    ``coef`` (384, raster order in each), the non-zero contexts above
    (``top``) and to the left (``left``) updated: [bits, dc]. Returns
    whether every block came out empty."""
    y1dc, y1ac, y2dc, y2ac, uvdc, uvac = q
    nz_any = 0
    if not is_i4:
        dc = [0] * 16
        nz = _coeffs(bit, probas[1], top[1] + left[1], y2dc, y2ac, 0, dc, 0)
        top[1] = left[1] = int(nz > 0)
        dc = [_i16(v) for v in dc]
        if nz > 1:
            w = _wht(dc)
        else:
            w = [(dc[0] + 3) >> 3] * 16
        for k in range(16):
            coef[16 * k] = w[k]
        first, ac = 1, probas[0]
    else:
        first, ac = 0, probas[3]
    tnz, lnz = top[0] & 0x0F, left[0] & 0x0F
    for y in range(4):
        lb = lnz & 1
        for x in range(4):
            off = 64 * y + 16 * x
            nz = _coeffs(bit, ac, lb + (tnz & 1), y1dc, y1ac, first, coef,
                         off)
            lb = int(nz > first)
            tnz = (tnz >> 1) | (lb << 7)
            nz_any |= nz > 1 or coef[off] != 0
        tnz >>= 4
        lnz = (lnz >> 1) | (lb << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz, lnz = top[0] >> (4 + ch), left[0] >> (4 + ch)
        for y in range(2):
            lb = lnz & 1
            for x in range(2):
                off = 256 + 32 * ch + 32 * y + 16 * x
                nz = _coeffs(bit, probas[2], lb + (tnz & 1), uvdc, uvac, 0,
                             coef, off)
                lb = int(nz > 0)
                tnz = (tnz >> 1) | (lb << 3)
                nz_any |= nz > 1 or coef[off] != 0
            tnz >>= 2
            lnz = (lnz >> 1) | (lb << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    top[0], left[0] = out_t, out_l
    return not nz_any


def _frame(data: bytes):
    """The frame header and partitions: (width, height, partition 0's
    decoder past the header, token partitions, header fields)."""
    if len(data) < 10:
        raise OSError("truncated VP8 frame")
    bits = data[0] | data[1] << 8 | data[2] << 16
    part0 = bits >> 5
    if bits & 1:
        raise OSError("VP8 frame is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise OSError("VP8 profile above 3")
    if not (bits >> 4) & 1:
        raise OSError("VP8 frame not displayable")
    if data[3:6] != b'\x9d\x01\x2a':
        raise OSError("bad VP8 start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if not w or not h:
        raise OSError("VP8 frame of no pixels")
    buf = data[10:]
    if part0 > len(buf):
        raise OSError("bad VP8 partition length")
    br = BoolDecoder(buf[:part0])
    rest = buf[part0:]
    br.bit(0x80)                                 # colour space
    br.bit(0x80)                                 # clamping type
    seg = {'use': br.bit(0x80), 'map': 0, 'absolute': 1,
           'quant': [0] * 4, 'filter': [0] * 4, 'probs': [255] * 3}
    if seg['use']:
        seg['map'] = br.bit(0x80)
        if br.bit(0x80):
            seg['absolute'] = br.bit(0x80)
            seg['quant'] = [br.flag_value(7, True) for _ in range(4)]
            seg['filter'] = [br.flag_value(6, True) for _ in range(4)]
        if seg['map']:
            seg['probs'] = [br.flag_value(8, default=255) for _ in range(3)]
    simple = br.bit(0x80)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    use_delta = br.bit(0x80)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    if use_delta and br.bit(0x80):
        for d in (ref_delta, mode_delta):
            for i in range(4):
                if br.bit(0x80):
                    d[i] = br.signed(6)
    nparts = 1 << br.value_bits(2)
    if len(rest) < 3 * (nparts - 1):
        raise OSError("truncated VP8 partition sizes")
    start, parts = 3 * (nparts - 1), []
    for p in range(nparts - 1):
        size = min(int.from_bytes(rest[3 * p:3 * p + 3], 'little'),
                   len(rest) - start)
        parts.append(rest[start:start + size])
        start += size
    if start >= len(rest):
        raise OSError("truncated VP8 partitions")
    parts.append(rest[start:])
    quant = _quant(br, seg)
    br.bit(0x80)                                 # refresh entropy probs
    probas = _probas(br)
    skip_p = br.flag_value(8, default=-1)
    filt = 0 if level == 0 else 1 if simple else 2
    fstr = _filter_strengths(seg, level, sharpness, ref_delta, mode_delta,
                             use_delta) if filt else None
    return w, h, br, parts, seg, quant, probas, skip_p, filt, fstr


def _modes(br: BoolDecoder, mbw: int, mbh: int, seg, skip_p: int) -> list:
    """Each macroblock's (segment, skip, 4x4 modes or None, 16x16 mode,
    chroma mode), read from partition 0 in raster order."""
    out = []
    top = [DC] * (4 * mbw)
    sp = seg['probs']
    for _ in range(mbh):
        left = [DC] * 4
        for mx in range(mbw):
            s = 0
            if seg['map']:
                s = br.bit(sp[1]) if not br.bit(sp[0]) else 2 + br.bit(sp[2])
            skip = br.bit(skip_p) if skip_p >= 0 else 0
            if br.bit(145):                             # 16x16
                ymode = (TM if br.bit(128) else HE) if br.bit(156) else \
                    (VE if br.bit(163) else DC)
                top[4 * mx:4 * mx + 4] = [ymode] * 4
                left = [ymode] * 4
                imodes = None
            else:
                imodes = []
                for y in range(4):
                    ym = left[y]
                    for x in range(4):
                        o = (top[4 * mx + x] * 10 + ym) * 9
                        i = _YMODES_INTRA4[br.bit(_BMODES_PROBA[o])]
                        while i > 0:
                            i = _YMODES_INTRA4[2 * i + br.bit(
                                _BMODES_PROBA[o + i])]
                        ym = -i
                        top[4 * mx + x] = ym
                        imodes.append(ym)
                    left[y] = ym
            uv = DC if not br.bit(142) else VE if not br.bit(114) else \
                TM if br.bit(183) else HE
            out.append((s, skip, imodes, None if imodes else ymode, uv))
    return out


def _reconstruct(modes, coefs, mbw: int, mbh: int):
    """Intra prediction plus residuals, macroblock by macroblock, in
    libwebp's work buffers: the unfiltered (Y, U, V) planes as lists of
    rows."""
    W, CW = 16 * mbw, 8 * mbw
    Y = [[0] * W for _ in range(16 * mbh)]
    U = [[0] * CW for _ in range(8 * mbh)]
    V = [[0] * CW for _ in range(8 * mbh)]
    # residuals past +-255 clip alike once added to a prediction
    res = np.clip(_idct(coefs), -255, 255)            # (mb, 24, 4, 4)
    n = res.shape[0]
    # the same as whole 16x16 and 8x8 blocks, rows of pixels
    res_y = res[:, :16].reshape(n, 4, 4, 4, 4).transpose(
        0, 1, 3, 2, 4).reshape(n, 16, 16)
    res_c = res[:, 16:].reshape(n, 2, 2, 2, 4, 4).transpose(
        0, 1, 2, 4, 3, 5).reshape(n, 2, 8, 8)
    cl = _CLIP
    for mb_y in range(mbh):
        for mb_x in range(mbw):
            k = mb_y * mbw + mb_x
            _, _, imodes, ymode, uvmode = modes[k]
            y0, x0 = 16 * mb_y, 16 * mb_x
            # the luma buffer: row -1 (with four above-right pixels), then
            # each row's left neighbour and 16 pixels
            b = [0] * (17 * _YB)
            if mb_y:
                above = Y[y0 - 1]
                b[0] = above[x0 - 1] if mb_x else 129
                b[1:17] = above[x0:x0 + 16]
                b[17:21] = above[x0 + 16:x0 + 20] if mb_x < mbw - 1 else \
                    [above[x0 + 15]] * 4
            else:
                b[0:21] = [127] * 21
            for j in range(16):
                b[(j + 1) * _YB] = Y[y0 + j][x0 - 1] if mb_x else 129
            if imodes is not None:
                r = res[k, :16].reshape(16, 16).tolist()
                for j in (3, 7, 11):               # above-right, replicated
                    b[(j + 1) * _YB + 17:(j + 1) * _YB + 21] = b[17:21]
                for i in range(16):
                    o = (4 * (i >> 2) + 1) * _YB + 4 * (i & 3) + 1
                    p = _pred4(b, o, imodes[i])
                    ri = r[i]
                    for yy in range(0, 16, 4):
                        q = o + (yy >> 2) * _YB
                        b[q:q + 4] = [cl[p[yy] + ri[yy] + 255],
                                      cl[p[yy + 1] + ri[yy + 1] + 255],
                                      cl[p[yy + 2] + ri[yy + 2] + 255],
                                      cl[p[yy + 3] + ri[yy + 3] + 255]]
                for j in range(16):
                    q = (j + 1) * _YB + 1
                    Y[y0 + j][x0:x0 + 16] = b[q:q + 16]
            else:
                p = _pred_block(b, _YB, 16, ymode, mb_x, mb_y)
                for j, rr in enumerate(res_y[k].tolist()):
                    Y[y0 + j][x0:x0 + 16] = [cl[v + 255] for v in map(
                        int.__add__, p[16 * j:16 * j + 16], rr)]
            c0, cx = 8 * mb_y, 8 * mb_x
            for plane, rc in zip((U, V), res_c[k].tolist()):
                b = [0] * (9 * _CB)
                if mb_y:
                    above = plane[c0 - 1]
                    b[0] = above[cx - 1] if mb_x else 129
                    b[1:9] = above[cx:cx + 8]
                else:
                    b[0:9] = [127] * 9
                for j in range(8):
                    b[(j + 1) * _CB] = plane[c0 + j][cx - 1] if mb_x else 129
                p = _pred_block(b, _CB, 8, uvmode, mb_x, mb_y)
                for j, rr in enumerate(rc):
                    plane[c0 + j][cx:cx + 8] = [cl[v + 255] for v in map(
                        int.__add__, p[8 * j:8 * j + 8], rr)]
    return Y, U, V


# --- the loop filter -------------------------------------------------------
def _filter_lines(p: np.ndarray, thresh: np.ndarray, ilevel: np.ndarray,
                  hev_t: np.ndarray, kind: str) -> None:
    """libwebp's edge filters on gathered lines ``p`` (..., 8): the
    pixels p3 p2 p1 p0 | q0 q1 q2 q3 across the edge, in place. ``kind``:
    'simple', 'mb' (macroblock edge: 2 taps where the edge variance is
    high, else 6) or 'inner' (2 taps, else 4). Thresholds broadcast over
    the lines."""
    p3, p2, p1, p0, q0, q1, q2, q3 = p.T
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind == 'simple':
        hev = mask
    else:
        mask &= (np.abs(p3 - p2) <= ilevel) & (np.abs(p2 - p1) <= ilevel) \
            & (np.abs(p1 - p0) <= ilevel) & (np.abs(q3 - q2) <= ilevel) \
            & (np.abs(q2 - q1) <= ilevel) & (np.abs(q1 - q0) <= ilevel)
        hev = mask & ((np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t))
    new = p.copy()
    # two taps (simple filter, or high edge variance)
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    new[..., 3] = np.where(hev, np.clip(p0 + a2, 0, 255), new[..., 3])
    new[..., 4] = np.where(hev, np.clip(q0 - a1, 0, 255), new[..., 4])
    if kind != 'simple':
        rest = mask & ~hev
        if kind == 'mb':
            a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127),
                        -128, 127)
            a1 = (27 * a + 63) >> 7
            a2 = (18 * a + 63) >> 7
            a3 = (9 * a + 63) >> 7
            for i, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1),
                         (4, q0 - a1), (5, q1 - a2), (6, q2 - a3)):
                new[..., i] = np.where(rest, np.clip(v, 0, 255), new[..., i])
        else:
            a = 3 * (q0 - p0)
            a1 = np.clip((a + 4) >> 3, -16, 15)
            a2 = np.clip((a + 3) >> 3, -16, 15)
            a3 = (a1 + 1) >> 1
            for i, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1),
                         (5, q1 - a3)):
                new[..., i] = np.where(rest, np.clip(v, 0, 255), new[..., i])
    p[...] = new


def _lines(base: int, stride: int, y0, x0, size: int, off: int,
           vertical: bool) -> np.ndarray:
    """Flat indices (lines, 8) of the pixels across one edge of each
    listed block of ``size`` at (y0, x0) in a plane that starts at
    ``base`` with rows of ``stride``: the edge ``off`` pixels in, across
    columns (a vertical edge) or rows."""
    j = np.arange(size)[None, :, None]
    taps = np.arange(-4, 4)[None, None, :]
    y0, x0 = y0[:, None, None], x0[:, None, None]
    if vertical:
        idx = base + (y0 + j) * stride + x0 + off + taps
    else:
        idx = base + (y0 + off + taps) * stride + x0 + j
    return idx.reshape(-1, 8)


def _loop_filter(Y, U, V, mbw, mbh, finfo, simple: bool) -> None:
    """Filter every macroblock in libwebp's order (raster; in each, the
    left edge, the inner vertical edges, the top edge, the inner
    horizontal edges), macroblocks of one anti-diagonal x + 2y at a time:
    those touch disjoint pixels, and each one's earlier neighbours are on
    earlier diagonals. The three planes are filtered in one flat buffer."""
    W, CW = Y.shape[1], U.shape[1]
    cbase = Y.size
    planes = ((0, W, 16), (cbase, CW, 8), (cbase + U.size, CW, 8))
    if simple:
        planes = planes[:1]                  # the simple filter: luma only
    buf = np.concatenate([Y.ravel(), U.ravel(), V.ravel()]).astype(np.int32)
    idx = np.arange(mbw * mbh)
    mxs, mys = idx % mbw, idx // mbw
    kinds = ('simple', 'simple') if simple else ('mb', 'inner')
    for t in range(mbw + 2 * (mbh - 1)):
        on = (mxs + 2 * mys == t) & (finfo[:, 0] > 0)
        if not on.any():
            continue
        mx, my, f = mxs[on], mys[on], finfo[on]
        inner = f[:, 3] > 0
        for vertical in (True, False):
            edge = mx > 0 if vertical else my > 0
            # the macroblock edge, then the inner edges 4, 8 and 12 in
            for off, sel, kind, extra in ((0, edge, kinds[0], 4),
                                          (4, inner, kinds[1], 0),
                                          (8, inner, kinds[1], 0),
                                          (12, inner, kinds[1], 0)):
                if not sel.any():
                    continue
                ls, prm = [], []
                for base, stride, size in planes:
                    if off >= size:
                        continue
                    ls.append(_lines(base, stride, my[sel] * size,
                                     mx[sel] * size, size, off, vertical))
                    prm.append(np.repeat(f[sel, :3], size, axis=0))
                li = np.concatenate(ls)
                prm = np.concatenate(prm)
                p = buf[li]
                _filter_lines(p, prm[:, 0] + extra, prm[:, 1], prm[:, 2],
                              kind)
                buf[li] = p
    Y[...] = buf[:cbase].reshape(Y.shape)
    U[...] = buf[cbase:cbase + U.size].reshape(U.shape)
    V[...] = buf[cbase + U.size:].reshape(V.shape)


# --- 4:2:0 to RGB ----------------------------------------------------------
def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's "fancy" upsampling of a chroma plane to h x w: each
    luma row between its two nearest chroma rows (3:1), each pixel
    between its two nearest chroma columns (3:1), as its line-pair
    upsampler rounds; the first row and an even height's last row use
    one chroma row, the first column and an even width's last column one
    chroma column."""
    c = c.astype(np.int32)
    cw = (w + 1) >> 1
    rows = np.arange(h)
    k = (rows + 1) >> 1                       # the nearer-below chroma row
    top = np.clip(k - 1, 0, None)
    cur = np.minimum(k, ((h + 1) >> 1) - 1)
    top = np.where(rows == 0, 0, top)
    cur = np.where(rows == 0, 0, cur)
    # the first row, and the last of an even height, are "top" rows of a
    # pair whose two chroma rows are the same
    last = (rows == h - 1) & (h % 2 == 0)
    top = np.where(last, cur, top)
    is_top = (rows % 2 == 1) | (rows == 0)
    T, C = c[top][:, :cw], c[cur][:, :cw]
    near, far = np.where(is_top[:, None], T, C), np.where(
        is_top[:, None], C, T)
    out = np.empty((h, w), np.int32)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    if cw > 1:
        tl, t, lft, cc = T[:, :-1], T[:, 1:], C[:, :-1], C[:, 1:]
        avg = tl + t + lft + cc + 8
        diag12 = (avg + 2 * (t + lft)) >> 3
        diag03 = (avg + 2 * (tl + cc)) >> 3
        it = is_top[:, None]
        odd = np.where(it, (diag12 + tl) >> 1, (diag03 + lft) >> 1)
        even = np.where(it, (diag03 + t) >> 1, (diag12 + cc) >> 1)
        n = (w - 1) >> 1
        out[:, 1:2 * n:2] = odd[:, :n]
        out[:, 2:2 * n + 1:2] = even[:, :n]
    if w % 2 == 0:
        out[:, w - 1] = (3 * near[:, cw - 1] + far[:, cw - 1] + 2) >> 2
    return out


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(w: int, h: int, Y, U, V) -> np.ndarray:
    """``yuv_to_rgb_plain`` in ``native/bitmap_vp8.cpp``."""
    from ..native import bitmap_library, ptr
    Y, U, V = (np.ascontiguousarray(p, np.uint8) for p in (Y, U, V))
    if Y.shape[0] < h or Y.shape[1] < w or U.shape != V.shape or \
            U.shape[0] < (h + 1) >> 1 or U.shape[1] < (w + 1) >> 1:
        raise ValueError("VP8 planes smaller than the frame")
    out = np.empty((h, w, 3), np.uint8)
    bitmap_library().mnt_vp8_yuv_rgb(ptr(Y), ptr(U), ptr(V), Y.shape[1],
                                     U.shape[1], w, h, ptr(out))
    return out


def yuv_to_rgb_plain(w: int, h: int, Y, U, V) -> np.ndarray:
    """(h, w, 3) uint8 RGB of the planes, as libwebp's fancy upsampler
    and ``VP8YUVToR/G/B`` make it (14-bit fixed point, then clipped)."""
    y = Y[:h, :w].astype(np.int32)
    u, v = _upsample(U, h, w), _upsample(V, h, w)
    yy = (y * 19077) >> 8
    r = _clip8(yy + ((v * 26149) >> 8) - 14234)
    g = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = _clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _macroblocks(br: BoolDecoder, parts: list, mbw: int, mbh: int, seg,
                 quant, probas, skip_p: int, filt: int, fstr):
    """``_macroblocks_plain`` in ``native/bitmap_vp8.cpp``: the frame's
    loop-filtered (Y, U, V) planes, uint8, from partition 0's decoder past
    the header and the token partitions; ``OSError`` where a partition
    runs out."""
    from ..native import bitmap_library, ptr
    p0 = np.frombuffer(br.data, np.uint8)
    state = np.array(br.state(), np.int64)
    body = np.frombuffer(b''.join(parts), np.uint8)
    part_off = np.concatenate([[0], np.cumsum([len(p) for p in parts])]
                              ).astype(np.int64)
    Y = np.empty((16 * mbh, 16 * mbw), np.uint8)
    U = np.empty((8 * mbh, 8 * mbw), np.uint8)
    V = np.empty_like(U)
    seg_probs = np.array(seg['probs'], np.int32)
    bmodes = np.frombuffer(_BMODES_PROBA, np.uint8)
    probas = np.array(probas, np.uint8)
    quant = np.array(quant, np.int32)
    fstr = np.array(fstr if filt else np.zeros((4, 2, 3)), np.int32)
    err = bitmap_library().mnt_vp8_frame(
        ptr(p0), p0.size, ptr(state), ptr(body), ptr(part_off), len(parts),
        mbw, mbh, seg['map'], ptr(seg_probs), skip_p, ptr(bmodes),
        ptr(probas), ptr(quant), filt, ptr(fstr), ptr(Y), ptr(U), ptr(V))
    if err:
        raise OSError("premature end of a VP8 partition")
    return Y, U, V


def _macroblocks_plain(br: BoolDecoder, parts: list, mbw: int, mbh: int,
                       seg, quant, probas, skip_p: int, filt: int, fstr):
    """The frame's macroblocks in Python and numpy, the plain version of
    ``_macroblocks``: every macroblock's modes (partition 0), then its
    tokens (its row's partition), reconstruction and the loop filter."""
    modes = _modes(br, mbw, mbh, seg, skip_p)
    coefs = np.zeros((mbw * mbh, 24, 16), np.int64)
    finfo = np.zeros((mbw * mbh, 4), np.int64)   # limit, ilevel, hev, inner
    decoders = [BoolDecoder(p) for p in parts]
    tops = [[0, 0] for _ in range(mbw)]
    for mb_y in range(mbh):
        bit = decoders[mb_y & (len(parts) - 1)].bit
        left = [0, 0]
        for mb_x in range(mbw):
            k = mb_y * mbw + mb_x
            s, skip, imodes, _, _ = modes[k]
            is_i4 = imodes is not None
            if not skip:
                coef = [0] * 384
                skip = _residuals(bit, probas, quant[s], is_i4, tops[mb_x],
                                  left, coef)
                coefs[k] = np.array(coef).reshape(24, 16)
            else:
                tops[mb_x][0] = left[0] = 0
                if not is_i4:
                    tops[mb_x][1] = left[1] = 0
            if filt:
                limit, il, hev = fstr[s][is_i4]
                finfo[k] = (limit, il, hev, int(is_i4 or not skip))
    coefs = coefs.astype(np.int16)        # as libwebp stores them
    Y, U, V = (np.array(p, np.uint8) for p in _reconstruct(
        modes, coefs, mbw, mbh))
    if filt:
        _loop_filter(Y, U, V, mbw, mbh, finfo, filt == 1)
    return Y, U, V


def decode_yuv(data: bytes):
    """A VP8 key frame (a ``VP8 `` chunk's payload) to its width, height
    and loop-filtered Y, U and V planes (uint8, padded to whole
    macroblocks)."""
    w, h, br, parts, seg, quant, probas, skip_p, filt, fstr = _frame(data)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    Y, U, V = _macroblocks(br, parts, mbw, mbh, seg, quant, probas, skip_p,
                           filt, fstr)
    return w, h, Y, U, V


def decode(data: bytes) -> np.ndarray:
    """A VP8 key frame to (H, W, 3) uint8 RGB."""
    return yuv_to_rgb(*decode_yuv(data))
