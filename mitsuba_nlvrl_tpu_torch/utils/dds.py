"""A DDS (DirectDraw Surface) decoder in numpy and the bitmap library (no
PIL): the first surface, mipmaps and further surfaces ignored.

Reads what PIL's ``DdsImagePlugin`` reads, to the same mode and samples:

  * uncompressed RGB and RGBA by bit masks (each field scaled to 8 bits
    as PIL's ``DdsRgbDecoder`` scales it, through a float division), L,
    LA and P (a 256-entry RGBA palette);
  * block-compressed ``DXT1``/``DXT3``/``DXT5``, ``BC4U``/``ATI1``,
    ``BC5U``/``ATI2`` and ``BC5S`` by FourCC, and behind a DX10 header
    BC1-BC5 (UNORM and TYPELESS; BC5 also SNORM), BC6H (UF16 and SF16),
    BC7 (UNORM, TYPELESS, SRGB) and R8G8B8A8. The blocks decode in
    ``native/bitmap_bcn.cpp`` (``_bcn``) as PIL's ``bcn`` decoder does:
    BC1's three-colour mode and its transparent index, BC2's 4-bit and
    BC3-BC5's interpolated alpha, BC6H's 14 modes with its partitions,
    its half floats clamped to [0, 1] and scaled to 8 bits, and BC7's 8
    modes with their rotations and index selection. ``_bcn_plain`` is the
    plain version the tests hold it to.

A layout PIL leaves unimplemented raises ``NotImplementedError`` with
PIL's message (PIL raises the same type), a header PIL refuses
``OSError``, and data that ends early ``OSError``.
"""
from __future__ import annotations

import struct

import numpy as np

_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PAL8 = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000


def _cc(s: bytes) -> int:
    return struct.unpack('<I', s)[0]


# FourCC -> (BCn number, PIL mode, signed)
_FOURCC = {_cc(b'DXT1'): (1, 'RGBA', False), _cc(b'DXT3'): (2, 'RGBA', False),
           _cc(b'DXT5'): (3, 'RGBA', False), _cc(b'BC4U'): (4, 'L', False),
           _cc(b'ATI1'): (4, 'L', False), _cc(b'BC5S'): (5, 'RGB', True),
           _cc(b'BC5U'): (5, 'RGB', False), _cc(b'ATI2'): (5, 'RGB', False)}
# DXGI format -> (BCn number, PIL mode, signed); 0: R8G8B8A8 raw
_DXGI = {70: (1, 'RGBA', False), 71: (1, 'RGBA', False),
         73: (2, 'RGBA', False), 74: (2, 'RGBA', False),
         76: (3, 'RGBA', False), 77: (3, 'RGBA', False),
         79: (4, 'L', False), 80: (4, 'L', False),
         82: (5, 'RGB', False), 83: (5, 'RGB', False), 84: (5, 'RGB', True),
         95: (6, 'RGB', False), 96: (6, 'RGB', True),
         97: (7, 'RGBA', False), 98: (7, 'RGBA', False),
         99: (7, 'RGBA', False), 27: (0, 'RGBA', False),
         28: (0, 'RGBA', False), 29: (0, 'RGBA', False)}
_BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}
_CHANNELS = {'RGBA': 4, 'RGB': 3, 'L': 1}


def _truncated(path):
    return OSError(f"{path}: image file is truncated")


def read_dds(path: str):
    """Read a DDS file's first surface to ``(mode, pixels, palette)`` as
    PIL opens it: ``RGB``, ``RGBA`` ((H, W, C) uint8), ``L`` ((H, W)),
    ``LA`` ((H, W, 2)) or ``P`` ((H, W) indices and a (256, 4) RGBA
    palette)."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:4] != b'DDS ':
        raise OSError(f"{path}: not a DDS file")
    if len(data) < 8 or struct.unpack_from('<I', data, 4)[0] != 124:
        raise OSError(f"{path}: unsupported DDS header size")
    if len(data) < 128:
        raise OSError(f"{path}: incomplete DDS header")
    height, width = struct.unpack_from('<2I', data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from('<3I', data, 80)
    pos = 128
    if pfflags & _DDPF_RGB:
        n = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        masks = struct.unpack_from(f'<{n}I', data, 92)
        return ('RGBA' if n == 4 else 'RGB',
                _masked(data, pos, width, height, bitcount, masks, path),
                None)
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            return 'L', _raw(data, pos, width, height, 1, path)[..., 0], None
        if bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            return 'LA', _raw(data, pos, width, height, 2, path), None
        raise OSError(f"{path}: unsupported bitcount {bitcount} for "
                      f"{pfflags}")
    if pfflags & _DDPF_PAL8:
        pal = np.frombuffer(data[pos:pos + 1024].ljust(1024, b'\0'),
                            np.uint8).reshape(256, 4)
        return 'P', _raw(data, pos + 1024, width, height, 1, path)[..., 0], \
            pal
    if not pfflags & _DDPF_FOURCC:
        raise NotImplementedError(f"Unknown pixel format flags {pfflags}")
    if fourcc == _cc(b'DX10'):
        if len(data) < 132:
            raise _truncated(path)
        dxgi = struct.unpack_from('<I', data, 128)[0]
        pos = 148
        if dxgi not in _DXGI:
            raise NotImplementedError(f"Unimplemented DXGI format {dxgi}")
        n, mode, signed = _DXGI[dxgi]
    elif fourcc in _FOURCC:
        n, mode, signed = _FOURCC[fourcc]
    else:
        raise NotImplementedError(f"Unimplemented pixel format {fourcc!r}")
    if n == 0:
        return mode, _raw(data, pos, width, height, 4, path), None
    px = _bcn(data[pos:], width, height, n, signed, path)
    px = px[..., :_CHANNELS[mode]]
    return mode, px[..., 0] if mode == 'L' else px, None


def _raw(data, pos, w, h, c, path) -> np.ndarray:
    n = w * h * c
    if pos + n > len(data):
        raise _truncated(path)
    return np.frombuffer(data, np.uint8, n, pos).reshape(h, w, c)


def _masked(data, pos, w, h, bitcount, masks, path) -> np.ndarray:
    """PIL's ``DdsRgbDecoder``: each pixel a little-endian word of
    ``bitcount // 8`` bytes (past the data's end, or of no bytes at all,
    zero: PIL reads on regardless); each field shifted down and scaled to 8 bits as
    int(field / max * 255) in double precision."""
    nb = bitcount // 8
    n = w * h
    b = np.frombuffer(data[pos:pos + n * nb].ljust(n * nb, b'\0'),
                      np.uint8).reshape(n, nb)
    words = (b.astype(np.uint64) << (8 * np.arange(nb, dtype=np.uint64))
             ).sum(axis=1, dtype=np.uint64)
    out = np.zeros((n, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if mask == 0:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = (words & np.uint64(mask)) >> np.uint64(shift)
        out[:, i] = np.trunc(v.astype(np.float64) / total * 255).astype(
            np.uint8)
    return out.reshape(h, w, len(masks))


def _bcn(src: bytes, w: int, h: int, n: int, signed: bool,
         path: str = '', blp: bool = False) -> np.ndarray:
    """The (h, w, 4) RGBA samples of the BCn blocks ``src`` (``n``
    1-7), in ``native/bitmap_bcn.cpp``; ``blp``: BC1-BC3 colours
    expanded as PIL's BLP plugin does (5 and 6 bits shifted up, without
    replicating their high bits). Fails as ``_bcn_plain`` does."""
    from ..native import bitmap_library, ptr
    bw, bh = -(-w // 4), -(-h // 4)
    need = bw * bh * _BLOCK_BYTES[n]
    if len(src) < need:
        raise _truncated(path)
    buf = np.frombuffer(src, np.uint8, need)
    out = np.empty((h, w, 4), np.uint8)
    if bitmap_library().mnt_bcn_decode(ptr(buf), buf.size, w, h, n,
                                       int(signed) | 2 * int(blp),
                                       ptr(out)):
        raise _truncated(path)
    return out


# --- the plain version -------------------------------------------------------

def _565(c, blp=False):
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    if blp:
        return np.stack([r << 3, g << 2, b << 3], -1)
    return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                     (b << 3) | (b >> 2)], -1)


def _bc1_colour(blk, four, blp=False):
    """(N, 16, 4) RGBA of BC1 colour blocks (N, 8); ``four``: every
    block in four-colour mode (BC2, BC3), else where c0 > c1."""
    c0 = blk[:, 0].astype(np.int64) | (blk[:, 1].astype(np.int64) << 8)
    c1 = blk[:, 2].astype(np.int64) | (blk[:, 3].astype(np.int64) << 8)
    p0, p1 = _565(c0, blp), _565(c1, blp)
    is4 = np.ones_like(c0, bool) if four else c0 > c1
    p2 = np.where(is4[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(is4[:, None], (p0 + 2 * p1) // 3, 0)
    a = np.full((len(blk), 4), 255, np.int64)
    a[:, 3] = np.where(is4, 255, 0)
    pal = np.stack([np.concatenate([p, a[:, k:k + 1]], -1) for k, p in
                    enumerate((p0, p1, p2, p3))], 1)
    lut = blk[:, 4:8].astype(np.int64) @ (1 << (8 * np.arange(4)))
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def _bc3_alpha(blk, signed=False):
    """(N, 16) values of BC3/BC4/BC5 alpha blocks (N, 8); signed (BC5S)
    endpoints are taken as int8 + 128."""
    a0, a1 = blk[:, 0].astype(np.int64), blk[:, 1].astype(np.int64)
    if signed:
        a0 = ((a0 ^ 128) - 128 + 128) & 0xFFFF
        a1 = ((a1 ^ 128) - 128 + 128) & 0xFFFF
    gt = a0 > a1
    pal = [a0, a1]
    for k in range(1, 7):
        pal.append(np.where(gt, ((7 - k) * a0 + k * a1) // 7,
                            ((5 - k) * a0 + k * a1) // 5 if k < 5 else 0))
    pal[6] = np.where(gt, pal[6], 0)
    pal[7] = np.where(gt, pal[7], 255)
    pal = np.stack(pal, 1) & 0xFF
    lo = blk[:, 2:5].astype(np.int64) @ (1 << (8 * np.arange(3)))
    hi = blk[:, 5:8].astype(np.int64) @ (1 << (8 * np.arange(3)))
    idx = np.concatenate([(lo[:, None] >> (3 * np.arange(8))) & 7,
                          (hi[:, None] >> (3 * np.arange(8))) & 7], 1)
    return np.take_along_axis(pal, idx, 1)


def _bcn_plain(src: bytes, w: int, h: int, n: int, signed: bool,
               path: str = '', blp: bool = False) -> np.ndarray:
    """``_bcn`` in numpy and Python: BC1-BC5 over all blocks at once,
    BC6H and BC7 block by block."""
    bw, bh = -(-w // 4), -(-h // 4)
    size = _BLOCK_BYTES[n]
    need = bw * bh * size
    if len(src) < need:
        raise _truncated(path)
    blk = np.frombuffer(src, np.uint8, need).reshape(-1, size)
    N = len(blk)
    out = np.zeros((N, 16, 4), np.int64)
    if n == 1:
        out = _bc1_colour(blk, False, blp)
    elif n in (2, 3):
        out = _bc1_colour(blk[:, 8:], True, blp)
        if n == 2:
            a = np.unpackbits(blk[:, :8, None], axis=2, bitorder='little')
            a = a.reshape(N, 8, 2, 4)
            nib = (a * (1 << np.arange(4))).sum(-1).reshape(N, 16)
            out[..., 3] = nib * 17
        else:
            out[..., 3] = _bc3_alpha(blk[:, :8])
    elif n == 4:
        out[..., 0] = _bc3_alpha(blk)
        out[..., 3] = 255
    elif n == 5:
        out[..., 0] = _bc3_alpha(blk[:, :8], signed)
        out[..., 1] = _bc3_alpha(blk[:, 8:], signed)
        out[..., 2] = 128 if signed else 0
        out[..., 3] = 255
    elif n == 6:
        out = np.array([_bc6h_block(b.tobytes(), signed) for b in blk],
                       np.int64).reshape(N, 16, 4)
    else:
        out = np.array([_bc7_block(b.tobytes()) for b in blk],
                       np.int64).reshape(N, 16, 4)
    img = out.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(
        img.reshape(bh * 4, bw * 4, 4)[:h, :w].astype(np.uint8))


class _Bits:
    """An LSB-first reader of one 128-bit block."""

    def __init__(self, b: bytes):
        self.v, self.pos = int.from_bytes(b, 'little'), 0

    def take(self, n: int) -> int:
        r = (self.v >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return r


# BC6H and BC7: the two-subset partitions (one bit a pixel, pixel 0 first)
_P2 = (0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
       0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
       0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
       0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
       0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
       0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
       0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
       0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
# BC7's three-subset partitions, two bits a pixel (pixel 0 lowest)
_P3 = (
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
    0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254)
_ANCHOR2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
            15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
            15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
            6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_ANCHOR3A = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
             3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
             8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
             3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_ANCHOR3B = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
             15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
             15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
             15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
            4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}


def _subsets(ns: int, part: int):
    """(subset of each pixel, anchor index of each subset)."""
    if ns == 1:
        return [0] * 16, (0,)
    if ns == 2:
        return [(_P2[part] >> i) & 1 for i in range(16)], \
            (0, _ANCHOR2[part])
    return [(_P3[part] >> (2 * i)) & 3 for i in range(16)], \
        (0, _ANCHOR3A[part], _ANCHOR3B[part])


# BC7 modes: subsets, partition bits, rotation bits, index-selection bits,
# colour bits, alpha bits, endpoint p-bits, shared p-bits, index bits,
# second index bits
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))


def _bc7_block(b: bytes):
    """One BC7 block: 16 RGBA pixels. A block of mode byte 0 (no mode)
    decodes to zeros."""
    bits = _Bits(b)
    mode = 0
    while mode < 8 and not bits.take(1):
        mode += 1
    if mode == 8:
        return [(0, 0, 0, 255)] * 16
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    part, rot, sel = bits.take(pb), bits.take(rb), bits.take(isb)
    ends = [[[0] * 4 for _ in range(2 * ns)]]
    ends = [[0, 0, 0, 255] for _ in range(2 * ns)]
    for c in range(3):
        for e in range(2 * ns):
            ends[e][c] = bits.take(cb)
    if ab:
        for e in range(2 * ns):
            ends[e][3] = bits.take(ab)
    cbits, abits = cb, ab
    if epb or spb:
        pbits = [bits.take(1) for _ in range(2 * ns if epb else ns)]
        for e in range(2 * ns):
            p = pbits[e if epb else e // 2]
            for c in range(4 if ab else 3):
                ends[e][c] = (ends[e][c] << 1) | p
        cbits, abits = cb + 1, ab + 1 if ab else 0
    for e in range(2 * ns):
        for c in range(4):
            nb = cbits if c < 3 else abits
            if c == 3 and not ab:
                continue
            v = ends[e][c] << (8 - nb)
            ends[e][c] = v | (v >> nb)
    subset, anchors = _subsets(ns, part)
    idx = [bits.take(ib - (i in anchors)) for i in range(16)]
    idx2 = [bits.take(ib2 - (i == 0)) for i in range(16)] if ib2 else None
    out = []
    for i in range(16):
        e0, e1 = ends[2 * subset[i]], ends[2 * subset[i] + 1]
        if idx2 is None:
            wc = wa = _WEIGHTS[ib][idx[i]]
        elif sel:
            wc, wa = _WEIGHTS[ib2][idx2[i]], _WEIGHTS[ib][idx[i]]
        else:
            wc, wa = _WEIGHTS[ib][idx[i]], _WEIGHTS[ib2][idx2[i]]
        px = [((64 - (wc if c < 3 else wa)) * e0[c]
               + (wc if c < 3 else wa) * e1[c] + 32) >> 6 for c in range(4)]
        if rot:
            px[rot - 1], px[3] = px[3], px[rot - 1]
        out.append(tuple(px))
    return out


# BC6H modes: (mode code, bits of the mode field, transformed, endpoint
# bits, delta bits (r, g, b), two subsets, the endpoint bits in stream
# order as (field, bit)); fields r0-r3 0-3, g0-g3 4-7, b0-b3 8-11 (0: the
# first endpoint of subset 0, 1: its second, 2 and 3: subset 1's)
def _f(field: str, a: int, b: int):
    """Bits ``[a:b]`` of a field in stream order, bit ``b`` first
    (``[9:0]`` reads bit 0 first; the reversed ``[10:15]`` bit 15)."""
    k = 'rgb'.index(field[0]) * 4 + int(field[1])
    step = 1 if a >= b else -1
    return [(k, i) for i in range(b, a + step, step)]


def _layout(*parts):
    out = []
    for p in parts:
        out += _f(*p)
    return tuple(out)


_BC6H = {
    0b00: (2, True, 10, (5, 5, 5), True, _layout(
        ('g2', 4, 4), ('b2', 4, 4), ('b3', 4, 4), ('r0', 9, 0), ('g0', 9, 0),
        ('b0', 9, 0), ('r1', 4, 0), ('g3', 4, 4), ('g2', 3, 0), ('g1', 4, 0),
        ('b3', 0, 0), ('g3', 3, 0), ('b1', 4, 0), ('b3', 1, 1), ('b2', 3, 0),
        ('r2', 4, 0), ('b3', 2, 2), ('r3', 4, 0), ('b3', 3, 3))),
    0b01: (2, True, 7, (6, 6, 6), True, _layout(
        ('g2', 5, 5), ('g3', 4, 4), ('g3', 5, 5), ('r0', 6, 0), ('b3', 0, 0),
        ('b3', 1, 1), ('b2', 4, 4), ('g0', 6, 0), ('b2', 5, 5), ('b3', 2, 2),
        ('g2', 4, 4), ('b0', 6, 0), ('b3', 3, 3), ('b3', 5, 5), ('b3', 4, 4),
        ('r1', 5, 0), ('g2', 3, 0), ('g1', 5, 0), ('g3', 3, 0), ('b1', 5, 0),
        ('b2', 3, 0), ('r2', 5, 0), ('r3', 5, 0))),
    0b00010: (5, True, 11, (5, 4, 4), True, _layout(
        ('r0', 9, 0), ('g0', 9, 0), ('b0', 9, 0), ('r1', 4, 0), ('r0', 10, 10),
        ('g2', 3, 0), ('g1', 3, 0), ('g0', 10, 10), ('b3', 0, 0), ('g3', 3, 0),
        ('b1', 3, 0), ('b0', 10, 10), ('b3', 1, 1), ('b2', 3, 0), ('r2', 4, 0),
        ('b3', 2, 2), ('r3', 4, 0), ('b3', 3, 3))),
    0b00110: (5, True, 11, (4, 5, 4), True, _layout(
        ('r0', 9, 0), ('g0', 9, 0), ('b0', 9, 0), ('r1', 3, 0), ('r0', 10, 10),
        ('g3', 4, 4), ('g2', 3, 0), ('g1', 4, 0), ('g0', 10, 10), ('g3', 3, 0),
        ('b1', 3, 0), ('b0', 10, 10), ('b3', 1, 1), ('b2', 3, 0), ('r2', 3, 0),
        ('b3', 0, 0), ('b3', 2, 2), ('r3', 3, 0), ('g2', 4, 4),
        ('b3', 3, 3))),
    0b01010: (5, True, 11, (4, 4, 5), True, _layout(
        ('r0', 9, 0), ('g0', 9, 0), ('b0', 9, 0), ('r1', 3, 0), ('r0', 10, 10),
        ('b2', 4, 4), ('g2', 3, 0), ('g1', 3, 0), ('g0', 10, 10), ('b3', 0, 0),
        ('g3', 3, 0), ('b1', 4, 0), ('b0', 10, 10), ('b2', 3, 0), ('r2', 3, 0),
        ('b3', 1, 1), ('b3', 2, 2), ('r3', 3, 0), ('b3', 4, 4),
        ('b3', 3, 3))),
    0b01110: (5, True, 9, (5, 5, 5), True, _layout(
        ('r0', 8, 0), ('b2', 4, 4), ('g0', 8, 0), ('g2', 4, 4), ('b0', 8, 0),
        ('b3', 4, 4), ('r1', 4, 0), ('g3', 4, 4), ('g2', 3, 0), ('g1', 4, 0),
        ('b3', 0, 0), ('g3', 3, 0), ('b1', 4, 0), ('b3', 1, 1), ('b2', 3, 0),
        ('r2', 4, 0), ('b3', 2, 2), ('r3', 4, 0), ('b3', 3, 3))),
    0b10010: (5, True, 8, (6, 5, 5), True, _layout(
        ('r0', 7, 0), ('g3', 4, 4), ('b2', 4, 4), ('g0', 7, 0), ('b3', 2, 2),
        ('g2', 4, 4), ('b0', 7, 0), ('b3', 3, 3), ('b3', 4, 4), ('r1', 5, 0),
        ('g2', 3, 0), ('g1', 4, 0), ('b3', 0, 0), ('g3', 3, 0), ('b1', 4, 0),
        ('b3', 1, 1), ('b2', 3, 0), ('r2', 5, 0), ('r3', 5, 0))),
    0b10110: (5, True, 8, (5, 6, 5), True, _layout(
        ('r0', 7, 0), ('b3', 0, 0), ('b2', 4, 4), ('g0', 7, 0), ('g2', 5, 5),
        ('g2', 4, 4), ('b0', 7, 0), ('g3', 5, 5), ('b3', 4, 4), ('r1', 4, 0),
        ('g3', 4, 4), ('g2', 3, 0), ('g1', 5, 0), ('g3', 3, 0), ('b1', 4, 0),
        ('b3', 1, 1), ('b2', 3, 0), ('r2', 4, 0), ('b3', 2, 2), ('r3', 4, 0),
        ('b3', 3, 3))),
    0b11010: (5, True, 8, (5, 5, 6), True, _layout(
        ('r0', 7, 0), ('b3', 1, 1), ('b2', 4, 4), ('g0', 7, 0), ('b2', 5, 5),
        ('g2', 4, 4), ('b0', 7, 0), ('b3', 5, 5), ('b3', 4, 4), ('r1', 4, 0),
        ('g3', 4, 4), ('g2', 3, 0), ('g1', 4, 0), ('b3', 0, 0), ('g3', 3, 0),
        ('b1', 5, 0), ('b2', 3, 0), ('r2', 4, 0), ('b3', 2, 2), ('r3', 4, 0),
        ('b3', 3, 3))),
    0b11110: (5, False, 6, (6, 6, 6), True, _layout(
        ('r0', 5, 0), ('g3', 4, 4), ('b3', 0, 0), ('b3', 1, 1), ('b2', 4, 4),
        ('g0', 5, 0), ('g2', 5, 5), ('b2', 5, 5), ('b3', 2, 2), ('g2', 4, 4),
        ('b0', 5, 0), ('g3', 5, 5), ('b3', 3, 3), ('b3', 5, 5), ('b3', 4, 4),
        ('r1', 5, 0), ('g2', 3, 0), ('g1', 5, 0), ('g3', 3, 0), ('b1', 5, 0),
        ('b2', 3, 0), ('r2', 5, 0), ('r3', 5, 0))),
    0b00011: (5, False, 10, (10, 10, 10), False, _layout(
        ('r0', 9, 0), ('g0', 9, 0), ('b0', 9, 0), ('r1', 9, 0), ('g1', 9, 0),
        ('b1', 9, 0))),
    0b00111: (5, True, 11, (9, 9, 9), False, _layout(
        ('r0', 9, 0), ('g0', 9, 0), ('b0', 9, 0), ('r1', 8, 0), ('r0', 10, 10),
        ('g1', 8, 0), ('g0', 10, 10), ('b1', 8, 0), ('b0', 10, 10))),
    0b01011: (5, True, 12, (8, 8, 8), False, _layout(
        ('r0', 9, 0), ('g0', 9, 0), ('b0', 9, 0), ('r1', 7, 0), ('r0', 10, 11),
        ('g1', 7, 0), ('g0', 10, 11), ('b1', 7, 0), ('b0', 10, 11))),
    0b01111: (5, True, 16, (4, 4, 4), False, _layout(
        ('r0', 9, 0), ('g0', 9, 0), ('b0', 9, 0), ('r1', 3, 0), ('r0', 10, 15),
        ('g1', 3, 0), ('g0', 10, 15), ('b1', 3, 0), ('b0', 10, 15))),
}


def _sext(v: int, bits: int) -> int:
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _bc6h_unquantize(v: int, bits: int, signed: bool) -> int:
    if not signed:
        if bits >= 15 or v == 0:
            return v
        if v == (1 << bits) - 1:
            return 0xFFFF
        return ((v << 16) + 0x8000) >> bits
    if bits >= 16:
        return v
    s, v = v < 0, abs(v)
    if v == 0:
        u = 0
    elif v >= (1 << (bits - 1)) - 1:
        u = 0x7FFF
    else:
        u = ((v << 15) + 0x4000) >> (bits - 1)
    return -u if s else u


def _half_to_8(h: int) -> int:
    """A half float's bits as PIL stores them in 8 bits: clamped to
    [0, 1], times 255, truncated."""
    f = float(np.array([h], np.uint16).view(np.float16)[0])
    if not f >= 0.0:
        return 0
    if f > 1.0:
        return 255
    return int(np.float32(f) * np.float32(255.0))


def _bc6h_block(b: bytes, signed: bool):
    """One BC6H block: 16 RGBA pixels (alpha 255). A reserved mode
    decodes to zeros."""
    bits = _Bits(b)
    code = bits.take(2)
    if code > 1:
        code |= bits.take(3) << 2
    if code not in _BC6H:
        return [(0, 0, 0, 255)] * 16
    _, transformed, eb, db, two, layout = _BC6H[code]
    f = [0] * 12
    for k, i in layout:
        f[k] |= bits.take(1) << i
    part = bits.take(5) if two else 0
    ne = 4 if two else 2
    ends = [[f[c * 4 + e] for c in range(3)] for e in range(ne)]
    mask = (1 << eb) - 1
    for c in range(3):
        if signed:
            ends[0][c] = _sext(ends[0][c], eb)
        for e in range(1, ne):
            if transformed:
                v = (ends[0][c] + _sext(ends[e][c], db[c])) & mask
                # PIL wraps the sum to the endpoint bits and, signed,
                # takes it as a 16-bit integer: not sign-extended below
                # 16 endpoint bits
                ends[e][c] = ((v + 0x8000) & 0xFFFF) - 0x8000 if signed \
                    else v
            elif signed:
                ends[e][c] = _sext(ends[e][c], eb)
    ends = [[_bc6h_unquantize(v, eb, signed) for v in e] for e in ends]
    subset, anchors = _subsets(2 if two else 1, part)
    ib = 3 if two else 4
    out = []
    for i in range(16):
        w = _WEIGHTS[ib][bits.take(ib - (i in anchors))]
        e0, e1 = ends[2 * subset[i]], ends[2 * subset[i] + 1]
        px = []
        for c in range(3):
            v = ((64 - w) * e0[c] + w * e1[c]) >> 6     # no rounding
            if signed:
                h = (0x8000 | ((-v * 31) >> 5)) if v < 0 else (v * 31) >> 5
            else:
                h = (v * 31) >> 6
            px.append(_half_to_8(h))
        out.append((*px, 255))
    return out
