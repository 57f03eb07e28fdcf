"""A Targa (TGA) decoder in numpy (no PIL).

Reads what PIL's ``TgaImagePlugin`` reads, to the same mode and samples:
image types 1 and 9 (colour-mapped, 8-bit indices), 2 and 10 (true
colour: 16-bit 5-5-5, 24- and 32-bit) and 3 and 11 (grey: 1-, 8- and
16-bit grey with alpha); colour maps of 16 or 24 bits with their first
index (the entries below it black; PIL fails to load a 32-bit map, and so
here); both origin bits; RLE literal packets that run across rows (a
repeat packet that does is an overrun in PIL, and so here). ``is_tga`` is
PIL's header check: TGA has no signature, so a file is TGA when its
header passes it and no format PIL tries earlier claimed it. A 15-bit
file fails that check in PIL, and so here.
"""
from __future__ import annotations

import struct

import numpy as np

from .bmp import unpack_16

# (image type & 7, depth) -> bytes a pixel, for the layouts PIL decodes
_PIXEL_BYTES = {(1, 8): 1, (3, 1): 0, (3, 8): 1, (3, 16): 2, (2, 16): 2,
                (2, 24): 3, (2, 32): 4}


def is_tga(prefix: bytes) -> bool:
    """PIL's ``TgaImageFile._open`` checks on the 18-byte header."""
    if len(prefix) < 18:
        return False
    w, h = struct.unpack_from('<HH', prefix, 12)
    cmap, itype, depth, flags = prefix[1], prefix[2], prefix[16], prefix[17]
    if cmap not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16,
                                                               24, 32):
        return False
    if itype not in (1, 2, 3, 9, 10, 11):
        return False
    return not cmap or prefix[7] in (16, 24, 32)


def _colours(raw: np.ndarray, nbytes: int) -> np.ndarray:
    """(N, nbytes) little-endian BGR(A) or 5-5-5 entries -> (N, C)."""
    if nbytes == 2:
        return unpack_16(raw[:, 0] | (raw[:, 1].astype(np.uint16) << 8), 555)
    return raw[:, [2, 1, 0, 3][:nbytes]]


def _unrle(data: bytes, pos: int, n: int, nbytes: int, width: int) -> bytes:
    """n pixels of ``nbytes`` each from the RLE packets at ``pos``. A
    literal packet may run on into the next row; a repeat packet that
    would is an overrun, as in PIL's decoder."""
    out, need, row = bytearray(), n * nbytes, width * nbytes
    while len(out) < need and pos < len(data):
        head = data[pos]
        count = (head & 0x7F) + 1
        if head & 0x80:
            if len(out) % row + count * nbytes > row:
                raise OSError("buffer overrun when reading image file")
            out += data[pos + 1:pos + 1 + nbytes] * count
            pos += 1 + nbytes
        else:
            out += data[pos + 1:pos + 1 + count * nbytes]
            pos += 1 + count * nbytes
    if len(out) < need:
        raise OSError("image file is truncated")
    return bytes(out[:need])


def read_tga(path: str):
    """Read a TGA to ``(mode, pixels, palette)`` as PIL opens it: ``P``
    ((H, W) indices, an (N, 3) palette), ``1`` or ``L`` ((H, W)), ``LA``,
    ``RGB`` or ``RGBA`` ((H, W, C))."""
    with open(path, 'rb') as f:
        data = f.read()
    if not is_tga(data[:18]):
        raise OSError(f"{path}: not a TGA file")
    id_len, cmap, itype = data[0], data[1], data[2]
    W, H = struct.unpack_from('<HH', data, 12)
    depth, flags = data[16], data[17]
    pos = 18 + id_len
    palette = None
    if cmap:
        start, size = struct.unpack_from('<HH', data, 3)
        eb = data[7] // 8
        if eb == 4:        # PIL cannot put a BGRA palette into its image
            raise ValueError("unrecognized raw mode")
        raw = np.frombuffer(data, np.uint8, eb * size, pos).reshape(size, eb)
        pos += eb * size
        palette = np.zeros((start + size, 3), np.uint8)
        palette[start:] = _colours(raw, eb)[:, :3]
    kind = itype & 7
    if kind == 1 and not cmap or (kind, depth) not in _PIXEL_BYTES:
        raise OSError(f"{path}: TGA layout PIL cannot decode "
                      f"(type {itype}, depth {depth})")
    nb = _PIXEL_BYTES[(kind, depth)]
    if depth == 1:                          # packed bits, 1 = white
        if itype & 8:
            raise OSError(f"{path}: run-length 1-bit TGA")
        stride = (W + 7) // 8
        rows = np.frombuffer(data, np.uint8, stride * H, pos).reshape(H, -1)
        px = np.unpackbits(rows, axis=1)[:, :W] * np.uint8(255)
    else:
        if itype & 8:
            buf = _unrle(data, pos, W * H, nb, W)
        else:
            buf = data[pos:pos + W * H * nb]
            if len(buf) < W * H * nb:
                raise OSError("image file is truncated")
        px = np.frombuffer(buf, np.uint8).reshape(H, W, nb)
        if kind == 2:
            # a 16-bit pixel's alpha bit is not kept: PIL opens it as RGBA
            # and convert('RGB') drops it
            px = _colours(px.reshape(-1, nb), nb).reshape(H, W, -1)
        elif nb == 1:
            px = px[..., 0]
    orient = flags & 0x30
    if orient in (0x00, 0x10):              # bottom-up rows
        px = px[::-1]
    if orient in (0x10, 0x30):              # right-to-left columns
        px = px[:, ::-1]
    mode = {1: 'P', 3: {1: '1', 8: 'L', 16: 'LA'}.get(depth),
            2: 'RGBA' if depth == 32 else 'RGB'}[kind]
    return mode, np.ascontiguousarray(px), palette
