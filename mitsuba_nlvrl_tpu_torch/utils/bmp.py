"""A BMP (and headerless DIB) decoder in numpy (no PIL).

Reads what PIL's ``BmpImagePlugin`` reads, to the same mode and samples,
so that ``texture._pil_rgb`` of the result equals PIL's
``Image.open(path).convert('RGB')`` byte for byte:

  * the core (12-byte), INFO (40), V2/V3 (52, 56), OS/2 (64), V4 (108)
    and V5 (124) headers; a negative height is a top-down file;
  * 1-, 4- and 8-bit palettes (the file's colour count, or 2^bits), a
    palette that is the grey ramp opening as PIL's ``1`` or ``L``;
  * 16-bit 555 (``BI_RGB`` or bitfields) and 565 (bitfields), 24-bit,
    32-bit ``BI_RGB`` (the fourth byte ignored, as PIL does) and the
    32-bit bitfield layouts PIL knows, alpha masks among them;
  * RLE8 and RLE4 through PIL's own decoder loop (``BmpRleDecoder``),
    its reading of a delta code (two bytes past the code's own) and its
    word alignment on the file offset kept.

Any other compression, depth or bitfield layout raises ``OSError``, as PIL
does at ``Image.open``.
"""
from __future__ import annotations

import struct

import numpy as np

# the 32-bit bitfield layouts PIL reads: (r, g, b, a) masks -> byte order
_MASK32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): 'BGRX',
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): 'XBGR',
    (0xFF000000, 0xFF00, 0xFF, 0x0): 'BGXR',
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): 'ABGR',
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): 'RGBA',
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): 'BGRA',
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): 'BGAR',
    (0x0, 0x0, 0x0, 0x0): 'BGRA',
}
_MASK16 = {(0xF800, 0x7E0, 0x1F): 565, (0x7C00, 0x3E0, 0x1F): 555}


def unpack_16(px: np.ndarray, layout: int) -> np.ndarray:
    """16-bit little-endian words (5-5-5 or 5-6-5, blue lowest) -> RGB
    uint8, each field widened as PIL's unpackers do (v * 255 // max)."""
    p = px.astype(np.int64)
    if layout == 565:
        r, g, b = (p >> 11) & 31, (p >> 5) & 63, p & 31
        g = g * 255 // 63
    else:
        r, g, b = (p >> 10) & 31, (p >> 5) & 31, p & 31
        g = g * 255 // 31
    return np.stack([r * 255 // 31, g, b * 255 // 31], -1).astype(np.uint8)


def _unpack_bits(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """Rows of packed 1-, 4- or 8-bit indices (most significant first)
    -> (rows, width) uint8."""
    if bits == 8:
        return rows[:, :width]
    if bits == 4:
        out = np.stack([rows >> 4, rows & 15], -1).reshape(rows.shape[0], -1)
    else:
        out = np.unpackbits(rows, axis=1)
    return out[:, :width]


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool):
    """PIL's ``BmpRleDecoder.decode`` over ``data`` from ``pos``: the
    pixel indices in file row order, one byte a pixel."""
    out = bytearray()
    x, need = 0, width * height
    while len(out) < need:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * (count // 2 + 1))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                               # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:                               # end of bitmap
            break
        elif byte == 2:                               # delta
            # PIL reads the two delta bytes, then takes the next two as
            # (right, up)
            if pos + 4 > len(data):
                break
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:                                         # absolute run
            n = byte // 2 if rle4 else byte
            run = data[pos:pos + n]
            pos += len(run)
            if rle4:
                out += np.stack([np.frombuffer(run, np.uint8) >> 4,
                                 np.frombuffer(run, np.uint8) & 15],
                                -1).tobytes()
            else:
                out += run
            if len(run) < n:
                break
            x += byte
            pos += pos & 1                           # word alignment
    if len(out) < need:
        raise ValueError("not enough image data")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(height, width)


def read_bmp(path: str):
    """Read a BMP (``BM`` file header) or a DIB (its info header first) to
    ``(mode, pixels, palette)`` as PIL opens it: mode ``1``, ``L`` or
    ``P`` (pixels (H, W) uint8, ``1`` as 0/255, ``P`` with an (N, 3)
    palette) or ``RGB``/``RGBA`` ((H, W, C) uint8)."""
    with open(path, 'rb') as f:
        return decode_bmp(f.read(), path)


def decode_bmp(data: bytes, path: str = '<bytes>'):
    """``read_bmp`` of a file's bytes (``path`` names them in errors)."""
    return _decode(data, path)[:3]


def decode_dib(data: bytes, pos: int, path: str = '<bytes>', alpha=None):
    """The DIB at ``pos`` of an ICO or CUR file (its info header first, no
    file header), as PIL's icon and cursor plugins open it: the header's
    height halved (the AND mask's rows follow the colour rows); a 32-bit
    DIB at offset 22 (a cursor file's only entry) in ``RGBA``, as PIL's
    BMP plugin reads it there. ``alpha``, where given, is called as
    ``alpha(offset, width, height)`` (``offset`` where the pixel rows
    start) once the header is read and before the rows are, as PIL reads
    an icon's mask. Returns ``(mode, pixels, palette, alpha's result)``."""
    return _decode(data, path, pos, alpha)


def _decode(data: bytes, path: str, dib: int = None, alpha=None):
    """(mode, pixels, palette, ``alpha``'s result) of a BMP file, or of
    the DIB at ``dib`` inside an icon or cursor file."""
    if dib is not None:
        offset, pos = 0, dib
    elif data[:2] == b'BM':
        offset, pos = struct.unpack_from('<I', data, 10)[0], 14
    else:
        offset, pos = 0, 0
    hsize = struct.unpack_from('<I', data, pos)[0]
    hd = data[pos + 4:pos + hsize]
    pos += hsize
    if len(hd) != hsize - 4:
        raise OSError(f"{path}: truncated BMP header")
    masks = None
    if hsize == 12:
        width, height, _, bits = struct.unpack_from('<HHHH', hd)
        comp, colors, pal_pad, direction = 0, 0, 3, -1
    elif hsize in (40, 52, 56, 64, 108, 124):
        y_flip = hd[7] == 0xFF
        direction = 1 if y_flip else -1
        width, height = struct.unpack_from('<II', hd)
        if y_flip:
            height = 2 ** 32 - height
        bits, comp = struct.unpack_from('<HI', hd, 10)
        colors = struct.unpack_from('<I', hd, 28)[0]
        pal_pad = 4
        if comp == 3:                                 # BI_BITFIELDS
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = struct.unpack_from(f'<{n}I', hd, 36)
            else:
                masks = struct.unpack_from('<3I', data, pos)
                pos += 12
            masks = tuple(masks) + (0,) * (4 - len(masks))
    else:
        raise OSError(f"Unsupported BMP header type ({hsize})")
    if dib is not None:
        height //= 2
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise OSError(f"Unsupported BMP pixel depth ({bits})")
    layout = {1: 'P', 4: 'P', 8: 'P', 16: 555, 24: 'BGR', 32: 'BGRX'}[bits]
    if bits == 32 and comp == 0 and dib == 22:
        layout = 'BGRA'          # PIL: "32-bit .cur offset" (header 22)
    if comp == 3:
        if bits == 32 and masks in _MASK32:
            layout = _MASK32[masks]
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            layout = 'BGR'
        elif bits == 16 and masks[:3] in _MASK16:
            layout = _MASK16[masks[:3]]
        else:
            raise OSError("Unsupported BMP bitfields layout")
    elif comp not in (0, 1, 2):
        raise OSError(f"Unsupported BMP compression ({comp})")
    mode, palette = ('RGBA' if 'A' in str(layout) else 'RGB'), None
    if layout == 'P':
        if not 0 < colors <= 65536:
            raise OSError(f"Unsupported BMP Palette size ({colors})")
        raw = np.frombuffer(data[pos:pos + pal_pad * colors], np.uint8)
        pos += pal_pad * colors
        raw = raw[:len(raw) // pal_pad * pal_pad].reshape(-1, pal_pad)
        palette = np.ascontiguousarray(raw[:, 2::-1])
        ramp = np.arange(colors) if colors != 2 else np.array([0, 255])
        grey = len(palette) == colors and bool(
            (palette == ramp[:, None]).all())
        mode = ('1' if colors == 2 else 'L') if grey else 'P'
    start = offset or pos
    extra = alpha(start, width, height) if alpha else None
    if comp in (1, 2):
        idx = _rle(data, start, width, height, rle4=comp == 2)
        pixels = idx if direction == 1 else idx[::-1]
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = stride * height
        if len(data) - start < need:
            raise OSError("image file is truncated")
        rows = np.frombuffer(data, np.uint8, need, start).reshape(height,
                                                                   stride)
        if direction == -1:
            rows = rows[::-1]
        if bits <= 8:
            pixels = _unpack_bits(rows, bits, width)
        elif bits == 16:
            px = rows[:, :2 * width].reshape(height, width, 2)
            pixels = unpack_16(px[..., 0] | (px[..., 1].astype(np.uint16)
                                             << 8), layout)
        else:
            px = rows[:, :width * bits // 8].reshape(height, width, -1)
            order = [layout.index(c) for c in 'RGBA' if c in layout]
            pixels = px[..., order]
    if mode == '1':
        pixels = np.where(pixels != 0, 255, 0).astype(np.uint8)
    return mode, np.ascontiguousarray(pixels), palette, extra
