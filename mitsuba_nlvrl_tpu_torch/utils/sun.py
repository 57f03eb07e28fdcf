"""A Sun raster decoder in numpy (no PIL), as PIL's ``SunImagePlugin``
reads: depths 1 (mode ``1``, a set bit black), 4 and 8 (``L``, or ``P``
through an RGB colour map of up to 1,024 bytes, stored as three planes),
24 and 32 (``RGB``: BGR and XBGR samples, RGB and XRGB in a file of type
3). Types 0, 1, 3, 4 and 5 hold raw rows padded to 16 bits; type 2 is
RLE, whose runs (``0x80 n v``: n + 1 copies of v; ``0x80 0``: one 0x80)
fill unpadded rows and run on across them, as in PIL's ``sun_rle``
decoder. The RLE runs in ``native/bitmap_raster.cpp`` (``_sun_rle``);
``_sun_rle_plain`` is its plain version. Any other depth, colour map or
type raises ``OSError``, as does a file that ends before its last row; a
colour map on a 1-bit or RGB image ``ValueError``, as in PIL.
"""
from __future__ import annotations

import struct

import numpy as np

from .raw import raw_image, row_bytes, unpack

_MODES = {1: ('1', '1;I'), 4: ('L', 'L;4'), 8: ('L', 'L')}


def read_sun(path: str):
    """Read a Sun raster file to ``(mode, pixels, palette)``: ``1``,
    ``L`` or ``P`` ((H, W), with an (N, 3) palette for ``P``) or ``RGB``
    ((H, W, 3) or (H, W, 4) with the padding byte), uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 32 or data[:4] != b'\x59\xa6\x6a\x95':
        raise OSError(f"{path}: not a Sun raster file")
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from('>7I', data, 4)
    if depth in _MODES:
        mode, rawmode = _MODES[depth]
    elif depth in (24, 32):
        mode = 'RGB'
        rawmode = ('RGB' if ftype == 3 else 'BGR') + ('X' if depth == 32
                                                      else '')
    else:
        raise OSError(f"{path}: Unsupported Mode/Bit Depth")
    offset, palette = 32, None
    if plen:
        if plen > 1024:
            raise OSError(f"{path}: Unsupported Color Palette Length")
        if ptype != 1:
            raise OSError(f"{path}: Unsupported Palette Type")
        offset += plen
        raw = np.frombuffer(data[32:32 + plen], np.uint8)
        n = len(raw) // 3
        palette = raw[:3 * n].reshape(3, n).T.copy()
        if mode == 'L':
            mode, rawmode = 'P', rawmode.replace('L', 'P')
    if w <= 0 or h <= 0:
        raise OSError(f"{path}: cannot identify image file")
    if ftype in (0, 1, 3, 4, 5):
        stride = ((w * depth + 15) // 16) * 2
        px = raw_image(data, offset, w, h, rawmode, stride)
    elif ftype == 2:
        rows = _sun_rle(data[offset:], row_bytes(rawmode, w), h)
        px = unpack(rows, rawmode, w)
    else:
        raise OSError(f"{path}: Unsupported Sun Raster file type")
    if palette is not None and mode != 'P':
        # PIL sets the colour map on a 1-bit or RGB image once it is read
        raise ValueError("unrecognized image mode")
    return mode, px, palette


def _sun_rle(src: bytes, nbytes: int, h: int) -> np.ndarray:
    """The (h, nbytes) rows of Sun RLE data, in
    ``native/bitmap_raster.cpp``. Fails as ``_sun_rle_plain`` does."""
    from ..native import bitmap_library, ptr
    buf = np.frombuffer(src, np.uint8)
    out = np.zeros((h, nbytes), np.uint8)
    if bitmap_library().mnt_sun_rle(ptr(buf), buf.size, nbytes, h,
                                    ptr(out)) < 0:
        raise OSError("image file is truncated")
    return out


def _sun_rle_plain(src: bytes, nbytes: int, h: int) -> np.ndarray:
    """``_sun_rle`` in Python: PIL's ``sun_rle`` decoder loop. A run
    past a row's end carries on into the next rows; data that ends
    before the last row raises ``OSError``."""
    out = np.zeros((h, nbytes), np.uint8)
    flat = out.reshape(-1)
    total, pos, n, at = h * nbytes, 0, len(src), 0
    while at < total:
        if pos >= n:
            raise OSError("image file is truncated")
        b = src[pos]
        if b == 0x80:
            if pos + 1 >= n:
                raise OSError("image file is truncated")
            count = src[pos + 1]
            if count == 0:
                flat[at] = 0x80
                at += 1
                pos += 2
                continue
            if pos + 2 >= n:
                raise OSError("image file is truncated")
            count = min(count + 1, total - at)
            flat[at:at + count] = src[pos + 2]
            at += count
            pos += 3
        else:
            flat[at] = b
            at += 1
            pos += 1
    return out
