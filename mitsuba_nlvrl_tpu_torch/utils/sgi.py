"""An SGI (IRIS RGB) decoder in numpy and the bitmap library (no PIL), as
PIL's ``SgiImagePlugin`` decodes: 1, 3 or 4 channels (``L``, ``RGB``,
``RGBA``) at 8 or 16 bits a sample (16-bit samples cut to their high
byte), verbatim or RLE, rows stored bottom-up.

Verbatim 8-bit planes read as PIL's raw decoder reads them (a file that
ends early raises ``OSError``), verbatim 16-bit ones as its ``SGI16``
decoder (``ValueError``). RLE rows decode in ``native/bitmap_raster.cpp``
(``_sgi_rle``) as PIL's ``sgi_rle`` decoder does, with its quirks: the
row buffer is kept from row to row, so a row that stops short keeps the
previous row's pixels; a row whose length runs out on a nonzero opcode
ends the image without error; an offset or a run past the data raises
``OSError`` with the rows decoded so far lost. ``_sgi_rle_plain`` is the
plain version. A compression PIL does not know raises ``OSError``, as
PIL's load of no tile does; a layout outside PIL's table raises
``ValueError``.
"""
from __future__ import annotations

import struct

import numpy as np

# (bytes a sample, dimension, channels) -> PIL mode
_MODES = {(1, 1, 1): 'L', (1, 2, 1): 'L', (2, 1, 1): 'L', (2, 2, 1): 'L',
          (1, 3, 3): 'RGB', (2, 3, 3): 'RGB', (1, 3, 4): 'RGBA',
          (2, 3, 4): 'RGBA'}
_HEAD = 512


def read_sgi(path: str):
    """Read an SGI file to ``(mode, pixels, None)``: ``L`` ((H, W)),
    ``RGB`` or ``RGBA`` ((H, W, C)), uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 12 or struct.unpack_from('>H', data)[0] != 474:
        raise ValueError(f"{path}: not an SGI image file")
    comp, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from('>4H', data, 4)
    if (bpc, dim, z) not in _MODES:
        raise ValueError(f"{path}: unsupported SGI image mode")
    mode = _MODES[(bpc, dim, z)]
    px = np.zeros((h, w, z), np.uint8)
    if comp == 0 and bpc == 1:
        page = w * h
        for c in range(z):
            off = _HEAD + c * page
            if off + page > len(data):
                raise OSError(f"{path}: image file is truncated")
            px[..., c] = np.frombuffer(data, np.uint8, page, off).reshape(
                h, w)[::-1]
    elif comp == 0:
        page = 2 * w * h
        for c in range(z):
            plane = data[_HEAD + c * page:_HEAD + (c + 1) * page]
            if len(plane) < page:
                raise ValueError("not enough image data")
            px[..., c] = np.frombuffer(plane, np.uint8)[::2].reshape(
                h, w)[::-1]
    elif comp == 1:
        px = _sgi_rle(data[_HEAD:], w, h, z, bpc)
    else:                               # PIL finds no tile to load
        raise OSError(f"{path}: cannot load this image")
    return mode, (px[..., 0] if z == 1 else px), None


def _tables(body: bytes, h: int, z: int):
    n = h * z
    if len(body) < 8 * n:
        return None
    t = np.frombuffer(body, '>u4', 2 * n).astype(np.int64)
    return t[:n], t[n:]


def _sgi_rle(body: bytes, w: int, h: int, z: int, bpc: int) -> np.ndarray:
    """The (h, w, z) 8-bit samples of an RLE SGI file's data after its
    header, in ``native/bitmap_raster.cpp``. Fails as ``_sgi_rle_plain``
    does."""
    from ..native import bitmap_library, ptr
    tabs = _tables(body, h, z)
    if tabs is None:
        raise OSError("buffer overrun when reading image file")
    start, length = (np.ascontiguousarray(t) for t in tabs)
    buf = np.frombuffer(body, np.uint8)
    out = np.zeros((h, w, z), np.uint8)
    if bitmap_library().mnt_sgi_rle_rows(ptr(buf), buf.size, ptr(start),
                                         ptr(length), w, h, z | (bpc << 8),
                                         ptr(out)):
        raise OSError("buffer overrun when reading image file")
    return out


def _expand_row(body, pos, n, row, ch, z, w, bpc):
    """PIL's ``expandrow``/``expandrow2`` for one channel of one row:
    0 when the row ends, 1 when the image ends quietly, -1 on overrun."""
    end = len(body) - 1                   # PIL's end_of_buffer, inclusive
    x = 0
    while n > 0:
        if pos + bpc - 1 > end:
            return -1
        op = int(body[pos + bpc - 1])
        pos += bpc
        if n == 1 and op != 0:
            return 1
        count = op & 0x7F
        if not count:
            return 0
        if x + count > w:
            return -1
        if op & 0x80:
            if pos + bpc * count > end:
                return -1
            row[x:x + count, ch] = body[pos:pos + bpc * count:bpc]
            pos += bpc * count
        else:
            if pos + (0 if bpc == 1 else 2) > end:
                return -1
            row[x:x + count, ch] = body[pos]
            pos += bpc
        x += count
        n -= 1
    return 0


def _sgi_rle_plain(body: bytes, w: int, h: int, z: int,
                   bpc: int) -> np.ndarray:
    """``_sgi_rle`` in Python: PIL's ``sgi_rle`` loop, the row buffer
    kept across rows, bottom row first."""
    tabs = _tables(body, h, z)
    if tabs is None:
        raise OSError("buffer overrun when reading image file")
    start, length = tabs
    body = np.frombuffer(body, np.uint8)
    out = np.zeros((h, w, z), np.uint8)
    row = np.zeros((w, z), np.uint8)
    for r in range(h):
        for c in range(z):
            off, n = int(start[r + c * h]) - _HEAD, int(length[r + c * h])
            if off < 0 or off + n > len(body):
                raise OSError("buffer overrun when reading image file")
            st = _expand_row(body, off, n, row, c, z, w, bpc)
            if st < 0:
                raise OSError("buffer overrun when reading image file")
            if st == 1:
                return out
        out[h - 1 - r] = row
    return out
