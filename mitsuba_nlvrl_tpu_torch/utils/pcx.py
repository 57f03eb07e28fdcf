"""A PCX (Paintbrush) decoder in numpy and the bitmap library (no PIL), as
PIL's ``PcxImagePlugin`` decodes: 1 bit in one plane (mode ``1``), 1 bit in
2 or 4 planes (``P``, the header's 16-colour palette), version 5 with
8 bits in one plane (``L``, or ``P`` through the 769-byte palette at the
file's end unless that palette is the identity grey ramp) and in three
planes (``RGB``). Any other layout raises ``OSError``, as PIL does.

Rows are ``planes * stride`` bytes, the stride PIL works out itself
(``(width * bits + 7) // 8``, made even where the header's differs).
The RLE runs in ``native/bitmap_raster.cpp`` (``_pcx_rle``); ``_pcx_rle_plain``
is its plain version. As in PIL's ``pcx`` decoder a run that crosses the
end of a row raises ``OSError`` once the image is decoded, as does a file
that ends before its last row; a row's planes are read where PIL reads
them (``_unpack``). A version 5 8-bit grey or palette file shorter than
769 bytes raises ``OSError``, as PIL's seek back to the palette does.
"""
from __future__ import annotations

import struct

import numpy as np

_HEAD = 128


def read_pcx(path: str):
    """Read a PCX file to ``(mode, pixels, palette)``: ``1``, ``L``,
    ``P`` ((H, W) and an (N, 3) palette for ``P``) or ``RGB``
    ((H, W, 3)), uint8."""
    with open(path, 'rb') as f:
        return decode_pcx(f.read(), path)


def decode_pcx(data: bytes, path: str = ''):
    """``read_pcx`` of a PCX file held in memory (``data`` runs to the
    file's end, where the 256-colour palette is looked for; ``path``
    names it in errors)."""
    if len(data) < 68 or data[0] != 10 or data[1] not in (0, 2, 3, 5):
        raise OSError(f"{path}: not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from('<4H', data, 4)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise OSError(f"{path}: bad PCX image size")
    version, bits, planes = data[1], data[3], data[65]
    provided = struct.unpack_from('<H', data, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = '1'
    elif bits == 1 and planes in (2, 4):
        mode = 'P'
        palette = np.frombuffer(data[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = 'L'
        if len(data) < 769:          # PIL seeks 769 bytes back from the end
            raise OSError(f"{path}: [Errno 22] Invalid argument")
        tail = data[-769:]
        if tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (pal == np.arange(256)[:, None]).all():
                mode, palette = 'P', pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = 'RGB'
    else:
        raise OSError(f"{path}: unknown PCX mode")
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    rows = _pcx_rle(data[_HEAD:], planes * stride, h)
    return mode, _unpack(rows, mode, w, bits, planes), palette


def _unpack(rows: np.ndarray, mode: str, w: int, bits: int,
            planes: int) -> np.ndarray:
    """The (h, planes * stride) rows as PIL unpacks them. Bit planes are
    read from the start of each plane's stride. Byte planes are read at
    the width, after PIL's decoder has moved them there from the stride
    only where the row's bytes are no multiple of the width and more than
    it (so some padded rows are read at the wrong place, as in PIL)."""
    h, nbytes = rows.shape
    stride = nbytes // planes
    if bits == 8:
        if nbytes % w and nbytes > w:
            bands = nbytes // w
            step = nbytes // bands
            rows = rows.copy()
            for i in range(1, bands):
                rows[:, i * w:(i + 1) * w] = rows[:, i * step:i * step + w]
        if mode == 'RGB':
            return np.ascontiguousarray(
                rows[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))
        return np.ascontiguousarray(rows[:, :w])
    v = np.zeros((h, w), np.uint8)
    for p in range(planes):
        v |= np.unpackbits(rows[:, p * stride:(p + 1) * stride],
                           axis=1)[:, :w] << p
    return v * 255 if mode == '1' else v


def _pcx_rle(src: bytes, nbytes: int, h: int) -> np.ndarray:
    """The (h, nbytes) rows of PCX RLE data, in
    ``native/bitmap_raster.cpp``. Fails as ``_pcx_rle_plain`` does."""
    from ..native import bitmap_library, ptr
    buf = np.frombuffer(src, np.uint8)
    out = np.zeros((h, nbytes), np.uint8)
    err = np.zeros(1, np.int64)
    if bitmap_library().mnt_pcx_rle(ptr(buf), buf.size, nbytes, h,
                                    ptr(out), ptr(err)) < 0:
        raise OSError("image file is truncated")
    if err[0]:
        raise OSError("buffer overrun when reading image file")
    return out


def _pcx_rle_plain(src: bytes, nbytes: int, h: int) -> np.ndarray:
    """``_pcx_rle`` in Python: PIL's ``pcx`` decoder loop. A run is cut
    at the row's end and marks the image overrun."""
    out = np.zeros((h, nbytes), np.uint8)
    row = bytearray(nbytes)
    x = y = pos = 0
    overrun = False
    n = len(src)
    while y < h:
        if pos >= n:
            raise OSError("image file is truncated")
        b = src[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise OSError("image file is truncated")
            count = b & 0x3F
            if x + count > nbytes:
                overrun = True
                count = nbytes - x
            row[x:x + count] = bytes([src[pos + 1]]) * count
            x += count
            pos += 2
        else:
            row[x] = b
            x += 1
            pos += 1
        if x >= nbytes:
            out[y] = np.frombuffer(bytes(row), np.uint8)
            x = 0
            y += 1
    if overrun:
        raise OSError("buffer overrun when reading image file")
    return out
