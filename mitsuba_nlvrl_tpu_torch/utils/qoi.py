"""A QOI ("Quite OK Image") decoder in numpy and the bitmap library (no
PIL), as PIL's ``QoiImagePlugin`` decodes: mode ``RGB`` for 3 channels
and ``RGBA`` otherwise; every op (RGB, RGBA, INDEX, DIFF, LUMA, RUN) and
the 64-entry index hashed on RGBA, updated by every op but RUN (PIL's
decoder, unlike the format's reference, leaves a run out of the index,
and an index entry never written reads transparent black). The op loop
runs in ``native/bitmap_raster.cpp`` (``_qoi``); ``_qoi_plain`` beside it
is its plain version. A stream that ends before the image fails as PIL's
decoder does: ``IndexError`` where an op byte is missing, ``ValueError``
where an RGB or RGBA op is cut short.
"""
from __future__ import annotations

import struct

import numpy as np


def read_qoi(path: str):
    """Read a QOI file to ``(mode, pixels, None)``: ``RGB`` or ``RGBA``,
    (H, W, C) uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:4] != b'qoif' or len(data) < 14:
        raise OSError(f"{path}: not a QOI file")
    w, h = struct.unpack_from('>II', data, 4)
    c = 3 if data[12] == 3 else 4
    return ('RGB' if c == 3 else 'RGBA'), \
        _qoi(data[14:], w * h, c).reshape(h, w, c), None


_ERRORS = {-1: IndexError("index out of range"),
           -2: ValueError("not enough values to unpack")}


def _qoi(src: bytes, npix: int, channels: int) -> np.ndarray:
    """The ``npix`` pixels of the QOI ops ``src``, ``channels`` bytes
    each, in ``native/bitmap_raster.cpp``. Fails as ``_qoi_plain``
    does."""
    from ..native import bitmap_library, ptr
    buf = np.frombuffer(src, np.uint8)
    out = np.empty(npix * channels, np.uint8)
    rc = bitmap_library().mnt_qoi_decode(ptr(buf), buf.size, npix, channels,
                                         ptr(out))
    if rc < 0:
        raise _ERRORS[rc]
    return out


def _qoi_plain(src: bytes, npix: int, channels: int) -> np.ndarray:
    """``_qoi`` in Python: PIL's decoder loop."""
    seen = {}
    prev = (0, 0, 0, 255)
    out = bytearray()
    need = npix * channels
    pos, n = 0, len(src)
    while len(out) < need:
        if pos >= n:
            raise IndexError("index out of range")
        b = src[pos]
        pos += 1
        if b == 0xFE:
            if pos + 3 > n:
                raise ValueError("not enough values to unpack")
            v = (src[pos], src[pos + 1], src[pos + 2], prev[3])
            pos += 3
        elif b == 0xFF:
            if pos + 4 > n:
                raise ValueError("not enough values to unpack")
            v = tuple(src[pos:pos + 4])
            pos += 4
        elif b >> 6 == 0:
            v = seen.get(b & 63, (0, 0, 0, 0))
        elif b >> 6 == 1:
            v = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                 (prev[1] + ((b >> 2) & 3) - 2) % 256,
                 (prev[2] + (b & 3) - 2) % 256, prev[3])
        elif b >> 6 == 2:
            if pos >= n:
                raise IndexError("index out of range")
            b2 = src[pos]
            pos += 1
            dg = (b & 63) - 32
            v = ((prev[0] + dg + (b2 >> 4) - 8) % 256, (prev[1] + dg) % 256,
                 (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
        else:
            out += bytes(prev[:channels]) * ((b & 63) + 1)
            continue
        prev = v
        seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64] = v
        out += bytes(v[:channels])
    return np.frombuffer(bytes(out[:need]), np.uint8)
