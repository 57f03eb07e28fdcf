"""A Windows Paint (MSP) decoder in numpy (no PIL), as PIL's
``MspImagePlugin`` reads: mode ``1`` (a set bit white), version 1
(``DanM``) raw rows, version 2 (``LinS``) rows coded by a row map of
byte counts and runs (``0 n v``: n copies of v; ``n`` then n bytes: a
copy). PIL appends each row's output (an empty row: a white one) to one
stream and reads the image from it, so a row that codes more or fewer
bytes than the width shifts the rows after it. The header's words must
XOR to 0. The RLE runs in ``native/bitmap_raster.cpp`` (``_msp_rle``);
``_msp_rle_plain`` is its plain version. A short file raises
``OSError`` and too short a stream ``ValueError``, as in PIL.
"""
from __future__ import annotations

import struct

import numpy as np

from .raw import raw_image, unpack


def read_msp(path: str):
    """Read an MSP file to ``('1', (H, W) uint8 0 or 255, None)``."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 32 or data[:4] not in (b'DanM', b'LinS'):
        raise OSError(f"{path}: not an MSP file")
    words = np.frombuffer(data[:32], '<u2')
    if np.bitwise_xor.reduce(words) != 0:
        raise OSError(f"{path}: bad MSP checksum")
    w, h = struct.unpack_from('<2H', data, 4)
    if w <= 0 or h <= 0:
        raise OSError(f"{path}: cannot identify image file")
    if data[:4] == b'DanM':
        return '1', raw_image(data, 32, w, h, '1'), None
    if len(data) < 32 + 2 * h:
        raise OSError("Truncated MSP file in row map")
    rowmap = np.frombuffer(data, '<u2', h, 32).astype(np.int64)
    nbytes = (w + 7) // 8
    stream = _msp_rle(data[32 + 2 * h:], rowmap, nbytes, h * nbytes)
    if stream is None:
        raise ValueError("not enough image data")
    return '1', unpack(stream.reshape(h, nbytes), '1', w), None


def _msp_rle(src: bytes, rowmap: np.ndarray, nbytes: int,
             need: int):
    """The first ``need`` bytes of the stream that PIL's MSP decoder
    makes of the rows in ``src`` (``rowmap``: each row's bytes), or None
    where it makes fewer; in ``native/bitmap_raster.cpp``. Fails as
    ``_msp_rle_plain`` does."""
    from ..native import bitmap_library, ptr
    buf = np.frombuffer(src, np.uint8)
    rows = np.ascontiguousarray(rowmap, np.int64)
    out = np.zeros(need, np.uint8)
    got = bitmap_library().mnt_msp_rle(ptr(buf), buf.size, ptr(rows),
                                       rows.size, nbytes, ptr(out), need)
    if got == -1:
        raise OSError("Truncated MSP file")
    if got == -2:
        raise OSError("Corrupted MSP file")
    return out if got >= need else None


def _msp_rle_plain(src: bytes, rowmap: np.ndarray, nbytes: int,
                   need: int):
    """``_msp_rle`` in Python: PIL's ``MspDecoder`` loop."""
    out = bytearray()
    pos = 0
    for rowlen in rowmap.tolist():
        if rowlen == 0:
            out += b'\xff' * nbytes
            continue
        row = src[pos:pos + rowlen]
        pos += len(row)
        if len(row) != rowlen:
            raise OSError("Truncated MSP file")
        idx = 0
        while idx < rowlen:
            runtype = row[idx]
            idx += 1
            if runtype == 0:
                if idx + 2 > rowlen:
                    raise OSError("Corrupted MSP file")
                out += row[idx + 1:idx + 2] * row[idx]
                idx += 2
            else:
                out += row[idx:idx + runtype]
                idx += runtype
        if len(out) > need:
            del out[need:]
    if len(out) < need:
        return None
    return np.frombuffer(bytes(out), np.uint8).copy()
