"""PIL's ``raw`` decoder and the raw modes (unpackers) of the formats that
read through it: SUN, FTEX, FITS, SPIDER, IM, IMT, MSP, XBM, GBR, McIDAS,
PIXAR, XV thumbnails and BLP's pixels.

``raw_image`` reads an image of ``h`` rows of ``w`` pixels from ``data`` at
``offset`` as PIL's decoder does: each row is the raw mode's bytes
(``(w * bits + 7) // 8``), then ``stride`` less that of padding (none
after the last row), rows top-down or, with ``ystep`` -1, bottom-up. A
file that ends before the last row raises ``OSError`` (PIL: "image file
is truncated"); a stride shorter than a row raises ``OSError`` (PIL's
decoder reports a bad configuration). ``unpack`` turns the rows into
the samples PIL holds in the image's mode.
"""
from __future__ import annotations

import os

import numpy as np

# raw mode -> (numpy dtype of one sample, samples a pixel); _BITS: the
# packed modes' bits a pixel
_BYTES = {
    'L': ('u1', 1), 'P': ('u1', 1), 'RGB': ('u1', 3), 'BGR': ('u1', 3),
    'RGBX': ('u1', 4), 'BGRX': ('u1', 4), 'RGBA': ('u1', 4),
    'LA;L': ('u1', 2), 'PA;L': ('u1', 2), 'RGB;L': ('u1', 3),
    'RGBA;L': ('u1', 4), 'RGBX;L': ('u1', 4), 'CMYK;L': ('u1', 4),
    'YCbCr;L': ('u1', 3), 'F;8': ('u1', 1), 'F;8S': ('i1', 1),
    'F;16': ('<u2', 1), 'F;16S': ('<i2', 1), 'F;32': ('<u4', 1),
    'F;32S': ('<i4', 1), 'F;32F': ('<f4', 1), 'F;32BF': ('>f4', 1),
    'F': ('<f4', 1), 'I': ('<i4', 1), 'I;32': ('<i4', 1),
    'I;32S': ('<i4', 1), 'I;32B': ('>i4', 1), 'I;16': ('<u2', 1),
    'I;16L': ('<u2', 1), 'I;16B': ('>u2', 1),
}
_BITS = {'1': 1, '1;I': 1, '1;R': 1, 'P;2': 2, 'P;4': 4, 'L;4': 4}


def row_bytes(rawmode: str, w: int) -> int:
    """The bytes of one row of ``w`` pixels in ``rawmode``."""
    if rawmode in _BITS:
        return (w * _BITS[rawmode] + 7) // 8
    dt, n = _BYTES[rawmode]
    return w * n * np.dtype(dt).itemsize


def known(rawmode: str) -> bool:
    return rawmode in _BITS or rawmode in _BYTES


def raw_rows(data: bytes, offset: int, nbytes: int, h: int,
             stride: int = 0, ystep: int = 1) -> np.ndarray:
    """The (h, nbytes) rows of PIL's raw decoder, top row first."""
    if offset < 0:
        raise OSError("[Errno 22] Invalid argument")
    if not -2 ** 31 <= stride < 2 ** 31:
        raise OverflowError("the stride is no C int")
    if stride and stride < nbytes:
        raise OSError("decoder error -8 when reading image file")
    step = stride or nbytes
    need = (h - 1) * step + nbytes if h else 0
    if len(data) - offset < need:
        raise OSError("image file is truncated")
    buf = np.frombuffer(data, np.uint8, need, offset) if need else \
        np.zeros(0, np.uint8)
    if step == nbytes:
        rows = buf.reshape(h, nbytes)
    else:
        rows = np.lib.stride_tricks.as_strided(
            buf, (h, nbytes), (step, 1)).copy()
    return rows[::-1] if ystep < 0 else rows


def unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """The samples of (h, row bytes) rows in ``rawmode``: (h, w) for one
    band (``1`` as 0 or 255), (h, w, bands) otherwise, in PIL's band order
    (``BGR`` and ``BGRX`` turned to RGB; ``X`` padding kept as the 4th
    band; line-interleaved ``;L`` modes de-interleaved)."""
    h = rows.shape[0]
    if rawmode in _BITS:
        bits = _BITS[rawmode]
        if bits == 1:
            v = np.unpackbits(rows, axis=1,
                              bitorder='little' if rawmode == '1;R'
                              else 'big')[:, :w]
            if rawmode == '1;I':
                v = 1 - v
            return (v * 255).astype(np.uint8)
        per = 8 // bits
        shifts = (8 - bits) - bits * np.arange(per)
        v = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(
            h, -1)[:, :w].astype(np.uint8)
        return v * 17 if rawmode == 'L;4' else v
    dt, n = _BYTES[rawmode]
    s = np.ascontiguousarray(rows).view(dt)
    if rawmode.endswith(';L'):                 # line interleaved
        s = s.reshape(h, n, w).transpose(0, 2, 1)
    elif n > 1:
        s = s.reshape(h, w, n)
    if rawmode in ('BGR', 'BGRX'):
        s = np.concatenate([s[..., 2::-1], s[..., 3:]], -1)
    if rawmode.startswith('F'):
        return s.astype(np.float32)
    if rawmode.startswith('I;32') or rawmode == 'I':
        return s.astype(np.int32)
    if rawmode.startswith('I;16'):
        return s.astype(np.uint16)
    return np.ascontiguousarray(s, np.uint8)


def raw_image(data: bytes, offset: int, w: int, h: int, rawmode: str,
              stride: int = 0, ystep: int = 1,
              mapped: bool = False) -> np.ndarray:
    """``unpack`` of ``raw_rows``: an image as PIL's raw decoder reads it.

    ``mapped``: PIL maps the file instead (a single raw tile of a file
    whose raw mode is the image's own ``L``, ``P`` or ``I;16``): where
    ``h`` rows of the tile's stride fit in the file, the rows are read in
    place at the stride (0: the row's bytes; a stride shorter than a row
    overlaps rows, as there), and a file too short for the rows raises
    ``ValueError`` ("buffer is not large enough"); otherwise the decoder
    reads the file as above."""
    nbytes = row_bytes(rawmode, w)
    if mapped:
        if offset < 0:
            raise ValueError("Tile offset cannot be negative")
        if offset + h * stride <= len(data):
            if not -2 ** 31 <= stride < 2 ** 31:
                raise OverflowError("the stride is no C int")
            step = stride if stride > 0 else nbytes
            if offset + h * step > len(data):
                raise ValueError("buffer is not large enough")
            buf = np.frombuffer(data, np.uint8)
            starts = offset + step * np.arange(h)[::-1 if ystep < 0 else 1]
            rows = buf[starts[:, None] + np.arange(nbytes)]
            return unpack(rows, rawmode, w)
    rows = raw_rows(data, offset, nbytes, h, stride, ystep)
    return unpack(rows, rawmode, w)


class FileView:
    """A file's bytes as the header checks of ``identify`` read them:
    slices and ``find`` answered from ``head`` (the file's first bytes)
    while they lie in it, the rest of the file read at the first one
    that does not."""

    def __init__(self, path: str, head: bytes):
        self.path, self.head, self.rest = path, head, None
        self.size = os.path.getsize(path)

    def _all(self) -> bytes:
        if self.rest is None:
            with open(self.path, 'rb') as f:
                self.rest = f.read()
        return self.rest

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, key: slice) -> bytes:
        stop = self.size if key.stop is None else key.stop
        if stop <= len(self.head) or len(self.head) == self.size:
            return self.head[key]
        return self._all()[key]

    def find(self, sub: bytes, start: int = 0) -> int:
        at = self.head.find(sub, start)
        if at >= 0 and at + len(sub) <= len(self.head) or \
                len(self.head) == self.size:
            return at
        return self._all().find(sub, start)
