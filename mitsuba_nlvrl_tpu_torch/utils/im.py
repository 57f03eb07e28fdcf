"""A LabEye IM (IFUNC Image Memory) decoder in numpy (no PIL), as PIL's
``ImImagePlugin`` reads: a text header of ``key: value`` lines ended by
a 0x1A byte, an optional 768-byte LUT, then the first frame's rows
bottom-up in the raw mode PIL's ``OPEN`` table gives the image type
(``1``; ``L`` and ``P`` of 2 and 4 bits; ``LA``, ``RGB``, ``RGBA``,
``RGBX``, ``CMYK`` and ``YCbCr`` line-interleaved; ``I`` and ``F`` of 8
to 32 bits, through PIL's ``bit`` decoder for depths other than 8, 16 and
32; ``I;16`` in both byte orders; planar ``RGB3``, whose first plane PIL
reads as green, then red, then blue). A LUT that is not a grey ramp makes
``L`` a palette image (``P``, or ``PA`` from ``LA``). PIL finds IM files
by opening them (``opens``). What PIL refuses raises PIL's class: an
image type PIL has no raw mode for (``RLB``, ``PA``) ``ValueError``, a
short file ``OSError`` or, where PIL maps the file, ``ValueError``.
"""
from __future__ import annotations

import re

import numpy as np

from .raw import FileView, known, raw_image

OPEN = {
    '0 1 image': ('1', '1'), 'L 1 image': ('1', '1'),
    'Greyscale image': ('L', 'L'), 'Grayscale image': ('L', 'L'),
    'RGB image': ('RGB', 'RGB;L'), 'RLB image': ('RGB', 'RLB'),
    'RYB image': ('RGB', 'RLB'), 'B1 image': ('1', '1'),
    'B2 image': ('P', 'P;2'), 'B4 image': ('P', 'P;4'),
    'X 24 image': ('RGB', 'RGB'), 'L 32 S image': ('I', 'I;32'),
    'L 32 F image': ('F', 'F;32'), 'RGB3 image': ('RGB', 'RGB;T'),
    'RYB3 image': ('RGB', 'RYB;T'), 'LA image': ('LA', 'LA;L'),
    'PA image': ('LA', 'PA;L'), 'RGBA image': ('RGBA', 'RGBA;L'),
    'RGBX image': ('RGB', 'RGBX;L'), 'CMYK image': ('CMYK', 'CMYK;L'),
    'YCC image': ('YCbCr', 'YCbCr;L'),
}
for _i in ('8', '8S', '16', '16S', '32', '32F'):
    OPEN[f'L {_i} image'] = ('F', f'F;{_i}')
    OPEN[f'L*{_i} image'] = ('F', f'F;{_i}')
for _i in ('16', '16L', '16B'):
    OPEN[f'L {_i} image'] = (f'I;{_i}', f'I;{_i}')
    OPEN[f'L*{_i} image'] = (f'I;{_i}', f'I;{_i}')
OPEN['L 32S image'] = ('I', 'I;32S')
OPEN['L*32S image'] = ('I', 'I;32S')
for _j in range(2, 33):
    OPEN[f'L*{_j} image'] = ('F', f'F;{_j}')

_TAGS = ('Comment', 'Date', 'Digitalization equipment',
         'File size (no of images)', 'Lut', 'Name', 'Scale (x,y)',
         'Image size (x*y)', 'Image type')
_SPLIT = re.compile(rb'^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$')
_MODES = ('1', 'L', 'P', 'LA', 'PA', 'RGB', 'RGBA', 'CMYK', 'YCbCr', 'I',
          'F', 'I;16', 'I;16L', 'I;16B')


class NotIm(Exception):
    """PIL's IM plugin does not open the file (it tries the next)."""


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def parse(data: bytes):
    """PIL's ``ImImageFile._open``: (mode, rawmode, size, LUT or None,
    offset of the pixels). Raises ``NotIm`` where PIL moves on."""
    if b'\n' not in data[:100]:
        raise NotIm("not an IM file")
    info = {'Image type': 'L', 'Image size (x*y)': (512, 512)}
    rawmode, n, pos, s = 'L', 0, 0, b''
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b'\r':
            continue
        if not s or s == b'\0' or s == b'\x1a':
            break
        end = data.find(b'\n', pos)
        end = len(data) if end < 0 else end + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            raise NotIm("not an IM file")
        if s.endswith(b'\r\n'):
            s = s[:-2]
        elif s.endswith(b'\n'):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise NotIm("Syntax error in IM header")
        k, v = (g.decode('latin-1', 'replace') for g in m.group(1, 2))
        if k in ('File size (no of images)', 'Scale (x,y)',
                 'Image size (x*y)'):
            v = tuple(map(_number, v.replace('*', ',').split(',')))
            if len(v) == 1:
                v = v[0]
        elif k == 'Image type' and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        if k in _TAGS:
            n += 1
    if not n:
        raise NotIm("Not an IM file")
    size, mode = info['Image size (x*y)'], info['Image type']
    try:
        if size[0] <= 0 or size[1] <= 0 or not mode:
            raise NotIm("not identified by this driver")
    except (TypeError, IndexError) as e:
        raise NotIm("bad image size") from e
    while s and not s.startswith(b'\x1a'):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        raise NotIm("File truncated")
    lut = None
    if 'Lut' in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        grey = True
        try:                  # PIL's chained test reads no further
            for i in range(256):
                if not lut[i] == lut[i + 256] == lut[i + 512]:
                    grey = False
        except IndexError as e:
            raise NotIm("short LUT") from e
        if mode in ('L', 'LA', 'P', 'PA') and not grey:
            if mode in ('L', 'P'):
                mode = rawmode = 'P'
            else:
                mode, rawmode = 'PA', 'PA;L'
        else:
            lut = None
    return mode, rawmode, size, lut, pos


def opens(path: str, head: bytes) -> bool:
    """Whether PIL's IM plugin opens the file (``head``: its first
    bytes; the header is read from a ``raw.FileView``, which reads the
    rest of the file only where the header runs past them)."""
    try:
        parse(FileView(path, head))
    except NotIm:
        return False
    return True


def read_im(path: str):
    """Read an IM file to ``(mode, pixels, palette)`` as PIL opens it."""
    with open(path, 'rb') as f:
        data = f.read()
    try:
        mode, rawmode, size, lut, offs = parse(data)
    except NotIm as e:
        raise OSError(f"cannot identify image file '{path}'") from e
    if len(size) != 2:
        raise TypeError("the size must be a pair")
    w, h = size
    if not all(isinstance(v, int) for v in (w, h)):
        raise TypeError("'float' object cannot be interpreted as an integer")
    if mode not in _MODES:
        raise ValueError("unrecognized image mode")
    palette = None
    if lut is not None:                 # three planes, cut at the file's end
        n = len(lut) // 3
        palette = np.frombuffer(lut, np.uint8, 3 * n).reshape(3, n).T.copy()
    if rawmode.startswith('F;') and rawmode[2:].isdigit() and \
            int(rawmode[2:]) not in (8, 16, 32):
        return mode, _bits(data, offs, w, h, int(rawmode[2:])), palette
    if rawmode in ('RGB;T', 'RYB;T'):
        size = w * h
        planes = [raw_image(data, offs + k * size, w, h, 'L', 0, -1)
                  for k in range(3)]
        g, r, b = planes
        return mode, np.stack([r, g, b], -1), palette
    if not known(rawmode) or (mode == 'LA' and rawmode == 'PA;L'):
        raise ValueError("unknown raw mode for given image mode")
    mapped = rawmode == mode and mode in ('L', 'P', 'I;16', 'I;16L',
                                          'I;16B')
    px = raw_image(data, offs, w, h, rawmode, 0, -1, mapped=mapped)
    if mode == 'I' and px.dtype != np.int32:
        px = px.astype(np.int32)
    return mode, px, palette


def _bits(data: bytes, offs: int, w: int, h: int, bits: int) -> np.ndarray:
    """PIL's ``bit`` decoder with IM's arguments (``bits``, rows padded to
    bytes, bits filled and taken LSB first, unsigned, bottom-up): each
    row's samples are taken from a bit buffer that is not cleared
    between rows (only its count is), so the bits left over at a row's
    end are or-ed into the next row's first byte, as there."""
    out = np.zeros((h, w), np.float32)
    mask = (1 << bits) - 1
    buf = count = 0
    x, y, pos = 0, h - 1, offs
    while pos < len(data):
        byte = data[pos]
        pos += 1
        buf |= byte << count
        count += 8
        while count >= bits:
            v = buf & mask
            if count > 32:
                buf = byte >> (8 - (count - bits))
            else:
                buf >>= bits
            count -= bits
            out[y, x] = v
            x += 1
            if x >= w:
                y -= 1
                if y < 0:
                    return out
                x = 0
                count = 0
    raise OSError("image file is truncated")
