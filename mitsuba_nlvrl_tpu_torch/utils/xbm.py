"""An X11 bitmap (XBM) decoder (no PIL), as PIL's ``XbmImagePlugin``
reads: the ``_width`` and ``_height`` defines (and an optional hot spot)
in the file's first 512 bytes, up to ``_bits[]``, then one byte a group
of eight pixels, least significant bit first, mode ``1`` with a set bit
white, as PIL's ``xbm`` decoder reads them: it skips to each ``x`` and
takes the two characters after it as hex digits (any other character
counts as 0). A file that ends before the last row raises ``OSError``.
"""
from __future__ import annotations

import re

import numpy as np

from .raw import unpack

_HEAD = re.compile(
    rb'\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+'
    rb'#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+'
    rb'(?P<hotspot>'
    rb'#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+'
    rb'#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+'
    rb')?'
    rb'[\000-\377]*_bits\[]')
_HEX = np.zeros(256, np.uint8)
for _c in b'0123456789':
    _HEX[_c] = _c - 48
for _c in b'abcdef':
    _HEX[_c] = _c - 87
    _HEX[_c - 32] = _c - 87


def read_xbm(path: str):
    """Read an XBM file to ``('1', (H, W) uint8 0 or 255, None)``."""
    with open(path, 'rb') as f:
        data = f.read()
    m = _HEAD.match(data[:512])
    if not m or int(m.group('width')) <= 0 or int(m.group('height')) <= 0:
        raise OSError(f"cannot identify image file '{path}'")
    w, h = int(m.group('width')), int(m.group('height'))
    nbytes = (w + 7) // 8
    body = np.frombuffer(data, np.uint8)
    xs = np.flatnonzero(body[m.end():] == ord('x')) + m.end()
    need = h * nbytes
    if len(xs) and (np.diff(xs) >= 3).all():
        take = xs[:need]
    else:                                   # an x inside a byte's digits
        take, nxt = [], 0
        for p in xs.tolist():
            if p >= nxt:
                take.append(p)
                nxt = p + 3
                if len(take) == need:
                    break
        take = np.asarray(take, np.int64)
    if len(take) < need or (need and take[-1] + 2 >= len(body)):
        raise OSError("image file is truncated")
    vals = (_HEX[body[take + 1]] << 4) | _HEX[body[take + 2]]
    return '1', unpack(vals.astype(np.uint8).reshape(h, nbytes), '1;R',
                       w), None
