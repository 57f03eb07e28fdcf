"""An XV thumbnail decoder (no PIL), as PIL's ``XVThumbImagePlugin``
reads: ``P7 332``, comment lines, the ``width height`` line, then one
byte a pixel through the 3-3-2 palette PIL builds (mode ``P``). A short
file raises ``ValueError`` (PIL maps the file), as in PIL.
"""
from __future__ import annotations

import numpy as np

from .raw import raw_image

_R, _G, _B = np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                         indexing='ij')
PALETTE = np.stack([_R * 255 // 7, _G * 255 // 7, _B * 255 // 3],
                   -1).reshape(256, 3).astype(np.uint8)


def read_xvthumb(path: str):
    """Read an XV thumbnail to ``('P', (H, W) uint8, palette)``."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:6] != b'P7 332':
        raise OSError(f"{path}: not an XV thumbnail file")
    pos = data.find(b'\n', 6)
    pos = len(data) if pos < 0 else pos + 1
    while True:
        end = data.find(b'\n', pos)
        end = len(data) if end < 0 else end + 1
        s, pos = data[pos:end], end
        if not s:
            raise OSError(f"{path}: Unexpected EOF reading XV thumbnail")
        if s[0] != 35:
            break
    w, h = (int(v) for v in s.strip().split(maxsplit=2)[:2])
    if w <= 0 or h <= 0:
        raise OSError(f"cannot identify image file '{path}'")
    return 'P', raw_image(data, pos, w, h, 'P', mapped=True), PALETTE
