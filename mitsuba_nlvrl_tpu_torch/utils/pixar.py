"""A PIXAR raster decoder (no PIL), as PIL's ``PixarImagePlugin`` reads:
a 512-byte header whose layout words (14, 2) mean 8-bit RGB, read raw
from byte 1,024. Any other layout is not opened, as in PIL.
"""
from __future__ import annotations

import struct

from .raw import raw_image


def read_pixar(path: str):
    """Read a PIXAR file to ``('RGB', (H, W, 3) uint8, None)``."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 428 or data[:4] != b'\x80\xe8\0\0':
        raise OSError(f"cannot identify image file '{path}'")
    h, w = struct.unpack_from('<2H', data, 416)
    if struct.unpack_from('<2H', data, 424) != (14, 2) or w <= 0 or h <= 0:
        raise OSError(f"cannot identify image file '{path}'")
    return 'RGB', raw_image(data, 1024, w, h, 'RGB'), None
