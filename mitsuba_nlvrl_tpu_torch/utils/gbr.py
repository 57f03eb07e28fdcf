"""A GIMP brush (GBR) decoder (no PIL), as PIL's ``GbrImagePlugin``
reads: a big-endian header (its size, version 1 or 2, width, height,
bytes a pixel 1 or 4; version 2 adds ``GIMP`` and the spacing), the
comment, then the pixels: mode ``L`` or ``RGBA``. Too few pixels raise
``ValueError``, as in PIL.
"""
from __future__ import annotations

import struct

import numpy as np


def read_gbr(path: str):
    """Read a GBR file to ``(mode, pixels, None)``: ``L`` (H, W) or
    ``RGBA`` (H, W, 4), uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 20:
        raise OSError(f"cannot identify image file '{path}'")
    size, version, w, h, depth = struct.unpack_from('>5I', data)
    if size < 20 or version not in (1, 2) or w == 0 or h == 0 or \
            depth not in (1, 4) or (version == 2 and (data[20:24] != b'GIMP' or
                                             len(data) < 28)):
        raise OSError(f"cannot identify image file '{path}'")
    comment = size - (20 if version == 1 else 28)
    pos = min(len(data), 20 if version == 1 else 28)
    pos = len(data) if comment < 0 else min(len(data), pos + comment)
    need = w * h * depth
    body = data[pos:pos + need]
    if len(body) < need:
        raise ValueError("not enough image data")
    px = np.frombuffer(body, np.uint8)
    if depth == 1:
        return 'L', px.reshape(h, w), None
    return 'RGBA', px.reshape(h, w, 4), None
