"""A SPIDER decoder (no PIL), as PIL's ``SpiderImagePlugin`` reads: a
2D image of float32 samples (mode ``F``), big- or little-endian (the
header's 27 floats tried big-endian first), after its header of
``labrec * lenbyt`` bytes; an image stack yields its first image, after
the stack's header and the image's own. PIL finds SPIDER files by
opening them (``opens``); a header PIL takes for a stack image of its
own but no stack raises ``AttributeError`` there, as here.
"""
from __future__ import annotations

import struct

from .raw import raw_image

_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _header_len(t: tuple) -> int:
    """PIL's ``isSpiderHeader``: the header's bytes, or 0."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


def _open(head: bytes):
    """(size, offset, big-endian) as PIL's open finds them, or None where
    it moves on to the next plugin."""
    if len(head) < 108:
        return None
    big = True
    t = struct.unpack('>27f', head[:108])
    hdrlen = _header_len(t)
    if hdrlen == 0:
        big = False
        t = struct.unpack('<27f', head[:108])
        hdrlen = _header_len(t)
    if hdrlen == 0:
        return None
    h = (99,) + t
    if int(h[5]) != 1:
        return None
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise AttributeError(
            "'SpiderImageFile' object has no attribute 'stkoffset'")
    else:
        return None
    if size[0] <= 0 or size[1] <= 0:
        return None
    return size, offset, big


def opens(path: str, head: bytes) -> bool:
    """Whether PIL's SPIDER plugin opens the file (or raises there)."""
    try:
        return _open(head) is not None
    except AttributeError:
        return True


def read_spider(path: str):
    """Read a SPIDER file to ``('F', (H, W) float32, None)``."""
    with open(path, 'rb') as f:
        data = f.read()
    found = _open(data[:108])
    if found is None:
        raise OSError(f"cannot identify image file '{path}'")
    (w, h), offset, big = found
    return 'F', raw_image(data, offset, w, h,
                          'F;32BF' if big else 'F;32F'), None
