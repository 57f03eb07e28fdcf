"""An FTEX (Independence War 2 texture) decoder in numpy (no PIL), as
PIL's ``FtexImagePlugin`` reads: a file of one format, whose first mipmap
is DXT1 (mode ``RGBA``, through ``dds._bcn``) or 24-bit RGB. Another
format count raises ``AssertionError`` (PIL's open asserts one), another
format ``ValueError``, and a mipmap shorter than the image ``OSError``,
as in PIL.
"""
from __future__ import annotations

import struct

from .raw import raw_image


def read_ftex(path: str):
    """Read an FTEX file to ``(mode, pixels, None)``: ``RGBA`` (H, W, 4)
    or ``RGB`` (H, W, 3), uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 24 or data[:4] != b'FTEX':
        raise OSError(f"{path}: not an FTEX file")
    w, h, _, count = struct.unpack_from('<4i', data, 8)
    if count != 1:
        raise AssertionError(f"{path}: an FTEX file of {count} formats")
    if len(data) < 32:
        raise OSError(f"{path}: not an FTEX file")
    fmt, where = struct.unpack_from('<2i', data, 24)
    if where < 0:
        raise OSError(f"{path}: [Errno 22] Invalid argument")
    head = data[where:where + 4]
    if len(head) < 4:
        raise OSError(f"{path}: cannot identify image file")
    size = struct.unpack('<i', head)[0]
    if size < -1:
        raise ValueError("read length must be non-negative or -1")
    mip = data[where + 4:where + 4 + size] if size >= 0 else \
        data[where + 4:]
    if fmt not in (0, 1):
        raise ValueError(f"Invalid texture compression format: {fmt!r}")
    if w <= 0 or h <= 0:
        # PIL has closed the file by then: the next plugin cannot seek it
        raise ValueError("seek of closed file")
    if fmt == 0:
        from .dds import _bcn
        return 'RGBA', _bcn(mip, w, h, 1, False, path), None
    return 'RGB', raw_image(mip, 0, w, h, 'RGB'), None
