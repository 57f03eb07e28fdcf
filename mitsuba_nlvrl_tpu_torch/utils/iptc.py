"""An IPTC/NAA decoder (no PIL), as PIL's ``IptcImagePlugin`` reads: a
run of ``0x1C`` records (tag, then a 2-byte size or an extended one)
whose records 3:60 (layers and component), 3:20 and 3:30 (size), 3:120
(compression: 1 raw, 5 JPEG) and 3:65 (the band) describe the image
held in the 8:10 records that follow. A raw image is grey (``L``) or one
band of an ``RGB`` or ``CMYK`` image whose other bands are 0; a JPEG one
decodes through ``utils/jpeg.py``. PIL finds IPTC files by opening them
(``opens``). What PIL refuses raises PIL's class: ``OSError`` for an
illegal record length, an unknown compression or too few pixels,
``SyntaxError`` for a bad record after the image, ``ValueError`` for a
JPEG band that is not grey.
"""
from __future__ import annotations

import struct

import numpy as np

from .raw import FileView

_KINDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
_COMPRESSION = {1: 'raw', 5: 'jpeg'}


class NotIptc(Exception):
    """PIL's IPTC plugin does not open the file (it tries the next)."""


def _i(c: bytes) -> int:
    return struct.unpack('>I', (b'\0\0\0\0' + c)[-4:])[0]


def _field(data: bytes, pos: int):
    """PIL's ``field``: (tag or None, size, position after the header)."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b'\0'):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _KINDS:
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        ext = data[pos:pos + size - 128]
        pos += len(ext)
        size = _i(ext)
    else:
        size = struct.unpack_from('>H', s, 3)[0]
    return tag, size, pos


def parse(data: bytes):
    """PIL's ``IptcImageFile._open``: (mode, size, compression, band,
    offset of the 8:10 records or None). Raises ``NotIptc`` where PIL
    moves on to the next plugin, ``OSError`` where it raises."""
    try:
        info, pos = {}, 0
        while True:
            offset = pos
            tag, size, pos = _field(data, pos)
            if not tag or tag == (8, 10):
                break
            value = None
            if size:
                value = data[pos:pos + size]
                pos += len(value)
            if tag in info:
                if isinstance(info[tag], list):
                    info[tag].append(value)
                else:
                    info[tag] = [info[tag], value]
            else:
                info[tag] = value
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode, band = '', None
        if layers == 1 and not component:
            mode = 'L'
        else:
            if layers == 3 and component:
                mode = 'RGB'
            elif layers == 4 and component:
                mode = 'CMYK'
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        size = _i(info[(3, 20)]), _i(info[(3, 30)])
        try:
            compression = _COMPRESSION[_i(info[(3, 120)])]
        except KeyError as e:
            raise OSError("Unknown IPTC image compression") from e
    except (SyntaxError, IndexError, TypeError, KeyError,
            struct.error) as e:
        raise NotIptc(str(e)) from e
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise NotIptc("not identified by this driver")
    return mode, size, compression, band, \
        offset if tag == (8, 10) else None


def opens(path: str, head: bytes) -> bool:
    """Whether PIL's IPTC plugin opens the file (or raises there); the
    records past ``head`` (its first bytes) are read only if needed."""
    if head[:1] != b'\x1c':
        return False
    try:
        parse(FileView(path, head))
    except NotIptc:
        return False
    except OSError:
        return True
    return True


def read_iptc(path: str):
    """Read an IPTC file's image to ``(mode, pixels, palette)``."""
    with open(path, 'rb') as f:
        data = f.read()
    try:
        mode, (w, h), compression, band, pos = parse(data)
    except NotIptc as e:
        raise OSError(f"cannot identify image file '{path}'") from e
    if pos is None:
        raise OSError("cannot load this image")
    body = bytearray()
    while True:
        tag, size, pos = _field(data, pos)
        if tag != (8, 10):
            break
        chunk = data[pos:pos + size]
        pos += len(chunk)
        body += chunk
    if band is not None and not -len(mode) <= band < len(mode):
        raise IndexError("list assignment index out of range")
    if compression == 'raw':
        if len(body) < w * h:
            raise OSError("image file is truncated")
        inner = ('L', np.frombuffer(bytes(body[:w * h]), np.uint8)
                 .reshape(h, w).copy(), None)
    else:
        from .jpeg import decode
        try:
            inner = decode(bytes(body), path)
        except (ValueError, IndexError, KeyError, struct.error) as e:
            # PIL's JPEG plugin fails such a stream with OSError
            raise OSError(f"{path}: {e}") from e
    if band is None:
        return inner
    if inner[0] != 'L':
        raise ValueError("mode mismatch")
    px = inner[1]
    out = np.zeros(px.shape + (len(mode),), np.uint8)
    out[..., band] = px
    return mode, out, None
