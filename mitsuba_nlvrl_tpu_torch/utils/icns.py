"""Apple icon files (ICNS) without PIL, as PIL's ``IcnsImagePlugin`` opens
them: the largest size (``bestsize``: the greatest (width, height,
scale) that has an entry PIL reads) from its entries in PIL's order for
that size.

  * PNG and JPEG 2000 icons (``ic07``-``ic14``, ``icp4``-``icp6``): a PNG
    as PIL opens it (``utils/io.decode_png``), a JPEG 2000 one (JP2 or a
    raw codestream, ``utils/jp2.py``) converted to ``RGBA``, either of a
    size PIL's ``size`` setter accepts (``ValueError`` else);
  * the legacy 24-bit icons ``is32``, ``il32``, ``ih32`` and ``it32``
    (after its four zero bytes): raw RGB where the entry holds exactly
    3 bytes a pixel, else three planes of PIL's run-length code, read
    on from the entry's start; their 8-bit masks ``s8mk``, ``l8mk``,
    ``h8mk``, ``t8mk`` become alpha.
"""
from __future__ import annotations

import struct

import numpy as np

# PIL's IcnsFile.SIZES: (width, height, scale) -> its entries, in order
SIZES = {
    (512, 512, 2): (b'ic10',), (512, 512, 1): (b'ic09',),
    (256, 256, 2): (b'ic14',), (256, 256, 1): (b'ic08',),
    (128, 128, 2): (b'ic13',), (128, 128, 1): (b'ic07', b'it32', b't8mk'),
    (64, 64, 1): (b'icp6',), (32, 32, 2): (b'ic12',),
    (48, 48, 1): (b'ih32', b'h8mk'),
    (32, 32, 1): (b'icp5', b'il32', b'l8mk'), (16, 16, 2): (b'ic11',),
    (16, 16, 1): (b'icp4', b'is32', b's8mk'),
}
_RGB = (b'is32', b'il32', b'ih32', b'it32')
_MASKS = (b's8mk', b'l8mk', b'h8mk', b't8mk')


def _planes(data: bytes, pos: int, n: int) -> np.ndarray:
    """PIL's ``read_32`` run-length planes: three planes of ``n`` bytes,
    each of runs (a control byte of 0x80 or more: that minus 125 copies
    of the next byte) and literals (a control byte below 0x80: that plus
    one bytes), read from ``pos`` on."""
    planes = []
    for _ in range(3):
        out, left = [], n
        while left > 0:
            if pos >= len(data):
                break
            c = data[pos]
            pos += 1
            if c & 0x80:
                k = c - 125
                out.append(data[pos:pos + 1] * k)
                pos += 1
            else:
                k = c + 1
                out.append(data[pos:pos + k])
                pos += k
            left -= k
        if left != 0:
            raise SyntaxError(f"Error reading channel [{left!r} left]")
        plane = b''.join(out)
        if len(plane) < n:
            raise ValueError("not enough image data")
        planes.append(np.frombuffer(plane[:n], np.uint8))
    return np.stack(planes, -1)


def read_icns(path: str):
    """Read an ICNS file to ``(mode, pixels, palette)`` as PIL opens it."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 8 or data[:4] != b'icns':
        raise OSError(f"{path}: not an icns file")
    filesize = struct.unpack_from('>I', data, 4)[0]
    entries, pos = {}, 8
    while pos < filesize:
        if pos + 8 > len(data):
            raise OSError(f"{path}: icns entry header cut short")
        sig, n = struct.unpack_from('>4sI', data, pos)
        if n < 8:
            raise OSError(f"{path}: invalid block header")
        entries[sig] = (pos + 8, n - 8)
        pos += n
    sizes = [s for s, codes in SIZES.items()
             if any(c in entries for c in codes)]
    if not sizes:
        raise OSError(f"{path}: no 32bit icon resources found")
    best = max(sizes)
    w, h = best[0] * best[2], best[1] * best[2]
    rgb = alpha = None
    for code in SIZES[best]:
        if code not in entries:
            continue
        start, length = entries[code]
        if code in _MASKS:
            a = np.frombuffer(data[start:start + w * h], np.uint8)
            if a.size < w * h:
                raise ValueError("not enough image data")
            alpha = a.reshape(h, w)
        elif code in _RGB:
            if code == b'it32':
                if data[start:start + 4] != b'\0\0\0\0':
                    raise SyntaxError("Unknown signature, expecting "
                                      "0x00000000")
                start, length = start + 4, length - 4
            if length == w * h * 3:
                rgb = np.frombuffer(data[start:start + length],
                                    np.uint8).reshape(h, w, 3)
            else:
                rgb = _planes(data, start, w * h).reshape(h, w, 3)
        else:
            icon = _icon(data[start:start + length] if
                         data[start:start + 8] != b'\x89PNG\r\n\x1a\n'
                         else data[start:], path)
            _check_size(icon[1].shape[1], icon[1].shape[0], sizes)
            return icon
    if rgb is None:
        raise KeyError('RGB')
    if alpha is not None:
        return 'RGBA', np.concatenate([rgb, alpha[..., None]], -1), None
    return 'RGB', np.ascontiguousarray(rgb), None


def _check_size(w: int, h: int, sizes) -> None:
    """PIL's ``IcnsImageFile.size`` setter on an icon's size: some
    size of the file must hold it a whole number of times across and as
    many times down."""
    for sw, sh, scale in sizes:
        if w and h and (sw * scale) // w == (sh * scale) / h:
            return
    raise ValueError("This is not one of the allowed sizes of this image")


def _icon(data: bytes, path: str):
    """A PNG or JPEG 2000 icon as PIL's ``read_png_or_jpeg2000`` gives
    it."""
    if data[:8] == b'\x89PNG\r\n\x1a\n':
        from .ico import _png
        return _png(data, path)
    if data[:4] in (b'\xff\x4f\xff\x51', b'\r\n\x87\n') or \
            data[:12] == b'\0\0\0\x0cjP  \r\n\x87\n':
        from .ico import rgba
        from .jp2 import decode
        mode, px, palette = decode(data)
        if mode != 'RGBA':
            px, palette = rgba(mode, px, palette), None
        return 'RGBA', px, palette
    raise ValueError("Unsupported icon subimage format")
