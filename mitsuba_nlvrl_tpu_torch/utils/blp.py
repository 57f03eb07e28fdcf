"""A Blizzard Mipmap (BLP) decoder (no PIL), as PIL's ``BlpImagePlugin``
reads the first mipmap: BLP1 JPEG (the shared JPEG header ahead of the
mipmap, decoded by ``utils/jpeg.py``; PIL hands its RGB bytes on as BGR,
so red and blue trade places) and BLP1 and BLP2 palette images (a
256-entry BGRA palette; alpha from it where the header says the image
has alpha), and BLP2 DXT1, DXT3 and DXT5 (through ``dds._bcn`` with
PIL's own colour expansion, 5 and 6 bits shifted up without
replication). The mode is ``RGBA`` where the header's alpha depth is not
0, else ``RGB``; PIL decodes DXT blocks a row of blocks at a time and
reads the image from that stream at the image's width, so widths that
are no multiple of 4 shear, and DXT3 and DXT5 pixels (4 bytes each) read
as ``RGB`` slip, as there. What PIL refuses raises PIL's class:
``BLPFormatError`` (a ``NotImplementedError``) for an unknown
compression or encoding, ``OSError`` for a short file, ``ValueError``
where the pixels fall short, ``SyntaxError`` for a JPEG mipmap that is
not one.
"""
from __future__ import annotations

import struct

import numpy as np


class BLPFormatError(NotImplementedError):
    """PIL's error for a BLP compression or encoding it does not read."""


def _read(data: bytes, pos: int, n: int):
    """PIL's ``_safe_read``: n bytes from ``pos`` or ``OSError``."""
    if n <= 0:
        return b'', pos
    out = data[pos:pos + n]
    if len(out) < n:
        raise OSError("Truncated File Read")
    return out, pos + n


def _palette(data: bytes, pos: int):
    """The 256 BGRA entries at ``pos`` as (256, 4) RGBA; PIL stops at the
    file's end with ``OSError``."""
    raw, pos = _read(data, pos, 1024)
    bgra = np.frombuffer(raw, np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3]], pos


def _as_raw(stream: np.ndarray, w: int, h: int, c: int) -> np.ndarray:
    """PIL's ``set_as_raw``: the image read from a flat byte stream."""
    need = w * h * c
    if stream.size < need:
        raise ValueError("not enough image data")
    return stream[:need].reshape(h, w, c)


def read_blp(path: str):
    """Read a BLP file to ``(mode, pixels, None)``: ``RGB`` (H, W, 3) or
    ``RGBA`` (H, W, 4), uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    magic = data[:4]
    if magic not in (b'BLP1', b'BLP2'):
        raise OSError(f"{path}: not a BLP file")
    try:
        compression = struct.unpack_from('<i', data, 4)[0]
        if magic == b'BLP1':
            alpha = struct.unpack_from('<I', data, 8)[0] != 0
            w, h = struct.unpack_from('<II', data, 12)
            encoding = struct.unpack_from('<i', data, 20)[0]
            offset = 28
        else:
            encoding, alpha, alpha_encoding = struct.unpack_from(
                '<3b', data, 8)
            alpha = alpha != 0
            w, h = struct.unpack_from('<II', data, 12)
            offset = 20
    except struct.error as e:
        raise OSError(f"cannot identify image file '{path}'") from e
    if w <= 0 or h <= 0:
        raise OSError(f"cannot identify image file '{path}'")
    mode = 'RGBA' if alpha else 'RGB'
    c = len(mode)
    pos = offset + 128
    if len(data) < pos:
        raise OSError("Truncated BLP file")
    offsets = struct.unpack_from('<16I', data, offset)
    lengths = struct.unpack_from('<16I', data, offset + 64)
    if magic == b'BLP1':
        if compression == 0:
            return mode, _blp1_jpeg(data, pos, offsets, lengths, w, h, c,
                                    path), None
        if compression != 1 or encoding not in (4, 5):
            raise BLPFormatError(
                f"Unsupported BLP compression or encoding {encoding!r}")
        pal, pos = _palette(data, pos)
        return mode, _indexed(data, pos, lengths[0], pal, w, h, c), None
    pal, _ = _palette(data, pos)
    if compression != 1:
        raise BLPFormatError(
            f"Unknown BLP compression {compression!r}")
    pos = offsets[0]
    if encoding == 1:
        return mode, _indexed(data, pos, lengths[0], pal, w, h, c), None
    if encoding != 2:
        raise BLPFormatError(f"Unknown BLP encoding {encoding!r}")
    n = {0: 1, 1: 2, 7: 3}.get(alpha_encoding)
    if n is None:
        raise BLPFormatError(
            f"Unsupported alpha encoding {alpha_encoding!r}")
    bw, bh = (w + 3) // 4, (h + 3) // 4
    size = 8 if n == 1 else 16
    blocks, _ = _read(data, pos, bw * bh * size)
    from .dds import _bcn
    rgba = _bcn(blocks, 4 * bw, 4 * bh, n, False, path, True)  # BLP's colours
    per = 4 if (n != 1 or alpha) else 3
    stream = np.ascontiguousarray(rgba[..., :per]).reshape(-1)
    return mode, _as_raw(stream, w, h, c), None


def _indexed(data, pos, length, pal, w, h, c):
    """PIL's ``_read_bgra``: ``length`` palette indices from ``pos``."""
    idx, _ = _read(data, pos, length)
    stream = pal[np.frombuffer(idx, np.uint8)][:, :c].reshape(-1)
    return _as_raw(stream, w, h, c)


def _blp1_jpeg(data, pos, offsets, lengths, w, h, c, path):
    """A BLP1 JPEG mipmap: its header, then the mipmap's bytes, decoded
    and handed on with red and blue swapped (PIL's ``BGR`` raw mode)."""
    from .jpeg import decode
    raw, pos = _read(data, pos, 4)
    head, pos = _read(data, pos, struct.unpack('<I', raw)[0])
    _, pos = _read(data, pos, offsets[0] - pos)
    body, pos = _read(data, pos, lengths[0])
    if (head + body)[:3] != b'\xff\xd8\xff':
        raise SyntaxError("not a JPEG file")
    try:
        jmode, px, _ = decode(head + body, path)
    except (ValueError, IndexError, KeyError, struct.error) as e:
        # PIL's JPEG plugin fails such a stream with OSError
        raise OSError(f"{path}: {e}") from e
    from ..texture import _pil_rgb
    rgb = _pil_rgb(jmode, px)
    stream = np.ascontiguousarray(rgb[..., ::-1]).reshape(-1)
    if c == 3:
        return _as_raw(stream, w, h, 3)
    bgr = _as_raw(stream, w, h, 3)
    return np.concatenate([bgr, np.full((h, w, 1), 255, np.uint8)], -1)
