"""Windows icons (ICO) and cursors (CUR) without PIL, as PIL's
``IcoImagePlugin`` and ``CurImagePlugin`` open them.

ICO: PIL sorts the directory by colour depth, then (stably) by area, the
largest first, and opens the first entry: a PNG as PIL opens that PNG
(``utils/io.decode_png``), or a DIB (``utils/bmp.decode_dib``, its height
halved) converted to ``RGBA``, its alpha from the pixel rows' fourth
bytes where the directory says 32 bits, else from the AND mask (1 bit a
pixel, rows padded to 32 bits, bottom up, a set bit transparent) that
ends the entry's bytes. CUR: the first entry, replaced by each later one
larger in both width and height bytes, opened as a DIB with its height
halved and neither mask nor alpha.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from .bmp import decode_dib


def _png(data: bytes, path: str):
    """A PNG icon as PIL opens it; broken data fails as PIL's reader does
    (``OSError``)."""
    import zlib
    from ..texture import _png_mode
    from .io import decode_png
    try:
        return _png_mode(decode_png(data, path)) + (None,)
    except (zlib.error, ValueError, IndexError, KeyError,
            struct.error) as e:
        raise OSError(f"{path}: broken PNG icon: {e}") from e


def rgba(mode: str, px: np.ndarray, palette) -> np.ndarray:
    """PIL's ``convert('RGBA')`` of an icon's mode: its alpha where it has
    one (``LA``, ``PA``, ``RGBA``), else opaque."""
    from ..texture import _pil_rgb
    alpha = px[..., -1] if mode in ('LA', 'PA', 'RGBA') else \
        np.full(px.shape[:2], 255, np.uint8)
    return np.concatenate([_pil_rgb(mode, px, palette), alpha[..., None]],
                          -1)


def _entries(data: bytes, path: str):
    if len(data) < 6:
        raise OSError(f"{path}: not an icon file")
    n = struct.unpack_from('<H', data, 4)[0]
    if len(data) < 6 + 16 * n:
        raise OSError(f"{path}: icon directory cut short")
    return [data[6 + 16 * k:22 + 16 * k] for k in range(n)]


def read_ico(path: str):
    """Read an ICO file to ``(mode, pixels, palette)`` as PIL opens it."""
    with open(path, 'rb') as f:
        data = f.read()
    entries = []
    for e in _entries(data, path):
        w, h, ncol = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack_from('<HII', e, 6)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        entries.append((w, h, bpp, size, offset, depth))
    if not entries:
        raise OSError(f"{path}: an icon file without icons")
    entries.sort(key=lambda x: x[5])
    entries.sort(key=lambda x: x[0] * x[1], reverse=True)
    w, h, bpp, size, offset, _ = entries[0]
    if data[offset:offset + 8] == b'\x89PNG\r\n\x1a\n':
        return _png(data[offset:], path)

    def mask(start, W, H):
        """PIL's alpha: the fourth bytes where the directory says 32
        bits, else the AND mask that ends the entry (both bottom up)."""
        if bpp == 32:
            a = np.frombuffer(data[start:start + W * H * 4][3::4], np.uint8)
            if a.size < W * H:
                raise ValueError("buffer is not large enough")
            return a.reshape(H, W)[::-1]
        stride = -(-W // 32) * 4
        total = stride * H
        at = offset + size - total
        if at < 0:
            raise ValueError("negative seek value")
        bits = np.frombuffer(data[at:at + total], np.uint8)
        if bits.size < total:
            raise ValueError("not enough image data")
        rows = np.unpackbits(bits.reshape(H, stride), axis=1)[:, :W]
        return np.where(rows[::-1] == 1, 0, 255).astype(np.uint8)
    mode, px, palette, alpha = decode_dib(data, offset, path, mask)
    out = rgba(mode, px, palette)
    out[..., 3] = alpha
    return 'RGBA', out, None


def read_cur(path: str):
    """Read a CUR file to ``(mode, pixels, palette)`` as PIL opens it."""
    with open(path, 'rb') as f:
        data = f.read()
    best = None
    for e in _entries(data, path):
        if best is None or (e[0] > best[0] and e[1] > best[1]):
            best = e
    if best is None:
        raise OSError(f"{path}: no cursors were found")
    return decode_dib(data, struct.unpack_from('<I', best, 12)[0], path)[:3]
