"""An X11 pixmap (XPM) decoder (no PIL), as PIL's ``XpmImagePlugin``
reads: the ``"w h colours chars"`` line, one line a colour (``c`` and a
``#`` hex value; ``None`` marks the transparent key, which PIL leaves
out of the palette, so a pixel of it fails; a colour name fails), then
the pixel lines between their quotes, an optional ``/* pixels */`` line
skipped. Up to 256 colours give mode ``P``, more ``RGB``. What PIL
refuses raises PIL's class (``ValueError`` for a colour it cannot read,
a key missing from the palette or too few pixels; ``KeyError`` for an
RGB image's missing key).
"""
from __future__ import annotations

import re

import numpy as np

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _lines(data: bytes, pos: int):
    """PIL's ``readline`` from ``pos``: (line, position after it)."""
    end = data.find(b'\n', pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def _colours(data: bytes, pos: int, ncolours: int, bpp: int):
    """The colour lines of PIL's open: {key: RGB bytes} (``None`` keys
    left out) and the position after them."""
    palette = {}
    for _ in range(ncolours):
        line, pos = _lines(data, pos)
        line = line.rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b'c':
                rgb = s[i + 1]
                if rgb == b'None':
                    pass
                elif rgb.startswith(b'#'):
                    v = int(rgb[1:], 16)
                    palette[c] = bytes([(v >> 16) & 255, (v >> 8) & 255,
                                        v & 255])
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    return palette, pos


def read_xpm(path: str):
    """Read an XPM file to ``(mode, pixels, palette)``: ``P`` ((H, W) and
    an (N, 3) palette) or ``RGB`` ((H, W, 3)), uint8."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:9] != b'/* XPM */':
        raise OSError(f"{path}: not an XPM file")
    pos = 9
    while True:
        line, pos = _lines(data, pos)
        if not line:
            raise OSError(f"{path}: broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    w, h, ncolours, bpp = (int(g) for g in m.groups())
    try:
        palette, pos = _colours(data, pos, ncolours, bpp)
    except (IndexError, KeyError, TypeError) as e:
        # PIL's open turns these into a failed open
        raise OSError(f"cannot identify image file '{path}'") from e
    if w <= 0 or h <= 0:
        raise OSError(f"cannot identify image file '{path}'")
    rgb_mode = ncolours > 256
    keys = list(palette)
    index = {k: i for i, k in reversed(list(enumerate(keys)))}
    need = w * h * (3 if rgb_mode else 1)
    out = bytearray()
    header = False
    while len(out) < need:
        line, pos = _lines(data, pos)
        if not line:
            break
        if line.rstrip() == b'/* pixels */' and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if rgb_mode:
                out += palette[key]
            elif key in index:
                out.append(index[key])
            else:
                raise ValueError("tuple.index(x): x not in tuple")
    if len(out) < need:
        raise ValueError("not enough image data")
    px = np.frombuffer(bytes(out[:need]), np.uint8)
    if rgb_mode:
        return 'RGB', px.reshape(h, w, 3), None
    pal = np.frombuffer(b''.join(palette.values()), np.uint8).reshape(-1, 3)
    return 'P', px.reshape(h, w), pal
