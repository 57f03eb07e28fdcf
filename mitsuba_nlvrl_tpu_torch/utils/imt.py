"""An IM Tools (IMT) decoder (no PIL), as PIL's ``ImtImagePlugin``
reads: text lines ``width N``, ``height N``, ``pixel n8`` (mode ``L``)
and ``*`` comments, then a form feed and the rows. PIL finds IMT files by
opening them (``opens``). A header without the form feed opens with no
pixels and fails to load with ``OSError``, and a short file raises
``ValueError`` (PIL maps the file), as in PIL.
"""
from __future__ import annotations

import re

from .raw import FileView, raw_image

_FIELD = re.compile(rb'([a-z]*) ([^ \r\n]*)')


def parse(data: bytes):
    """PIL's ``ImtImageFile._open``: (mode, size, offset of the pixels or
    None), or None where PIL moves on to the next plugin."""
    buffer, pos = data[:100], min(len(data), 100)
    if b'\n' not in buffer:
        return None
    w = h = 0
    mode, size, offset = '', (0, 0), None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b'\x0c':
            offset = pos - len(buffer)
            break
        if b'\n' not in buffer:
            buffer += data[pos:pos + 100]
            pos = min(len(data), pos + 100)
        lines = buffer.split(b'\n')
        s += lines.pop(0)
        buffer = b'\n'.join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b'*'):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b'width':
            w = int(v)
            size = w, h
        elif k == b'height':
            h = int(v)
            size = w, h
        elif k == b'pixel' and v == b'n8':
            mode = 'L'
    if not mode or size[0] <= 0 or size[1] <= 0:
        return None
    return mode, size, offset


def opens(path: str, head: bytes) -> bool:
    """Whether PIL's IMT plugin opens the file (``head``: its first
    bytes, the rest read only where the header runs past them)."""
    return parse(FileView(path, head)) is not None


def read_imt(path: str):
    """Read an IMT file to ``('L', (H, W) uint8, None)``."""
    with open(path, 'rb') as f:
        data = f.read()
    found = parse(data)
    if found is None:
        raise OSError(f"cannot identify image file '{path}'")
    mode, (w, h), offset = found
    if offset is None:
        raise OSError("cannot load this image")
    return mode, raw_image(data, offset, w, h, 'L', mapped=True), None
