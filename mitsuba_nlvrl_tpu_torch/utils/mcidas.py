"""A McIDAS area file decoder (no PIL), as PIL's ``McIdasImagePlugin``
reads: a 256-byte area descriptor of 64 big-endian words, then rows at
the descriptor's offset and stride, 1 (mode ``L``), 2 (``I;16B``) or 4
(``I``, big-endian) bytes a pixel. PIL maps the file for ``L`` and
``I;16B``: where the rows at the stride fit in the file they are read
in place, a stride shorter than a row overlapping them. Another depth
raises ``OSError``, as in PIL (which moves on to the next plugin).
"""
from __future__ import annotations

import struct

from .raw import raw_image

_MODES = {1: ('L', 'L'), 2: ('I;16B', 'I;16B'), 4: ('I', 'I;32B')}


def read_mcidas(path: str):
    """Read a McIDAS area file to ``(mode, (H, W) pixels, None)``."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 256 or data[:8] != b'\0\0\0\0\0\0\0\4':
        raise OSError(f"{path}: not an McIdas area file")
    w = (0,) + struct.unpack_from('>64i', data)
    if w[11] not in _MODES or w[10] <= 0 or w[9] <= 0:
        raise OSError(f"{path}: unsupported McIdas format")
    mode, rawmode = _MODES[w[11]]
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]
    return mode, raw_image(data, offset, w[10], w[9], rawmode, stride, 1,
                           mapped=mode != 'I'), None
