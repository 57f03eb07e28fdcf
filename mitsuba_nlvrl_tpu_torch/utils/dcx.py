"""An Intel DCX decoder (no PIL), as PIL's ``DcxImagePlugin`` reads: a
magic word, up to 1,024 offsets ended by 0, and the first page, a PCX
file decoded by ``utils/pcx.py`` (its 256-colour palette looked for at
the end of the DCX file, as PIL's PCX plugin seeks it there). A file
without pages raises ``OSError``, as in PIL.
"""
from __future__ import annotations

import struct

from .pcx import decode_pcx


def read_dcx(path: str):
    """Read a DCX file's first page to ``(mode, pixels, palette)`` as
    ``utils/pcx.read_pcx`` gives a PCX file."""
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) < 8 or struct.unpack_from('<I', data)[0] != 0x3ADE68B1:
        raise OSError(f"{path}: not a DCX file")
    first = struct.unpack_from('<I', data, 4)[0]
    if not first:
        raise OSError(f"cannot identify image file '{path}'")
    return decode_pcx(data[first:], path)
