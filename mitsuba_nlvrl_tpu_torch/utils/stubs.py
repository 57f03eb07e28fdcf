"""The formats PIL opens and cannot load with nothing installed from
outside: BUFR, GRIB and HDF5 (stub plugins without a handler), MPEG
(PIL reads only its size), EPS (PIL renders it through Ghostscript,
which the port does not run) and WMF (a stub without a handler on this
platform). Each raises PIL's class with PIL's message, ``OSError`` but
for a WMF header PIL rejects with ``ValueError`` or divides by zero on.
"""
from __future__ import annotations

import struct


def _no_loader(fmt: str):
    def read(path: str):
        raise OSError(f"cannot find loader for this {fmt} file")
    read.__name__ = f'read_{fmt.lower()}'
    read.__doc__ = f"Refuse a {fmt} file as PIL does (no loader)."
    return read


read_bufr = _no_loader('BUFR')
read_grib = _no_loader('GRIB')
read_hdf5 = _no_loader('HDF5')


def read_mpeg(path: str):
    """Refuse an MPEG file as PIL does: it has no MPEG decoder."""
    raise OSError("cannot load this image")


def read_eps(path: str):
    """Refuse an EPS file as PIL does where Ghostscript is not found."""
    raise OSError("Unable to locate Ghostscript on paths")


def read_wmf(path: str):
    """Refuse a WMF file as PIL does on a platform without its loader,
    after the header checks of PIL's open."""
    with open(path, 'rb') as f:
        s = f.read(44)
    try:
        if s.startswith(b'\xd7\xcd\xc6\x9a\0\0'):
            inch = struct.unpack_from('<H', s, 14)[0]
            if inch == 0:
                raise ValueError("Invalid inch")
            x0, y0, x1, y1 = struct.unpack_from('<4h', s, 6)
            size = (x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch
            if s[22:26] != b'\x01\x00\t\x00':
                raise OSError(f"cannot identify image file '{path}'")
        elif s.startswith(b'\1\0\0\0') and s[40:44] == b' EMF':
            x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from('<8i', s, 8)
            size = x1 - x0, y1 - y0
            # PIL works out the dpi: an empty frame divides by zero there
            2540.0 * (x1 - x0) / (f2 - f0)
            2540.0 * (y1 - y0) / (f3 - f1)
        else:
            raise OSError(f"cannot identify image file '{path}'")
    except struct.error as e:
        raise OSError(f"cannot identify image file '{path}'") from e
    if size[0] <= 0 or size[1] <= 0:
        raise OSError(f"cannot identify image file '{path}'")
    raise OSError("cannot find loader for this WMF file")
