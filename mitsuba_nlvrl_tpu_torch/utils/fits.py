"""A FITS decoder in numpy (no PIL), as PIL's ``FitsImagePlugin`` reads:
the primary image, or the first ``GZIP_1`` tile-compressed image of a
binary table extension, in 80-byte header cards and 2,880-byte blocks.
BITPIX 8 is mode ``L``, 16 ``I;16``, 32 ``I`` and -32 and -64 ``F``;
PIL reads the samples with the mode's own raw mode (little-endian 16 and
32-bit words and float32, so -64 reads 4 of each sample's 8 bytes), rows
bottom-up. A compressed image is one gzip stream of 4-byte words whose
last ``BITPIX / 8`` bytes PIL keeps (none for negative BITPIX, which
then fails with ``ValueError`` as in PIL).
"""
from __future__ import annotations

import gzip
import math

import numpy as np

from .raw import raw_image, unpack

_MODES = {8: 'L', 16: 'I;16', 32: 'I', -32: 'F', -64: 'F'}


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b'NAXIS'])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b'NAXIS1'])
    return int(headers[prefix + b'NAXIS1']), int(headers[prefix + b'NAXIS2'])


def _parse(headers: dict):
    """(decoder, offset, mode, size, bits) of PIL's ``_parse_headers``."""
    prefix, decoder, offset = b'', 'raw', 0
    if headers.get(b'XTENSION') == b"'BINTABLE'" and \
            headers.get(b'ZIMAGE') == b'T' and \
            headers[b'ZCMPTYPE'] == b"'GZIP_1  '":
        plain = _size(headers, prefix) or (0, 0)
        offset = plain[0] * plain[1] * (int(headers[b'BITPIX']) // 8)
        prefix, decoder = b'Z', 'fits_gzip'
    size = _size(headers, prefix)
    if not size:
        return '', 0, None, None, 0
    bits = int(headers[prefix + b'BITPIX'])
    return decoder, offset, _MODES.get(bits, ''), size, bits


def read_fits(path: str):
    """Read a FITS file to ``(mode, pixels, None)``: ``L``, ``I;16``,
    ``I`` or ``F`` (H, W)."""
    with open(path, 'rb') as f:
        data = f.read()
    headers, in_progress, decoder, pos = {}, False, '', 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise OSError(f"{path}: Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b'SIMPLE', b'XTENSION'):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b'END':
            pos = math.ceil(pos / 2880) * 2880
            if not decoder:
                try:
                    decoder, offset, mode, size, bits = _parse(headers)
                except (KeyError, IndexError) as e:
                    raise OSError(f"{path}: cannot identify image file") \
                        from e
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b'/')[0].strip()
        if value.startswith(b'='):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b'SIMPLE') or
                            value != b'T'):
            raise OSError(f"{path}: Not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError("No image data")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise OSError(f"{path}: cannot identify image file")
    w, h = size
    offset += pos - 80
    if decoder == 'raw':
        return mode, raw_image(data, offset, w, h, mode, 0, -1,
                               mapped=mode in ('L', 'I;16')), None
    return mode, _gzip_tile(data[offset:], w, h, mode, bits), None


def _gzip_tile(body: bytes, w: int, h: int, mode: str,
               bits: int) -> np.ndarray:
    """PIL's ``fits_gzip`` decoder: the last ``min(bits // 8, 4)`` bytes
    of each 4-byte word of the decompressed stream, rows reversed, read
    in ``mode``."""
    value = gzip.decompress(body)
    keep = min(bits // 8, 4)
    need = w * h * 4
    words = np.frombuffer(value[:need], np.uint8)
    if keep <= 0 or len(words) < need:
        # PIL's byte slices come out empty (or short): too little data
        raise ValueError("not enough image data")
    rows = words.reshape(h, w, 4)[::-1, :, 4 - keep:].reshape(h, w * keep)
    return unpack(np.ascontiguousarray(rows), mode, w)
