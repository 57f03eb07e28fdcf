"""A PSD (Photoshop) reader in numpy (no PIL): the composite image, which
PIL opens as the file's frame 0, read as PIL's ``PsdImagePlugin`` reads
it.

  * the modes of PIL's ``MODES``: 1-bit bitmap (``1``: a set bit reads
    white, as PIL's ``1`` raw mode unpacks it), grey, multichannel and
    duotone (modes 1, 7 and 8, and 0 at 8 bits, as ``L``), indexed
    (``P``, its 768-byte colour data read planar, as PIL's ``RGB;L``),
    RGB (``RGBA`` with exactly four channels), CMYK (stored inverted) and
    Lab (``LAB``, converted by ``utils/lab.py``), 8 bits a channel; the
    channels that mode needs, read in order, the rest ignored;
  * raw data (compression 0: each channel's rows one after another) and
    RLE (1: a table of row byte counts for the channels PIL reads, then
    each channel's PackBits rows from the offset those counts give it;
    within a channel the rows decode one after another, a run cut at its
    row's end, as PIL's PackBits decoder does);
  * the image resources walked as PIL walks them, and the layer and mask
    section skipped.

What PIL refuses raises what it raises: a bit depth or mode missing from
``MODES`` (16 and 32 bits among them), a version other than 1 (PSB) and
a header PIL cannot parse ``OSError`` (its ``Image.open`` finds no
format); too few channels, another compression and a short file
``OSError`` too, but for a short raw one-channel grey or indexed file,
which PIL maps, ``ValueError``.
"""
from __future__ import annotations

import struct

import numpy as np

# (mode, bits) -> (PIL's mode, channels it reads): PIL's MODES
MODES = {(0, 1): ('1', 1), (0, 8): ('L', 1), (1, 8): ('L', 1),
         (2, 8): ('P', 1), (3, 8): ('RGB', 3), (4, 8): ('CMYK', 4),
         (7, 8): ('L', 1), (8, 8): ('L', 1), (9, 8): ('LAB', 3)}


def read_psd(path: str):
    """Read a PSD's composite image to ``(mode, pixels, palette)``: ``1``
    or ``L`` ((H, W) uint8), ``P`` ((H, W) indices and a (256, 3)
    palette, empty where the colour data is not 768 bytes: PIL's ``P``
    image then reads black), ``RGB``,
    ``RGBA``, ``CMYK`` or ``LAB`` ((H, W, C) uint8)."""
    with open(path, 'rb') as f:
        data = f.read()
    try:
        head = _open(data, path)
    except (struct.error, IndexError) as e:
        raise OSError(f"cannot identify image file '{path}'") from e
    return _load(data, path, *head)


def _open(data: bytes, path: str):
    """PIL's ``_open``: (mode, W, H, channels, palette, compression, the
    data's offset, the RLE byte counts)."""
    if data[:4] != b'8BPS' or struct.unpack_from('>H', data, 4)[0] != 1:
        raise OSError(f"cannot identify image file '{path}'")
    nch, H, W, bits, pmode = struct.unpack_from('>H II HH', data, 12)
    if (pmode, bits) not in MODES:
        # PIL's KeyError, which its ImageFile turns into a failed open
        raise OSError(f"cannot identify image file '{path}' (PSD mode "
                      f"{pmode} at {bits} bits)")
    mode, channels = MODES[(pmode, bits)]
    if channels > nch:
        raise OSError(f"{path}: not enough channels")
    if mode == 'RGB' and nch == 4:
        mode, channels = 'RGBA', 4
    pos = 26
    size = struct.unpack_from('>I', data, pos)[0]
    pos += 4
    palette = np.zeros((0, 3), np.uint8) if mode == 'P' else None
    if size:
        colour = data[pos:pos + size]
        if mode == 'P' and size == 768 and len(colour) == 768:
            palette = np.frombuffer(colour, np.uint8).reshape(3, 256).T.copy()
        pos += size
    size = struct.unpack_from('>I', data, pos)[0]
    pos += 4
    if size:                            # image resources, as PIL walks them
        end = pos + size
        while pos < end:
            pos += 4                    # signature
            struct.unpack_from('>H', data, pos)
            pos += 2
            n = data[pos]               # IndexError past the end, as i8
            pos += 1 + n + (0 if n & 1 else 1)
            length = struct.unpack_from('>I', data, pos)[0]
            pos += 4 + length + (length & 1)
    size = struct.unpack_from('>I', data, pos)[0]
    pos += 4
    if size:                                    # layer and mask section
        struct.unpack_from('>I', data, pos)     # PIL reads the layers' size
        pos += size
    comp = struct.unpack_from('>H', data, pos)[0]
    pos += 2
    counts = None
    if comp == 1:
        n = channels * H
        counts = struct.unpack_from(f'>{n}H', data, pos)
        pos += 2 * n
    return mode, W, H, channels, palette, comp, pos, counts


def _packbits_rows(data: bytes, pos: int, row_bytes: int, rows: int,
                   path: str) -> np.ndarray:
    """``rows`` rows of ``row_bytes`` from the PackBits data at ``pos``,
    as PIL's PackBits decoder fills them: rows one after another, a run
    or literal cut at its row's end, 128 a no-op; data that ends first
    raises ``OSError``."""
    out = np.zeros((rows, row_bytes), np.uint8)
    n = len(data)
    for y in range(rows):
        row, x = out[y], 0
        while x < row_bytes:
            if pos >= n:
                raise OSError(f"{path}: image file is truncated")
            h = data[pos]
            if h == 128:
                pos += 1
                continue
            if h > 128:
                if pos + 2 > n:
                    raise OSError(f"{path}: image file is truncated")
                k = min(257 - h, row_bytes - x)
                row[x:x + k] = data[pos + 1]
                pos += 2
            else:
                if pos + h + 2 > n:
                    raise OSError(f"{path}: image file is truncated")
                k = min(h + 1, row_bytes - x)
                row[x:x + k] = np.frombuffer(data, np.uint8, k, pos + 1)
                pos += h + 2
            x += k
    return out


def _load(data: bytes, path: str, mode, W, H, channels, palette, comp, pos,
          counts):
    """PIL's load of the composite's tiles: one a channel."""
    if comp not in (0, 1):
        raise OSError(f"{path}: cannot load this image (PSD compression "
                      f"{comp})")
    row_bytes = (W + 7) // 8 if mode == '1' else W
    planes = []
    for c in range(channels):
        if comp == 0:
            need = row_bytes * H
            if pos + need > len(data):
                if channels == 1 and mode in ('L', 'P'):
                    # PIL maps a one-channel raw file and finds it short
                    raise ValueError(f"{path}: buffer is not large enough")
                raise OSError(f"{path}: image file is truncated")
            plane = np.frombuffer(data, np.uint8, need, pos).reshape(
                H, row_bytes)
            pos += W * H
        else:
            plane = _packbits_rows(data, pos, row_bytes, H, path)
            pos += sum(counts[c * H:(c + 1) * H])
        planes.append(plane)
    if mode == '1':
        px = np.unpackbits(planes[0], axis=1)[:, :W] * np.uint8(255)
        return '1', np.ascontiguousarray(px), None
    if mode in ('L', 'P'):
        return mode, np.ascontiguousarray(planes[0]), palette
    px = np.stack(planes, -1)
    if mode == 'CMYK':
        px = 255 - px
    return mode, np.ascontiguousarray(px), None
