"""JPEG 2000 files (JP2 boxes or a raw codestream) to the mode and samples
PIL's ``Jpeg2KImagePlugin`` gives them, without PIL.

The codestream decodes in ``utils/j2k.py``. Around it, PIL's rules:

  * the mode: of a raw codestream from SIZ (``_parse_codestream``: one
    component deeper than 8 bits ``I;16``, else ``L``; two ``LA``, three
    ``RGB``, four ``RGBA``); of a JP2 file from its ``jp2h`` box
    (``_parse_jp2_header``: ``ihdr``'s count and depth, one component
    ``I;16`` only where its depth field exceeds 8; four components with a
    ``colr`` of enumerated space 12 ``CMYK``; a ``pclr`` over ``L`` or
    ``LA`` gives ``P`` or ``PA``, its palette built through
    ``ImagePalette.getcolor``, which keeps the first of two equal
    entries, so the indices after a repeat point one entry on);
  * openjpeg decodes with ``pclr``, ``cmap`` and ``cdef`` ignored (PIL's
    flag): the palette's indices come out as samples, and channels stay
    in the codestream's order; ``colr`` sets the colour space (16 sRGB,
    17 grey, 12 CMYK; another enumeration leaves it unspecified, grey
    for one or two components and sRGB for three or four, as PIL reads
    it); PIL's unpacker for (mode, space, component count) brings each
    component to the mode's bytes: ``(offset + word) << (8 - prec)`` or
    ``>> (prec - 8)`` with half added (16 for ``I;16``), the offset
    ``2^(prec - 1)`` of a signed component, the word the sample in its
    1, 2 or 4 bytes, the result cut to the mode's 8 or 16 bits. No
    unpacker for the triple fails as PIL does (``OSError``).

sYCC (enumerated space 18, which PIL converts with its own YCbCr tables),
a palette of other than three columns or deeper than 8 bits, and a JP2
whose ``ihdr`` count differs from its codestream's raise
``NotImplementedError`` naming ROADMAP 12.7.
"""
from __future__ import annotations

import struct

import numpy as np

from ..scene.types import not_in_slice
from . import j2k

SIGNATURE = b'\0\0\0\x0cjP  \r\n\x87\n'
_GREY, _SRGB, _CMYK, _EYCC = 'grey', 'srgb', 'cmyk', 'eycc'
# PIL's j2k_unpackers: (mode, colour space, components) -> unpacker
_UNPACKERS = {('L', _GREY, 1): 'l', ('P', _SRGB, 1): 'l',
              ('PA', _SRGB, 2): 'la', ('I;16', _GREY, 1): 'i',
              ('I;16B', _GREY, 1): 'i', ('LA', _GREY, 2): 'la',
              ('RGB', _SRGB, 3): 'rgb', ('RGB', _SRGB, 4): 'rgb',
              ('RGBA', _SRGB, 3): 'rgb', ('RGBA', _SRGB, 4): 'rgba',
              ('CMYK', _CMYK, 4): 'rgba'}


def _refuse(what: str):
    return not_in_slice(f"JPEG 2000 {what}",
                        "item 12.7 (other bitmap formats)")


def _boxes(data: bytes, pos: int, end: int):
    """(type, body start, body end) of each box in ``data[pos:end]``; a
    box of length 0 runs to ``end``."""
    while pos + 8 <= end:
        n, t = struct.unpack_from('>I4s', data, pos)
        head = 8
        if n == 1:
            if pos + 16 > end:
                raise SyntaxError("Invalid header length")
            n, head = struct.unpack_from('>Q', data, pos + 8)[0], 16
        elif n == 0:
            n = end - pos
        if n < head or pos + n > end:
            raise SyntaxError("Invalid header length")
        yield t, pos + head, pos + n
        pos += n


def _palette(body: bytes):
    """PIL's palette of a ``pclr`` box (RGB entries through
    ``ImagePalette.getcolor``), or None where it keeps none."""
    ne, npc = struct.unpack_from('>HB', body)
    depths = body[3:3 + npc]
    if max(depths, default=0) > 8:
        return None
    if npc != 3:
        raise _refuse(f"palette of {npc} columns")
    colours = {}
    raw = body[3 + npc:3 + npc + 3 * ne]
    if len(raw) < 3 * ne:
        raise OSError("Not enough data in header")
    for k in range(ne):
        c = raw[3 * k:3 * k + 3]
        if c not in colours:
            if len(colours) == 256:
                raise ValueError("cannot allocate more than 256 colors")
            colours[c] = len(colours)
    return np.frombuffer(b''.join(colours), np.uint8).reshape(-1, 3)


def _top_boxes(data: bytes):
    """(type, body start, declared body end) of each top-level box after
    the signature: a length of 0 runs to the end of the file, a length
    past the end is kept as declared (the caller decides)."""
    pos = 12
    while pos + 8 <= len(data):
        n, t = struct.unpack_from('>I4s', data, pos)
        head = 8
        if n == 1:
            if pos + 16 > len(data):
                return
            n, head = struct.unpack_from('>Q', data, pos + 8)[0], 16
        elif n == 0:
            n = len(data) - pos
        if n < head:
            raise SyntaxError("Invalid header length")
        yield t, pos + head, pos + n
        pos += n


def _jp2_header(data: bytes):
    """PIL's ``_parse_jp2_header`` and openjpeg's reading of the boxes:
    (mode, palette, colour space, ihdr's component count, codestream).
    PIL reads the top-level boxes up to ``jp2h`` (a ``jp2h`` past the end
    of the file fails); the codestream is ``jp2c``'s, cut where the file
    ends (openjpeg then finds it broken)."""
    mode = palette = space = None
    nc = jp2h = jp2c = None
    for t, a, b in _top_boxes(data):
        if t == b'jp2h' and jp2h is None:
            if b > len(data):
                raise OSError(f"Expected to read {b - a} bytes but only "
                              f"got {len(data) - a}.")
            jp2h = (a, b)
        elif t == b'jp2c' and jp2c is None:
            jp2c = data[a:b]
        if jp2h is not None and jp2c is not None:
            break
    if jp2h is None:                # PIL reads on to the file's end
        raise OSError("no jp2h box before the end of the file")
    for t, a, b in _boxes(data, *jp2h):
        body = data[a:b]
        if t == b'ihdr':
            if len(body) < 11:
                raise SyntaxError("Not enough data in header")
            _, _, nc, bpc = struct.unpack_from('>IIHB', body)
            mode = {1: 'I;16' if (bpc & 0x7F) > 8 else 'L', 2: 'LA',
                    3: 'RGB', 4: 'RGBA'}.get(nc)
        elif t == b'colr':
            if len(body) >= 7:
                meth, _, _, enumcs = struct.unpack_from('>BBBI', body)
                if nc == 4 and meth == 1 and enumcs == 12:
                    mode = 'CMYK'
                if meth == 1:
                    if enumcs == 18:
                        raise _refuse("sYCC colour space")
                    space = {16: _SRGB, 17: _GREY, 12: _CMYK,
                             24: _EYCC}.get(enumcs)
        elif t == b'pclr' and mode in ('L', 'LA'):
            if len(body) < 3:
                raise SyntaxError("Not enough data in header")
            pal = _palette(body)
            if pal is not None:
                palette, mode = pal, 'P' if mode == 'L' else 'PA'
    if mode is None:
        raise SyntaxError("Malformed JP2 header")
    if jp2c is None:
        raise OSError("no codestream box")
    return mode, palette, space, nc, jp2c


def _unpack(plane: np.ndarray, prec: int, sgnd: bool, bits: int):
    """PIL's ``j2ku_*`` of one component to ``bits`` (8 or 16) bits."""
    if prec == bits and not sgnd:          # already the mode's samples
        return plane.astype(np.uint8 if bits == 8 else np.uint16)
    csiz = (prec + 7) >> 3
    csiz = 4 if csiz == 3 else csiz
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    word = plane.astype(np.int64) & ((1 << (8 * csiz)) - 1)
    v = (offset + word) & 0xFFFFFFFF
    v = (v << shift) if shift >= 0 else (v >> -shift)
    return (v & ((1 << bits) - 1)).astype(np.uint8 if bits == 8
                                          else np.uint16)


def decode(data: bytes):
    """(mode, pixels, palette) of a JP2 file or raw codestream's bytes."""
    if data[:4] == b'\xff\x4f\xff\x51':
        if len(data) < 42:
            raise SyntaxError("short SIZ")
        nc = struct.unpack_from('>H', data, 40)[0]
        prec = (data[42] & 0x7F) + 1 if len(data) > 42 else 0
        mode = {1: 'I;16' if prec > 8 else 'L', 2: 'LA', 3: 'RGB',
                4: 'RGBA'}.get(nc)
        if mode is None:
            raise SyntaxError("unable to determine J2K image mode")
        palette, space, stream = None, None, data
    elif data[:12] == SIGNATURE:
        mode, palette, space, nc, stream = _jp2_header(data)
    else:
        raise SyntaxError("not a JPEG 2000 file")
    comps, planes = j2k.decode(stream)
    n = len(comps)
    if n != nc:
        raise _refuse("file whose header and codestream differ in "
                      "component count")
    if n > 4:
        raise OSError("unsupported JPEG 2000 component count")
    if space is None:
        space = _GREY if n <= 2 else _SRGB
    kind = _UNPACKERS.get((mode, space, n))
    if kind is None:
        raise OSError(f"no unpacker for {mode} from {n} components")
    if kind == 'i':
        return mode, _unpack(planes[0], comps[0]['prec'], comps[0]['sgnd'],
                             16), palette
    chans = [_unpack(p, c['prec'], c['sgnd'], 8)
             for p, c in zip(planes, comps)]
    if kind == 'l':
        return mode, chans[0], palette
    if kind == 'la':
        return mode, np.stack(chans[:2], -1), palette
    if kind == 'rgb':
        return mode, np.stack(chans[:3] + ([np.full_like(chans[0], 255)]
                                            if mode == 'RGBA' else []), -1), \
            palette
    return mode, np.stack(chans[:4], -1), palette


def read_jpeg2000(path: str):
    """Read a JPEG 2000 file (JP2 or raw codestream) to ``(mode, pixels,
    palette)`` as PIL opens it. A file PIL does not open, or whose data
    PIL's decoder finds broken, raises ``OSError``."""
    with open(path, 'rb') as f:
        data = f.read()
    try:
        return decode(data)
    except (SyntaxError, struct.error, IndexError) as e:
        raise OSError(f"{path}: {e}") from e
