"""A GIF decoder in numpy (no PIL): the first frame, as ``Image.open``
gives it.

Reads what PIL's ``GifImagePlugin`` reads of frame 0, to the same mode and
samples: GIF87a and GIF89a; the global colour table or the frame's local
one (a table that is the grey ramp, entry i = (i, i, i), opens as mode
``L``, as does a frame with no table); LZW codes from 3 to 12 bits with
clear and end codes, the table growing to 4,096 entries and then held;
interlaced rows; a graphic-control transparency index, which fills the
screen outside the frame's rectangle (zero fills it otherwise). Frames
after the first are not read.
"""
from __future__ import annotations

import struct

import numpy as np


def _lzw(codes: bytes, bits: int, npix: int) -> np.ndarray:
    """GIF LZW: the first ``npix`` indices of the code stream (fewer if
    it ends early), in ``native/bitmap_lzw.cpp``. ``bits`` is the stream's
    minimum code size. Fails as ``_lzw_plain`` does."""
    from ..native import bitmap_library, ptr
    if not 0 <= bits <= 12:
        raise OSError(f"bad GIF LZW code size {bits}")
    buf = np.frombuffer(codes, np.uint8)
    out = np.empty(max(npix, 0), np.uint8)
    n = bitmap_library().mnt_gif_lzw(ptr(buf), buf.size, bits, ptr(out),
                                     out.size)
    if n == -1:
        raise OSError("broken GIF data stream")
    if n == -2:
        raise ValueError("byte must be in range(0, 256)")
    if n == -3:
        raise IndexError("list index out of range")
    return out[:n]


def _lzw_plain(codes: bytes, bits: int, npix: int) -> np.ndarray:
    """``_lzw`` in Python, the plain version the tests hold it to: LSB-first
    codes, the table held at 4,096 entries until a clear."""
    if not 0 <= bits <= 12:
        raise OSError(f"bad GIF LZW code size {bits}")
    clear, eoi = 1 << bits, (1 << bits) + 1
    out = bytearray()
    # each code's string: (prefix code, last byte, length)
    prefix = list(range(4096))
    suffix = [i & 0xFF for i in range(4096)]
    length = [1] * 4096
    nxt, size, prev = eoi + 1, bits + 1, -1
    acc = nacc = 0
    pos = 0
    n = len(codes)

    def emit(code):
        k = length[code]
        s = bytearray(k)
        for j in range(k - 1, -1, -1):
            s[j] = suffix[code]
            code = prefix[code]
        return s

    while len(out) < npix:
        while nacc < size and pos < n:
            acc |= codes[pos] << nacc
            nacc += 8
            pos += 1
        if nacc < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            nxt, size, prev = eoi + 1, bits + 1, -1
            continue
        if code == eoi:
            break
        if prev < 0:
            if code >= clear:
                raise OSError("broken GIF data stream")
            out.append(code)
            prev = code
            continue
        if code < nxt:
            s = emit(code)
            c = s[0]
        elif code == nxt:
            s = emit(prev)
            c = s[0]
            s.append(c)
        else:
            raise OSError("broken GIF data stream")
        out += s
        if nxt < 4096:
            prefix[nxt], suffix[nxt] = prev, c
            length[nxt] = length[prev] + 1
            if nxt == (1 << size) - 1 and size < 12:
                size += 1
            nxt += 1
        prev = code
    return np.frombuffer(bytes(out[:max(npix, 0)]), np.uint8)


def _table(data: bytes, pos: int, flags: int):
    """A colour table of 2^((flags & 7) + 1) entries at ``pos``: (entries
    or None for the grey ramp, the position after it)."""
    n = 3 << ((flags & 7) + 1)
    p = np.frombuffer(data[pos:pos + n], np.uint8).reshape(-1, 3)
    ramp = (p == np.arange(len(p))[:, None]).all()
    return (None if ramp else p.copy()), pos + n


def read_gif(path: str):
    """Read a GIF's first frame to ``(mode, pixels, palette)``: ``P``
    ((H, W) indices and an (N, 3) palette) or ``L`` ((H, W))."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:6] not in (b'GIF87a', b'GIF89a'):
        raise OSError(f"{path}: not a GIF file")
    W, H = struct.unpack_from('<HH', data, 6)
    flags, pos = data[10], 13
    palette = None
    if flags & 128:
        palette, pos = _table(data, pos, flags)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise OSError(f"{path}: image not found in GIF frame")
        tag = data[pos]
        pos += 1
        if tag == 0x21:                                  # extension
            label = data[pos]
            pos += 1
            first_block = True
            while data[pos]:
                n = data[pos]
                block = data[pos + 1:pos + 1 + n]
                if first_block and label == 0xF9 and block[0] & 1:
                    transparency = block[3]
                first_block = False
                pos += 1 + n
            pos += 1
        elif tag == 0x2C:                                # image
            x0, y0, fw, fh, fflags = struct.unpack_from('<HHHHB', data, pos)
            pos += 9
            if fflags & 128:
                local, pos = _table(data, pos, fflags)
                palette = local
            bits = data[pos]
            pos += 1
            break
        # any other byte is skipped, as PIL skips it
    chunks = []
    while pos < len(data) and data[pos]:
        n = data[pos]
        chunks.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
    W, H = max(W, x0 + fw), max(H, y0 + fh)
    idx = _lzw(b''.join(chunks), bits, fw * fh)
    canvas = np.full((H, W), transparency or 0, np.uint8)
    if fflags & 64:                                      # interlaced
        order = np.concatenate([np.arange(fh)[s::k] for s, k in
                                ((0, 8), (4, 8), (2, 4), (1, 2))])
    else:
        order = np.arange(fh)
    rows = len(idx) // fw if fw else 0
    frame = canvas[y0:y0 + fh, x0:x0 + fw]
    frame[order[:rows]] = idx[:rows * fw].reshape(rows, fw)
    if rows < fh and len(idx) % fw:
        frame[order[rows], :len(idx) % fw] = idx[rows * fw:]
    if palette is None:
        return 'L', canvas, None
    return 'P', canvas, palette
