"""An Autodesk FLI/FLC decoder (no PIL), as PIL's ``FliImagePlugin`` and
``fli`` decoder read the first frame: mode ``P``, the palette from the
first frame's first COLOR_256 (4) or COLOR_64 (11, times 4, modulo 256)
chunk over PIL's grey ramp, the pixels from its chunks: BLACK (13), COPY (16),
BRUN (15, byte runs), LC (12, byte deltas over the rows it names), SS2
(7, word deltas with line skips and the odd last byte), PSTAMP (18) and
the colour chunks skipped. PIL decodes the frame at byte 128, so a file
whose first frame follows a prefix chunk (0xF100) fails to load, as
there. The chunk loops run in ``native/bitmap_raster.cpp``
(``_fli_frame``); ``_fli_frame_plain`` is its plain version. A run past
a row, a chunk past the frame or an unknown chunk raises ``OSError``, as
in PIL.
"""
from __future__ import annotations

import struct

import numpy as np

# the native stage's codes -> PIL's error
_ERRORS = {-1: "image file is truncated",
           -2: "buffer overrun when reading image file",
           -3: "unrecognized data stream contents when reading image file",
           -4: "broken data stream when reading image file"}


def _accept(p: bytes) -> bool:
    return len(p) >= 16 and struct.unpack_from('<H', p, 4)[0] in (
        0xAF11, 0xAF12) and struct.unpack_from('<H', p, 14)[0] in (0, 3)


def _palette(data: bytes, pos: int, shift: int, pal: np.ndarray) -> None:
    """PIL's ``_palette``: the packets of a colour chunk's body at
    ``pos`` into ``pal`` (256, 3)."""
    count = struct.unpack_from('<H', data, pos)[0]
    pos += 2
    i = 0
    for _ in range(count):
        s = data[pos:pos + 2]
        pos += 2
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            pal[i] = [s[k] << shift, s[k + 1] << shift, s[k + 2] << shift]
            i += 1


def read_fli(path: str):
    """Read an FLI/FLC file's first frame to ``('P', (H, W) uint8,
    (256, 3) palette)``."""
    with open(path, 'rb') as f:
        data = f.read()
    s = data[:128]
    if not (_accept(s) and s[20:22] == b'\0\0' and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise OSError(f"{path}: not an FLI/FLC file")
    w, h = struct.unpack_from('<2H', data, 8)
    pal = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, 1)
    try:
        pos = 128
        s = data[pos:pos + 16]
        if struct.unpack_from('<H', s, 4)[0] == 0xF100:
            pos = 128 + struct.unpack_from('<I', s)[0]
            s = data[pos:pos + 16]
        pos += 16
        if struct.unpack_from('<H', s, 4)[0] == 0xF1FA:
            chunk_size = None
            for _ in range(struct.unpack_from('<H', s, 6)[0]):
                if chunk_size is not None:
                    pos += chunk_size - 6
                c = data[pos:pos + 6]
                pos += 6
                ctype = struct.unpack_from('<H', c, 4)[0]
                if ctype in (4, 11):
                    _palette(data, pos, 2 if ctype == 11 else 0, pal)
                    break
                chunk_size = struct.unpack_from('<I', c)[0]
                if not chunk_size:
                    break
        if len(data) < 132:
            raise EOFError("missing frame size")
    except (struct.error, IndexError, EOFError) as e:
        raise OSError(f"cannot identify image file '{path}'") from e
    if w <= 0 or h <= 0:
        raise OSError(f"cannot identify image file '{path}'")
    size = struct.unpack_from('<I', data, 128)[0]
    frame = data[128:128 + size]
    if size == 0 or len(frame) + len(frame) % 2 < size:
        raise OSError("image file is truncated")
    return 'P', _fli_frame(frame, w, h), (pal & 255).astype(np.uint8)


def _fli_frame(frame: bytes, w: int, h: int) -> np.ndarray:
    """The (h, w) pixels of one frame (its header first), in
    ``native/bitmap_raster.cpp``. Fails as ``_fli_frame_plain`` does."""
    from ..native import bitmap_library, ptr
    buf = np.frombuffer(frame, np.uint8)
    out = np.zeros((h, w), np.uint8)
    err = bitmap_library().mnt_fli_frame(ptr(buf), buf.size, w, h,
                                         ptr(out))
    if err:
        raise OSError(_ERRORS[err])
    return out


def _i16(b, p):
    return b[p] | (b[p + 1] << 8)


def _i32(b, p):
    v = b[p] | (b[p + 1] << 8) | (b[p + 2] << 16) | (b[p + 3] << 24)
    return v - (1 << 32) if v >= 1 << 31 else v


def _fli_frame_plain(frame: bytes, w: int, h: int) -> np.ndarray:
    """``_fli_frame`` in Python: PIL's ``fli`` decoder loop over the
    frame's chunks (``frame`` is the whole frame, from its size word)."""
    out = np.zeros((h, w), np.uint8)
    n = len(frame)
    if n < 8:
        raise OSError(_ERRORS[-2])
    if _i16(frame, 4) != 0xF1FA:
        raise OSError(_ERRORS[-3])
    ptr, left = 16, n - 16

    def oob(d, k):
        if d + k > ptr + left:
            raise OSError(_ERRORS[-2])
    for _ in range(_i16(frame, 6)):
        if left < 10:
            raise OSError(_ERRORS[-2])
        d = ptr + 6
        kind = _i16(frame, ptr + 4)
        if kind == 7:                                   # SS2
            lines = _i16(frame, d)
            d += 2
            y = ln = 0
            while ln < lines and y < h:
                oob(d, 2)
                packets = _i16(frame, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise OSError(_ERRORS[-2])
                    else:
                        out[y, w - 1] = packets & 0xFF
                    oob(d, 2)
                    packets = _i16(frame, d)
                    d += 2
                x = p = 0
                while p < packets:
                    oob(d, 2)
                    x += frame[d]
                    if frame[d + 1] >= 128:
                        oob(d, 4)
                        i = 256 - frame[d + 1]
                        if x + 2 * i > w:
                            break
                        out[y, x:x + 2 * i] = np.tile(
                            np.frombuffer(frame[d + 2:d + 4], np.uint8), i)
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * frame[d + 1]
                        if x + i > w:
                            break
                        oob(d, 2 + i)
                        out[y, x:x + i] = np.frombuffer(
                            frame[d + 2:d + 2 + i], np.uint8)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                ln += 1
                y += 1
            if ln < lines:
                raise OSError(_ERRORS[-2])
        elif kind == 12:                                # LC
            y = _i16(frame, d)
            ymax = y + _i16(frame, d + 2)
            d += 4
            while y < ymax and y < h:
                oob(d, 1)
                packets = frame[d]
                d += 1
                x = p = 0
                while p < packets:
                    oob(d, 2)
                    x += frame[d]
                    if frame[d + 1] & 0x80:
                        i = 256 - frame[d + 1]
                        if x + i > w:
                            break
                        oob(d, 3)
                        out[y, x:x + i] = frame[d + 2]
                        d += 3
                    else:
                        i = frame[d + 1]
                        if x + i > w:
                            break
                        oob(d, 2 + i)
                        out[y, x:x + i] = np.frombuffer(
                            frame[d + 2:d + 2 + i], np.uint8)
                        d += 2 + i
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise OSError(_ERRORS[-2])
        elif kind == 13:                                # BLACK
            out[:] = 0
        elif kind == 15:                                # BRUN
            for y in range(h):
                d += 1
                x = 0
                while x < w:
                    oob(d, 2)
                    if frame[d] & 0x80:
                        i = 256 - frame[d]
                        if x + i > w:
                            break
                        oob(d, i + 1)
                        out[y, x:x + i] = np.frombuffer(
                            frame[d + 1:d + 1 + i], np.uint8)
                        d += i + 1
                    else:
                        i = frame[d]
                        if x + i > w:
                            break
                        out[y, x:x + i] = frame[d + 1]
                        d += 2
                    x += i
                if x != w:
                    raise OSError(_ERRORS[-2])
        elif kind == 16:                                # COPY
            if d + w * h > ptr + left:
                raise OSError(_ERRORS[-1])
            out[:] = np.frombuffer(frame, np.uint8, w * h, d).reshape(h, w)
        elif kind not in (4, 11, 18):
            raise OSError(_ERRORS[-3])
        advance = _i32(frame, ptr)
        if advance == 0:
            raise OSError(_ERRORS[-4])
        if advance < 0 or advance > left:
            raise OSError(_ERRORS[-2])
        ptr += advance
        left -= advance
    return out
