"""A Netpbm (PBM, PGM, PPM: P1-P6) and greyscale PFM (``Pf``) decoder in
numpy (no PIL).

Reads what PIL's ``PpmImagePlugin`` reads, to the same mode and samples:
header tokens separated by whitespace, a ``#`` comment running to the end
of its line; P1 and P4 to mode ``1`` (1 is black); P2, P3 (plain) and P5,
P6 (binary) at any maxval below 65536, scaled as PIL scales them
(``round(v / maxval * 255)``, or to 65535 in mode ``I`` for grey over 255;
a binary grey file at 65535 is read as 16-bit big-endian integers); ``Pf``
to mode ``F``, little-endian when its scale is negative, bottom row
first. PIL does not open colour PFM (``PF``), so neither does the port.
"""
from __future__ import annotations

import numpy as np

_WS = b' \t\n\x0b\x0c\r'
_MODES = {b'P1': '1', b'P2': 'L', b'P3': 'RGB', b'P4': '1', b'P5': 'L',
          b'P6': 'RGB', b'Pf': 'F'}


def _token(data: bytes, pos: int):
    """PIL's ``_read_token``: the next header token (comments skipped)
    and the position after the whitespace byte that ends it."""
    tok = b''
    while len(tok) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WS:
            if not tok:
                continue
            break
        if c == b'#':
            while pos < len(data) and data[pos:pos + 1] not in b'\r\n':
                pos += 1
            pos += 1
            continue
        tok += c
    if not tok or len(tok) > 10:
        raise ValueError("bad PNM header token")
    return tok, pos


def _plain_body(body: bytes) -> bytes:
    """Plain-format sample text with its comments removed (a comment runs
    from ``#`` to the next CR or LF)."""
    out, i = bytearray(), 0
    while True:
        j = body.find(b'#', i)
        if j < 0:
            out += body[i:]
            return bytes(out)
        out += body[i:j]
        ends = [k for k in (body.find(b'\n', j), body.find(b'\r', j))
                if k >= 0]
        if not ends:
            return bytes(out)
        i = min(ends) + 1


def _scale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """PIL's ``round(value / maxval * out_max)`` (round half to even)."""
    return np.rint(v.astype(np.float64) / maxval * out_max).astype(np.int64)


def read_pnm(path: str):
    """Read a P1-P6 or ``Pf`` file to ``(mode, pixels, None)``: mode
    ``1``, ``L``, ``I`` or ``F`` ((H, W)) or ``RGB`` ((H, W, 3))."""
    with open(path, 'rb') as f:
        data = f.read()
    magic, pos = b'', 0
    while pos < min(6, len(data)) and data[pos:pos + 1] not in _WS:
        magic += data[pos:pos + 1]
        pos += 1
    pos += 1
    if magic not in _MODES:
        raise OSError(f"{path}: not a PNM file PIL opens ({magic!r})")
    mode = _MODES[magic]
    w, pos = _token(data, pos)
    h, pos = _token(data, pos)
    W, H = int(w), int(h)
    bands = 3 if mode == 'RGB' else 1
    n = W * H * bands
    if mode == 'F':
        s, pos = _token(data, pos)
        scale = float(s)
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
        px = np.frombuffer(data, '<f4' if scale < 0 else '>f4', W * H, pos)
        return 'F', px.reshape(H, W)[::-1].astype(np.float32), None
    if magic == b'P4':
        rows = np.frombuffer(data, np.uint8, (W + 7) // 8 * H, pos)
        bits = np.unpackbits(rows.reshape(H, -1), axis=1)[:, :W]
        return '1', np.where(bits == 1, 0, 255).astype(np.uint8), None
    if magic == b'P1':
        toks = b''.join(_plain_body(data[pos:]).split())[:W * H]
        if len(toks) < W * H or not set(toks) <= {48, 49}:
            raise ValueError(f"{path}: bad P1 data")
        px = np.frombuffer(toks, np.uint8).reshape(H, W)
        return '1', np.where(px == 49, 0, 255).astype(np.uint8), None
    m, pos = _token(data, pos)
    maxval = int(m)
    if not 0 < maxval < 65536:
        raise ValueError("maxval must be greater than 0 and less than 65536")
    if mode == 'L' and maxval > 255:
        mode = 'I'
    out_max = 65535 if mode == 'I' else 255
    if magic in (b'P2', b'P3'):
        toks = _plain_body(data[pos:]).split()[:n]
        v = np.array([int(t) for t in toks], np.int64)
        if len(v) < n or (v > maxval).any() or (v < 0).any():
            raise ValueError(f"{path}: bad plain PNM data")
        px = _scale(v, maxval, out_max)
    elif maxval == 255:
        px = np.frombuffer(data, np.uint8, n, pos)
    elif maxval == 65535 and mode == 'I':
        px = np.frombuffer(data, '>u2', n, pos).astype(np.int64)
    else:
        v = np.frombuffer(data, '>u2' if maxval > 255 else np.uint8, n, pos)
        px = np.minimum(out_max, _scale(v, maxval, out_max))
    px = px.reshape((H, W, 3) if bands == 3 else (H, W))
    return mode, px.astype(np.int32 if mode == 'I' else np.uint8), None
