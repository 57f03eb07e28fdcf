"""A baseline JPEG decoder in numpy (no PIL).

Decodes sequential Huffman-coded JPEG (SOF0 and SOF1) with 8-bit samples,
one component (grey) or three (YCbCr, or RGB where the file says so),
integer sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0 and the rest),
interleaved or single-component scans, and restart intervals. It decodes
as libjpeg does by default, so the result equals PIL's
``Image.open(path).convert('RGB')`` to the byte:

  * the integer "islow" inverse DCT (``jidctint.c``): 13-bit fixed-point
    constants, two passes with 2 bits of extra precision between them,
    and the post-IDCT range limit with its 10-bit wrap;
  * fancy (triangular) chroma upsampling (``jdsample.c``): 3/4 of the
    nearer and 1/4 of the farther sample with libjpeg's alternating
    rounding biases, the edge rows and columns replicated, and box
    replication where a component is at most two samples wide;
  * the integer YCbCr -> RGB tables of ``jdcolor.c`` (16-bit fixed
    point).

Progressive (SOF2), lossless, hierarchical and arithmetic-coded files,
12-bit samples and four-component (CMYK, YCCK) files raise
``NotImplementedError`` naming their ROADMAP entry.
"""
from __future__ import annotations

import struct

import numpy as np

ROADMAP_JPEG = "item 12.6 (JPEG beyond baseline Huffman)"

# the zig-zag scan: natural index of the k-th coefficient in file order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# jidctint.c's constants: FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0_298, _F0_390, _F0_541, _F0_765 = 2446, 3196, 4433, 6270
_F0_899, _F1_175, _F1_501, _F1_847 = 7373, 9633, 12299, 15137
_F1_961, _F2_053, _F2_562, _F3_072 = 16069, 16819, 20995, 25172


def _unsupported(what: str, path: str) -> NotImplementedError:
    from ..scene.types import not_in_slice
    return not_in_slice(f"{what} '{path}'", ROADMAP_JPEG)


def _huffman_lut(counts, symbols):
    """(length, symbol) of every 16-bit window, as lists: a window whose
    leading bits are a code maps to that code's length and symbol;
    length 0 marks no code."""
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            lo = code << (16 - n)
            hi = (code + 1) << (16 - n)
            length[lo:hi] = n
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return length.tolist(), symbol.tolist()


def _windows(segment: bytes):
    """The 16-bit window starting at every bit of an unstuffed entropy
    segment (1-bits past its end, the JPEG fill), as a list."""
    bits = np.unpackbits(np.frombuffer(segment, np.uint8)).astype(np.int64)
    bits = np.concatenate([bits, np.ones(32, np.int64)])
    n = bits.shape[0] - 16
    w = np.zeros(n, np.int64)
    for k in range(16):
        w = (w << 1) | bits[k:k + n]
    return w.tolist()


def _idct_1d(c, final: bool):
    """One pass of jidctint.c's islow IDCT over axis -2 of ``c`` (8
    frequency rows): the 8 outputs, descaled for the pass."""
    z2, z3 = c[..., 2, :], c[..., 6, :]
    z1 = (z2 + z3) * _F0_541
    tmp2 = z1 - z3 * _F1_847
    tmp3 = z1 + z2 * _F0_765
    tmp0 = (c[..., 0, :] + c[..., 4, :]) << _CONST_BITS
    tmp1 = (c[..., 0, :] - c[..., 4, :]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[..., 7, :], c[..., 5, :], c[..., 3, :], c[..., 1, :]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0 = t0 * _F0_298
    t1 = t1 * _F2_053
    t2 = t2 * _F3_072
    t3 = t3 * _F1_501
    z1 = z1 * -_F0_899
    z2 = z2 * -_F2_562
    z3 = z3 * -_F1_961 + z5
    z4 = z4 * -_F0_390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    n = _CONST_BITS + _PASS1_BITS + 3 if final \
        else _CONST_BITS - _PASS1_BITS
    return np.stack([(x + (1 << (n - 1))) >> n for x in out], axis=-2)


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized blocks (..., 8, 8) int64 in natural order -> samples
    (..., 8, 8) uint8: columns first, then rows, then the range limit of
    the value + 128 through libjpeg's 1024-entry table (0-127 -> +128,
    128-511 -> 255, 512-895 -> 0, 896-1023 -> x - 896)."""
    ws = _idct_1d(coef, final=False)                      # (.., y, u)
    out = _idct_1d(np.swapaxes(ws, -1, -2), final=True)   # (.., x, y)
    j = np.swapaxes(out, -1, -2) & 1023
    return np.where(j < 128, j + 128, np.where(
        j < 512, 255, np.where(j < 896, 0, j - 896))).astype(np.uint8)


def _upsample(plane: np.ndarray, rh: int, rv: int, W: int, H: int):
    """A component's (dh, dw) samples upsampled by (rh, rv) as libjpeg's
    defaults do: h2v1, h1v2 and h2v2 by the fancy (triangular) filters
    (h2v1 and h2v2 only where the component is over two samples wide,
    box replication otherwise), any other integer ratio by box
    replication; then cut to (H, W)."""
    p = plane.astype(np.int64)
    dh, dw = p.shape
    fancy_h = rh == 2 and dw > 2
    if (rh, rv) in ((2, 1), (2, 2)) and fancy_h or (rh, rv) == (1, 2):
        if rv == 2:
            up = p[np.maximum(np.arange(dh) - 1, 0)]
            down = p[np.minimum(np.arange(dh) + 1, dh - 1)]
            # rows 2i (nearer above) and 2i + 1 (nearer below)
            rows = np.stack([3 * p + up, 3 * p + down], axis=1).reshape(
                2 * dh, dw)
        else:
            rows = p
        if rh == 1:          # h1v2: biases 1 above, 2 below, then >> 2
            bias = np.tile(np.array([1, 2], np.int64), dh)[:, None]
            out = (rows + bias) >> 2
        else:
            left = rows[:, np.maximum(np.arange(dw) - 1, 0)]
            right = rows[:, np.minimum(np.arange(dw) + 1, dw - 1)]
            if rv == 2:      # colsums: (3 this + last + 8) >> 4, +7 right
                even, odd = (3 * rows + left + 8) >> 4, \
                    (3 * rows + right + 7) >> 4
            else:            # (3 this + last + 1) >> 2, +2 right
                even, odd = (3 * rows + left + 1) >> 2, \
                    (3 * rows + right + 2) >> 2
            out = np.stack([even, odd], axis=-1).reshape(rows.shape[0],
                                                        2 * dw)
    else:
        out = np.repeat(np.repeat(p, rv, axis=0), rh, axis=1)
    return out[:H, :W]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert with its 16-bit fixed-point tables."""
    one_half = 1 << 15
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((91881 * cr + one_half) >> 16)
    g = y + ((-22554 * cb + one_half - 46802 * cr) >> 16)
    b = y + ((116130 * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _scan_end(data: bytes, pos: int) -> int:
    """Index of the marker that ends the entropy-coded data at ``pos``
    (stuffed zeros and restart markers are part of it)."""
    i = pos
    while True:
        j = data.find(b'\xff', i)
        if j < 0 or j + 1 >= len(data):
            return len(data)
        nxt = data[j + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7:
            i = j + 2
        elif nxt == 0xFF:
            i = j + 1
        else:
            return j


def _segments(scan: bytes):
    """The scan split at its restart markers, each unstuffed."""
    out, start, i = [], 0, 0
    while True:
        j = scan.find(b'\xff', i)
        if j < 0 or j + 1 >= len(scan):
            break
        if 0xD0 <= scan[j + 1] <= 0xD7:
            out.append(scan[start:j])
            start = i = j + 2
        else:
            i = j + 2
    out.append(scan[start:])
    return [s.replace(b'\xff\x00', b'\xff') for s in out]


def _decode_scan(scan, comps, sel, tables, restart, mcux, mcuy):
    """Huffman-decode one sequential scan into the components' quantized
    coefficient arrays. ``sel``: [(component index, dc table, ac table)];
    a scan of one component walks its own block grid, a scan of several
    the MCUs of the frame."""
    single = len(sel) == 1
    if single:
        c = comps[sel[0][0]]
        bw, bh = -(-c['dw'] // 8), -(-c['dh'] // 8)
        units = [[(sel[0], 0, 0)]]
        n_mcu, per_row = bw * bh, bw
    else:
        units = [[(s, v, h) for v in range(comps[s[0]]['v'])
                  for h in range(comps[s[0]]['h'])] for s in sel]
        n_mcu, per_row = mcux * mcuy, mcux
    blocks = [b for u in units for b in u]
    segs = _segments(scan)
    per_seg = restart if restart else n_mcu
    zz = _ZIGZAG.tolist()
    mcu = 0
    for seg in segs:
        if mcu >= n_mcu:
            break
        w = _windows(seg)
        pos = 0
        pred = {s[0]: 0 for s in sel}
        for _ in range(min(per_seg, n_mcu - mcu)):
            my, mx = divmod(mcu, per_row)
            for (ci, td, ta), v, h in blocks:
                c = comps[ci]
                dl, ds = tables[(0, td)]
                al, as_ = tables[(1, ta)]
                by, bx = (my, mx) if single else \
                    (my * c['v'] + v, mx * c['h'] + h)
                blk = c['coef'][by, bx]
                win = w[pos]
                n = dl[win]
                if n == 0:
                    raise ValueError("corrupt JPEG: bad Huffman code")
                s = ds[win]
                pos += n
                diff = 0
                if s:
                    diff = w[pos] >> (16 - s)
                    pos += s
                    if diff < 1 << (s - 1):
                        diff -= (1 << s) - 1
                pred[ci] += diff
                blk[0] = pred[ci]
                k = 1
                while k < 64:
                    win = w[pos]
                    n = al[win]
                    if n == 0:
                        raise ValueError("corrupt JPEG: bad Huffman code")
                    rs = as_[win]
                    pos += n
                    r, s = rs >> 4, rs & 15
                    if s == 0:
                        if r != 15:
                            break
                        k += 16
                        continue
                    k += r
                    val = w[pos] >> (16 - s)
                    pos += s
                    if val < 1 << (s - 1):
                        val -= (1 << s) - 1
                    blk[zz[k]] = val
                    k += 1
            mcu += 1


def read_jpeg(path: str) -> np.ndarray:
    """Read a baseline JPEG to (H, W, 3) uint8 RGB (a grey file's one
    channel repeated), as PIL's ``convert('RGB')`` gives it."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:2] != b'\xff\xd8':
        raise ValueError(f"{path}: not a JPEG file")
    pos, qt, tables, restart = 2, {}, {}, 0
    comps, frame, jfif, adobe = [], None, False, None
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG (no marker at {pos})")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                                     # EOI
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue
        n = struct.unpack('>H', data[pos:pos + 2])[0]
        body = data[pos + 2:pos + n]
        pos += n
        if marker in (0xC0, 0xC1):                             # SOF0/1
            prec, H, W, nf = struct.unpack('>BHHB', body[:6])
            if prec != 8:
                raise _unsupported(f"{prec}-bit JPEG", path)
            if nf not in (1, 3):
                raise _unsupported(f"{nf}-component (CMYK or YCCK) JPEG",
                                   path)
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append({'id': cid, 'h': hv >> 4, 'v': hv & 15,
                              'tq': tq})
            frame = (W, H)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            kind = {0xC2: 'progressive', 0xC3: 'lossless',
                    0xC6: 'progressive', 0xCA: 'progressive'}.get(
                        marker, 'hierarchical or arithmetic-coded')
            if marker in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
                kind = 'arithmetic-coded'
            raise _unsupported(f"{kind} JPEG (SOF{marker - 0xC0})", path)
        elif marker == 0xCC:                                   # DAC
            raise _unsupported("arithmetic-coded JPEG", path)
        elif marker == 0xC4:                                   # DHT
            i = 0
            while i < len(body):
                tc_th = body[i]
                counts = list(body[i + 1:i + 17])
                m = sum(counts)
                syms = list(body[i + 17:i + 17 + m])
                tables[(tc_th >> 4, tc_th & 15)] = _huffman_lut(counts, syms)
                i += 17 + m
        elif marker == 0xDB:                                   # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = np.frombuffer(body[i + 1:i + 129], '>u2')
                    i += 129
                else:
                    vals = np.frombuffer(body[i + 1:i + 65], np.uint8)
                    i += 65
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = vals.astype(np.int64)
                qt[tq] = q.reshape(8, 8)
        elif marker == 0xDD:                                   # DRI
            restart = struct.unpack('>H', body[:2])[0]
        elif marker == 0xE0 and body[:5] == b'JFIF\x00':
            jfif = True
        elif marker == 0xEE and body[:5] == b'Adobe' and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:                                   # SOS
            if frame is None:
                raise ValueError(f"{path}: scan before the frame header")
            W, H = frame
            hmax = max(c['h'] for c in comps)
            vmax = max(c['v'] for c in comps)
            mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            for c in comps:
                if 'coef' not in c:
                    c['dw'] = -(-W * c['h'] // hmax)
                    c['dh'] = -(-H * c['v'] // vmax)
                    c['coef'] = np.zeros((mcuy * c['v'], mcux * c['h'], 64),
                                         np.int64)
                    c['q'] = qt[c['tq']]
            ns = body[0]
            ids = [c['id'] for c in comps]
            sel = [(ids.index(body[1 + 2 * i]), body[2 + 2 * i] >> 4,
                    body[2 + 2 * i] & 15) for i in range(ns)]
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise _unsupported("progressive JPEG (spectral selection)",
                                   path)
            end = _scan_end(data, pos)
            _decode_scan(data[pos:end], comps, sel, tables, restart, mcux,
                         mcuy)
            pos = end
    if frame is None or not comps or 'coef' not in comps[0]:
        raise ValueError(f"{path}: no image data")
    W, H = frame
    hmax = max(c['h'] for c in comps)
    vmax = max(c['v'] for c in comps)
    planes = []
    for c in comps:
        if hmax % c['h'] or vmax % c['v']:
            raise _unsupported("JPEG with non-integer sampling ratios", path)
        by, bx = c['coef'].shape[:2]
        blocks = c['coef'].reshape(by, bx, 8, 8) * c['q']
        samples = _idct_islow(blocks).transpose(0, 2, 1, 3).reshape(
            by * 8, bx * 8)[:c['dh'], :c['dw']]
        planes.append(_upsample(samples, hmax // c['h'], vmax // c['v'],
                                W, H))
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    cid = [c['id'] for c in comps]
    rgb = (not jfif and adobe == 0) or (not jfif and adobe is None
                                         and cid == [82, 71, 66])
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)
