"""A JPEG decoder without PIL: headers in Python, the entropy decoding of
each scan, the IDCT, the upsampling and the colour conversion in host C++
(``native/bitmap_jpeg.cpp``), each stage beside its numpy twin
(``_decode_scan_plain``, ``_idct_plane_plain``, ``_upsample_plain``,
``_ycc_to_rgb_plain``, ``_decode_lossless_plain``), which the tests hold
it to.

Decodes Huffman-coded JPEG: sequential (SOF0 and SOF1), progressive
(SOF2: spectral selection, successive approximation of DC and AC, first
and refinement scans, EOB runs) and lossless (SOF3: predictors 1-7, the
point transform, unsubsampled components). Samples are 8-bit; one
component (grey), three (YCbCr, or RGB where the file says so; a
lossless file with ids 1-3 and no JFIF or Adobe marker is RGB, as libjpeg
takes it) or four (Adobe CMYK, stored inverted, or YCCK); integer
sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0 and the rest), interleaved
or single-component scans, and restart intervals. A progressive file's
coefficients are buffered whole, as libjpeg absorbs a multi-scan file
before its output pass. It decodes as libjpeg does by default, so the
result equals PIL's ``Image.open(path).convert('RGB')`` to the byte:

  * the integer "islow" inverse DCT (``jidctint.c``): 13-bit fixed-point
    constants, two passes with 2 bits of extra precision between them,
    and the post-IDCT range limit with its 10-bit wrap;
  * fancy (triangular) chroma upsampling (``jdsample.c``): 3/4 of the
    nearer and 1/4 of the farther sample with libjpeg's alternating
    rounding biases, the edge rows and columns replicated, and box
    replication where a component is at most two samples wide;
  * the integer YCbCr -> RGB tables of ``jdcolor.c`` (16-bit fixed
    point), also behind YCCK -> CMYK;
  * libjpeg's block smoothing of progressive output (``jdcoefct.c``)
    runs only while one of the first nine AC coefficients is incomplete;
    a complete file ends every coefficient at Al = 0, so it never runs
    there (a file where it would raises).

What PIL does not open (12-bit samples, 2 or 5+ components) and what its
libjpeg refuses (hierarchical SOF5-7 and SOF13-15) raise ``OSError`` as
there. Arithmetic-coded files raise ``NotImplementedError`` naming their
ROADMAP entry: no encoder of them is at hand to test a decoder against.
"""
from __future__ import annotations

import struct

import numpy as np

ROADMAP_JPEG = "item 12.6 (the JPEG kinds left: arithmetic coding)"

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
    """(length, symbol) of every 16-bit window, uint8 arrays: a window
    whose leading bits are a code maps to that code's length and symbol;
    length 0 marks no code."""
    length = np.zeros(1 << 16, np.uint8)
    symbol = np.zeros(1 << 16, np.uint8)
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
    return length, symbol


def _lut_lists(tables: dict) -> dict:
    """The Huffman tables as lists, for the plain decoders' lookups."""
    return {k: (length.tolist(), symbol.tolist())
            for k, (length, symbol) in tables.items()}


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


def _idct_plane(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """A component's quantized blocks (rows, cols, 64) int16 dequantized
    by ``q`` (8, 8) and inverse-transformed (``_idct_islow``) into its
    samples, (8 rows, 8 cols) uint8, in ``native/bitmap_jpeg.cpp``."""
    from ..native import bitmap_library, ptr
    rows, cols = coef.shape[:2]
    coef = np.ascontiguousarray(coef, np.int16)
    q = np.ascontiguousarray(q, np.int64).reshape(64)
    out = np.empty((8 * rows, 8 * cols), np.uint8)
    bitmap_library().mnt_jpeg_idct(ptr(coef), rows, cols, ptr(q), ptr(out))
    return out


def _idct_plane_plain(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``_idct_plane`` in numpy, the plain version the tests hold it to
    (it widens the int16 coefficients to int64 for numpy's products)."""
    rows, cols = coef.shape[:2]
    blocks = coef.reshape(rows, cols, 8, 8).astype(np.int64) * q
    return _idct_islow(blocks).transpose(0, 2, 1, 3).reshape(8 * rows,
                                                             8 * cols)


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
    """``_upsample_plain`` of uint8 samples, in ``native/bitmap_jpeg.cpp``:
    (H, W) uint8."""
    from ..native import bitmap_library, ptr
    plane = np.ascontiguousarray(plane, np.uint8)
    if H > plane.shape[0] * rv or W > plane.shape[1] * rh:
        raise ValueError("JPEG component smaller than its frame")
    out = np.empty((H, W), np.uint8)
    bitmap_library().mnt_jpeg_upsample(ptr(plane), *plane.shape, rh, rv, W,
                                       H, ptr(out))
    return out


def _upsample_plain(plane: np.ndarray, rh: int, rv: int, W: int, H: int):
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
    """``_ycc_to_rgb_plain`` of uint8 planes, in ``native/bitmap_jpeg.cpp``:
    (..., 3) uint8."""
    from ..native import bitmap_library, ptr
    y, cb, cr = (np.ascontiguousarray(a, np.uint8) for a in (y, cb, cr))
    if not y.shape == cb.shape == cr.shape:
        raise ValueError("JPEG colour planes of different sizes")
    out = np.empty(y.shape + (3,), np.uint8)
    bitmap_library().mnt_jpeg_ycc_rgb(ptr(y), ptr(cb), ptr(cr), y.size,
                                      ptr(out))
    return out


def _ycc_to_rgb_plain(y, cb, cr) -> np.ndarray:
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


# mnt_jpeg_scan's failures as the plain version raises them (5, a missing
# table, is its KeyError)
_SCAN_ERRORS = {1: (ValueError, "corrupt JPEG: bad Huffman code"),
                2: (IndexError, "list index out of range"),
                3: (ValueError, "negative shift count"),
                4: (IndexError, "list index out of range"),
                6: (IndexError, "index out of bounds")}


def _jcoef(v: int) -> int:
    """A coefficient as libjpeg's 16-bit ``JCOEF`` holds it."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _scan_grid(comps, sel, mcux, mcuy) -> tuple:
    """(units a row, units) a scan walks: a one-component scan its own
    block grid, a scan of several the MCUs of the frame."""
    if len(sel) == 1:
        c = comps[sel[0][0]]
        bw, bh = -(-c['dw'] // 8), -(-c['dh'] // 8)
        return bw, bw * bh
    return mcux, mcux * mcuy


def _decode_scan(scan, comps, sel, tables, restart, mcux, mcuy, spec):
    """Huffman-decode one scan into the components' quantized coefficient
    arrays (int16), in ``native/bitmap_jpeg.cpp``: ``_decode_scan_plain``'s
    arguments, results and failures."""
    import ctypes
    from ..native import bitmap_library, ptr
    ss, se, ah, al = spec
    ns = len(sel)
    per_row, n_mcu = _scan_grid(comps, sel, mcux, mcuy)
    coefs = (ctypes.c_void_p * max(ns, 1))()
    luts = (ctypes.c_void_p * (4 * max(ns, 1)))()
    geo = np.zeros((max(ns, 1), 4), np.int64)
    idx = np.zeros(max(ns, 1), np.int32)
    tid = np.zeros((max(ns, 1), 2), np.int32)
    for i, (ci, td, ta) in enumerate(sel):
        c = comps[ci]
        if c['coef'].dtype != np.int16 or \
                not c['coef'].flags['C_CONTIGUOUS']:
            raise ValueError("JPEG coefficients must be C-ordered int16")
        coefs[i] = ptr(c['coef'])
        geo[i] = (*c['coef'].shape[:2], c['h'], c['v'])
        idx[i], tid[i] = ci, (td, ta)
        for j, key in enumerate(((0, td), (1, ta))):
            if key in tables:
                luts[4 * i + 2 * j] = ptr(tables[key][0])
                luts[4 * i + 2 * j + 1] = ptr(tables[key][1])
    data = np.frombuffer(scan, np.uint8)
    info = np.zeros(2, np.int64)
    err = bitmap_library().mnt_jpeg_scan(
        ptr(data), data.size, ns, ctypes.addressof(coefs), ptr(geo),
        ptr(idx), ctypes.addressof(luts), ptr(tid), restart, per_row,
        n_mcu, ss, se, ah, al, ptr(info))
    if err == 5:
        raise KeyError((int(info[0]), int(info[1])))
    if err:
        kind, message = _SCAN_ERRORS[err]
        raise kind(message)


def _decode_scan_plain(scan, comps, sel, tables, restart, mcux, mcuy,
                       spec):
    """Huffman-decode one scan into the components' quantized coefficient
    arrays (``jdhuff.c`` for a sequential scan, ``jdphuff.c`` for a
    progressive one), in Python: the plain version of ``_decode_scan``.
    ``sel``: [(component index, dc table, ac table)]; ``spec``: (Ss, Se,
    Ah, Al). A scan of one component walks its own block grid, a scan of
    several the MCUs of the frame. Coefficients wrap to 16 bits as
    libjpeg's do."""
    ss, se, ah, al = spec
    tables = _lut_lists(tables)
    single = len(sel) == 1
    per_row, n_mcu = _scan_grid(comps, sel, mcux, mcuy)
    blocks = [(sel[0], 0, 0)] if single else [
        (s, v, h) for s in sel for v in range(comps[s[0]]['v'])
        for h in range(comps[s[0]]['h'])]
    segs = _segments(scan)
    per_seg = restart if restart else n_mcu
    zz = _ZIGZAG.tolist()
    p1, m1 = 1 << al, -1 << al
    mcu = 0
    for seg in segs:
        if mcu >= n_mcu:
            break
        w = _windows(seg)
        pos = 0
        pred = {s[0]: 0 for s in sel}
        eobrun = 0
        for _ in range(min(per_seg, n_mcu - mcu)):
            my, mx = divmod(mcu, per_row)
            for (ci, td, ta), v, h in blocks:
                c = comps[ci]
                by, bx = (my, mx) if single else \
                    (my * c['v'] + v, mx * c['h'] + h)
                blk = c['coef'][by, bx]
                if ss == 0 and ah:                       # DC refinement
                    if w[pos] >> 15:
                        blk[0] = _jcoef(int(blk[0]) | p1)
                    pos += 1
                    continue
                if ss == 0:                              # DC first
                    dl, ds = tables[(0, td)]
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
                    blk[0] = _jcoef(pred[ci] << al)
                    if se == 0:
                        continue
                al_, as_ = tables[(1, ta)]
                if ah:                                   # AC refinement
                    pos, eobrun = _ac_refine(blk, w, pos, al_, as_, zz,
                                             ss, se, p1, m1, eobrun)
                    continue
                if eobrun:                               # AC first
                    eobrun -= 1
                    continue
                k = max(ss, 1)
                while k <= se:
                    win = w[pos]
                    n = al_[win]
                    if n == 0:
                        raise ValueError("corrupt JPEG: bad Huffman code")
                    rs = as_[win]
                    pos += n
                    r, s = rs >> 4, rs & 15
                    if s == 0:
                        if r != 15:
                            if ss:                       # an EOB run
                                eobrun = 1 << r
                                if r:
                                    eobrun += w[pos] >> (16 - r)
                                    pos += r
                                eobrun -= 1
                            break
                        k += 16
                        continue
                    k += r
                    val = w[pos] >> (16 - s)
                    pos += s
                    if val < 1 << (s - 1):
                        val -= (1 << s) - 1
                    blk[zz[k]] = _jcoef(val << al)
                    k += 1
            mcu += 1


def _ac_refine(blk, w, pos, al_, as_, zz, ss, se, p1, m1, eobrun):
    """``jdphuff.c``'s ``decode_mcu_AC_refine`` on one block: a
    correction bit for every coefficient already nonzero, new
    coefficients of magnitude 1 << Al placed past ``r`` zero ones; returns
    the bit position and the EOB run left."""
    k = ss
    if eobrun == 0:
        while k <= se:
            win = w[pos]
            n = al_[win]
            if n == 0:
                raise ValueError("corrupt JPEG: bad Huffman code")
            rs = as_[win]
            pos += n
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if w[pos] >> 15 else m1
                pos += 1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += w[pos] >> (16 - r)
                    pos += r
                break
            while k <= se:
                z = zz[k]
                c = int(blk[z])
                if c:
                    if w[pos] >> 15 and not c & p1:
                        blk[z] = _jcoef(c + (p1 if c >= 0 else m1))
                    pos += 1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                blk[zz[k]] = _jcoef(s)
            k += 1
    if eobrun > 0:
        while k <= se:
            z = zz[k]
            c = int(blk[z])
            if c:
                if w[pos] >> 15 and not c & p1:
                    blk[z] = _jcoef(c + (p1 if c >= 0 else m1))
                pos += 1
            k += 1
        eobrun -= 1
    return pos, eobrun


def _decode_lossless(scan, comps, sel, tables, restart, W, H, psv, pt,
                     path):
    """Decode a lossless (SOF3) scan into each component's samples
    (``c['samples']``, (H, W) uint8), in ``native/bitmap_jpeg.cpp``:
    ``_decode_lossless_plain``'s arguments, results and failures (an
    empty frame goes to it)."""
    import ctypes
    from ..native import bitmap_library, ptr
    if restart and restart % W:
        raise _unsupported("lossless JPEG with a restart interval that "
                           "is not whole rows", path)
    if not W or not H:
        return _decode_lossless_plain(scan, comps, sel, tables, restart, W,
                                      H, psv, pt, path)
    ns = len(sel)
    luts = (ctypes.c_void_p * (2 * max(ns, 1)))()
    td = np.zeros(max(ns, 1), np.int32)
    for j, (_, t, _) in enumerate(sel):
        td[j] = t
        if (0, t) in tables:
            luts[2 * j], luts[2 * j + 1] = (ptr(x) for x in tables[(0, t)])
    data = np.frombuffer(scan, np.uint8)
    out = np.empty((max(ns, 1), H, W), np.uint8)
    info = np.zeros(2, np.int64)
    err = bitmap_library().mnt_jpeg_lossless(
        ptr(data), data.size, ns, ctypes.addressof(luts), ptr(td), restart,
        W, H, psv, pt, ptr(out), ptr(info))
    if err == 5:
        raise KeyError((int(info[0]), int(info[1])))
    if err == 7:
        raise IndexError("tuple index out of range")
    if err:
        kind, message = _SCAN_ERRORS[err]
        raise kind(message)
    for j, (ci, _, _) in enumerate(sel):
        comps[ci]['samples'] = out[j]


def _decode_lossless_plain(scan, comps, sel, tables, restart, W, H, psv,
                           pt, path):
    """``_decode_lossless`` in numpy and Python, the plain version the
    tests hold it to. It decodes a lossless (SOF3) scan into each
    component's samples (``c['samples']``, (H, W) uint8): Huffman-coded
    differences (DC categories 0-16, 16 meaning 32768) added mod 2^16 to
    predictor
    ``psv`` (1-7) of the neighbours left (a), above (b) and above-left
    (c); the first row predicts from the left, the first column from
    above, the first sample 2^(7 - Pt); each restart interval (whole
    rows) starts as the image does. Samples are shifted left by Pt."""
    if restart and restart % W:
        raise _unsupported("lossless JPEG with a restart interval that "
                           "is not whole rows", path)
    tables = _lut_lists(tables)
    n = len(sel)
    diff = np.zeros((H, W, n), np.int64)
    per_seg = restart or W * H
    segs = _segments(scan)
    k = 0
    for seg in segs:
        if k >= W * H:
            break
        w = _windows(seg)
        pos = 0
        for _ in range(min(per_seg, W * H - k)):
            y, x = divmod(k, W)
            for j, (_, td, _) in enumerate(sel):
                dl, ds = tables[(0, td)]
                win = w[pos]
                m = dl[win]
                if m == 0:
                    raise ValueError("corrupt JPEG: bad Huffman code")
                s = ds[win]
                pos += m
                d = 0
                if s == 16:
                    d = 32768
                elif s:
                    d = w[pos] >> (16 - s)
                    pos += s
                    if d < 1 << (s - 1):
                        d -= (1 << s) - 1
                diff[y, x, j] = d
            k += 1
    rows_per = per_seg // W
    for j, (ci, _, _) in enumerate(sel):
        out = np.zeros((H, W), np.int64)
        d = diff[..., j].tolist()
        for y in range(H):
            first = y % rows_per == 0
            row, up = out[y], out[y - 1] if y else None
            r = [0] * W
            for x in range(W):
                if first:
                    p = r[x - 1] if x else 1 << (7 - pt)
                elif x == 0:
                    p = up[0]
                else:
                    a, b, c = r[x - 1], up[x], up[x - 1]
                    p = (a, b, c, a + b - c, a + ((b - c) >> 1),
                         b + ((a - c) >> 1), (a + b) >> 1)[psv - 1]
                r[x] = (p + d[y][x]) & 0xFFFF
            row[:] = r
        comps[ci]['samples'] = ((out << pt) & 0xFF).astype(np.uint8)


def _smoothing_applies(comps, coef_bits) -> bool:
    """libjpeg's ``smoothing_ok`` after the whole file: block smoothing
    runs on a progressive file's output when every component's DC is
    known and some component's first nine AC coefficients are not
    complete (their ``coef_bits`` not 0), quantizers nonzero. Never so
    for a file whose scans end every coefficient at Al = 0."""
    for c, bits in zip(comps, coef_bits):
        q = c['q'].reshape(-1)[_ZIGZAG[:10]]
        if (q == 0).any() or bits[0] < 0:
            return False
    return any(b != 0 for bits in coef_bits for b in bits[1:10])


def read_jpeg_mode(path: str):
    """Read a JPEG to ``(mode, pixels, None)`` as PIL opens it: ``L``
    ((H, W)), ``RGB`` ((H, W, 3)) or ``CMYK`` ((H, W, 4), the samples
    inverted as PIL's ``CMYK;I`` raw mode leaves them; a YCCK file
    converted to CMYK first, as libjpeg does). A file PIL does not open
    (12-bit samples, 2 or more than 4 components) and a kind libjpeg
    cannot decode (hierarchical) raise ``OSError``, as in PIL."""
    with open(path, 'rb') as f:
        return decode(f.read(), path)


def decode(data: bytes, path: str, colour=None):
    """``read_jpeg_mode`` of a JPEG stream held in memory (``path`` names
    it in errors). ``colour`` overrides what the markers say, as libtiff
    sets libjpeg's colour space for a TIFF's strips and tiles:
    ``'YCbCr'`` converts a three-component stream to RGB, ``'samples'``
    returns ``('samples', (H, W, components), None)``: the components of
    a stream of any number of them as they are (upsampled, not
    converted), and ``'raw'`` returns ``('raw', each component's samples
    at its own resolution in whole MCUs, the components)``."""
    if data[:2] != b'\xff\xd8':
        raise ValueError(f"{path}: not a JPEG file")
    pos, qt, tables, restart = 2, {}, {}, 0
    comps, frame, jfif, adobe = [], None, False, None
    progressive, lossless, coef_bits = False, False, None
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
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            prec, H, W, nf = struct.unpack('>BHHB', body[:6])
            if prec != 8:            # PIL's SOF refuses: no plugin opens it
                raise OSError(f"cannot identify image file '{path}' "
                              f"({prec}-bit JPEG)")
            if nf not in (1, 3, 4) and colour != 'samples':
                raise OSError(f"cannot identify image file '{path}' "
                              f"({nf}-component JPEG)")
            if marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
                raise OSError(f"{path}: unsupported JPEG process: "
                              f"hierarchical (SOF{marker - 0xC0})")
            if marker >= 0xC9:
                raise _unsupported(f"arithmetic-coded JPEG "
                                   f"(SOF{marker - 0xC0})", path)
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append({'id': cid, 'h': hv >> 4, 'v': hv & 15,
                              'tq': tq})
            frame, progressive = (W, H), marker == 0xC2
            lossless = marker == 0xC3
            if lossless and any(c['h'] != 1 or c['v'] != 1 for c in comps):
                raise _unsupported("subsampled lossless JPEG", path)
            coef_bits = [[-1] * 64 for _ in range(nf)]
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
            ns = body[0]
            ids = [c['id'] for c in comps]
            sel = [(ids.index(body[1 + 2 * i]), body[2 + 2 * i] >> 4,
                    body[2 + 2 * i] & 15) for i in range(ns)]
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            end = _scan_end(data, pos)
            if lossless:
                _decode_lossless(data[pos:end], comps, sel, tables, restart,
                                 W, H, ss, ahal & 15, path)
                pos = end
                continue
            hmax = max(c['h'] for c in comps)
            vmax = max(c['v'] for c in comps)
            mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            for c in comps:
                if 'coef' not in c:
                    c['dw'] = -(-W * c['h'] // hmax)
                    c['dh'] = -(-H * c['v'] // vmax)
                    # libjpeg's JCOEF: two bytes a coefficient
                    c['coef'] = np.zeros((mcuy * c['v'], mcux * c['h'], 64),
                                         np.int16)
                    if c['tq'] not in qt:     # libjpeg refuses it so
                        raise OSError(f"{path}: quantization table "
                                      f"{c['tq']} was not defined")
                    c['q'] = qt[c['tq']]
            for ci, _, _ in sel:
                coef_bits[ci][ss:se + 1] = [ahal & 15] * (se + 1 - ss)
            _decode_scan(data[pos:end], comps, sel, tables, restart, mcux,
                         mcuy, (ss, se, ahal >> 4, ahal & 15))
            pos = end
    if frame is None or not comps or not {'coef', 'samples'} & set(comps[0]):
        raise ValueError(f"{path}: no image data")
    cid = [c['id'] for c in comps]
    if lossless:
        planes = [c['samples'] for c in comps]
        if len(planes) == 1:
            return 'L', planes[0], None
        # libjpeg takes a lossless file without JFIF or Adobe markers
        # and with component ids 1, 2, 3 for RGB
        if jfif or adobe not in (None, 0) or len(planes) != 3:
            raise _unsupported("lossless JPEG in YCbCr or CMYK", path)
        return 'RGB', np.stack(planes, axis=-1), None
    if progressive and _smoothing_applies(comps, coef_bits):
        raise _unsupported("progressive JPEG whose scans leave low AC "
                           "coefficients incomplete (libjpeg's block "
                           "smoothing)", path)
    W, H = frame
    if colour == 'raw':
        # libjpeg's raw output (libtiff's old-JPEG codec reads it): each
        # component at its own resolution, whole MCUs, no upsampling
        return 'raw', [_idct_plane(c['coef'], c['q']) for c in comps], comps
    hmax = max(c['h'] for c in comps)
    vmax = max(c['v'] for c in comps)
    planes = []
    for c in comps:
        if hmax % c['h'] or vmax % c['v']:
            raise _unsupported("JPEG with non-integer sampling ratios", path)
        samples = _idct_plane(c['coef'], c['q'])[:c['dh'], :c['dw']]
        planes.append(_upsample(samples, hmax // c['h'], vmax // c['v'],
                                W, H))
    if colour == 'samples':
        return 'samples', np.stack(planes, axis=-1).astype(np.uint8), None
    if len(planes) == 1:
        return 'L', planes[0].astype(np.uint8), None
    if len(planes) == 4:
        if adobe not in (None, 0):          # YCCK (transform 2, or unknown)
            cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int64)
            planes[:3] = [cmy[..., i] for i in range(3)]
        cmyk = np.stack(planes, axis=-1).astype(np.int64)
        return 'CMYK', (255 - cmyk).astype(np.uint8), None
    rgb = (not jfif and adobe == 0) or (not jfif and adobe is None
                                         and cid == [82, 71, 66])
    if colour == 'YCbCr':
        rgb = False
    if rgb:
        return 'RGB', np.stack(planes, axis=-1).astype(np.uint8), None
    return 'RGB', _ycc_to_rgb(*planes), None


def read_jpeg(path: str) -> np.ndarray:
    """Read a JPEG to (H, W, 3) uint8 RGB, as PIL's ``convert('RGB')``
    gives it (a grey file's one channel repeated, CMYK through PIL's
    integer formula)."""
    from ..texture import _pil_rgb
    return _pil_rgb(*read_jpeg_mode(path))
