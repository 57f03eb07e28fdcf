"""A WebP lossless (VP8L) decoder without PIL: headers, prefix codes and
the colour transforms that vectorise in Python and numpy; each image's
entropy-coded pixels (``_pixels``) and the predictor and cross-colour
transforms (``_unpredict``, ``_uncross``) in host C++
(``native/bitmap_vp8l.cpp``), each beside its twin in Python and numpy
(``_pixels_plain``, ``_unpredict_plain``, ``_uncross_plain``), which the
tests hold it to.

Decodes what libwebp's lossless decoder decodes, to the same ARGB words:
the 5-byte header (signature 0x2f, 14-bit width and height less one, the
alpha hint, version 0); prefix codes (simple codes of one or two symbols
and normal codes whose lengths are themselves coded, with the repeat
codes 16-18), five to a group; the colour cache (1-11 bits) and meta
prefix codes (an entropy image that picks a group for each tile); LZ77
lengths and distances with the 120-entry distance map; and the four
transforms, undone in the reverse of their order in the stream:
predictor (14 modes), cross-colour, subtract-green and colour indexing
with pixel bundling for palettes of 2, 4 and 16 colours or fewer.
``decode_stream`` decodes a bare bitstream of known size too, as an
``ALPH`` chunk holds one. A truncated or malformed stream raises
``OSError``; no partial image is returned.
"""
from __future__ import annotations

import numpy as np

# the order in which the code-length code's lengths are stored
_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# the five alphabets of a group: green with the 24 length prefixes, red,
# blue, alpha and distance (a colour cache widens green by its size)
_ALPHABETS = (256 + 24, 256, 256, 256, 40)
# distance codes 1-120 as (dx, dy): the pixel dy rows up and dx columns
# left of the current one
_NEAR = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
_MAX_CACHE_BITS = 11


class BitReader:
    """LSB-first bits of a byte string. As in libwebp, a stream shorter
    than 8 bytes may be read as if padded with zeros to 8; reading past
    that raises ``OSError``."""

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(max(0, 8 - len(data)))
        self.pos = 0          # next byte to load
        self.val = 0          # loaded, unread bits, least significant first
        self.nb = 0           # their count

    def fill(self) -> None:
        chunk = self.data[self.pos:self.pos + 8]
        self.val |= int.from_bytes(chunk, 'little') << self.nb
        self.nb += 8 * len(chunk)
        self.pos += len(chunk)

    def read(self, n: int) -> int:
        if self.nb < n:
            self.fill()
            if self.nb < n:
                raise OSError("truncated WebP lossless bitstream")
        v = self.val & ((1 << n) - 1)
        self.val >>= n
        self.nb -= n
        return v

    @property
    def bitpos(self) -> int:
        """The position of the next unread bit in the stream (``pos`` may
        run past the end where ``_pixels_plain`` loaded its last bytes)."""
        return 8 * min(self.pos, len(self.data)) - self.nb

    def seek(self, bitpos: int) -> None:
        """Continue reading at bit ``bitpos``."""
        self.pos, self.val, self.nb = bitpos >> 3, 0, 0
        self.read(bitpos & 7)

    def symbol(self, code) -> int:
        tab, mask = code
        if self.nb < 15:
            self.fill()
        e = int(tab[self.val & mask])
        n = e & 15
        if n > self.nb:
            raise OSError("truncated WebP lossless bitstream")
        self.val >>= n
        self.nb -= n
        return e >> 4


def _code(lengths) -> tuple:
    """The decoding table of a canonical prefix code: (entries as an
    int32 array, mask);
    entry ``e`` at the next ``mask + 1`` bits' index codes symbol
    ``e >> 4`` in ``e & 15`` bits. One used symbol takes no bits; a code
    that is over-subscribed or incomplete raises, as in libwebp."""
    lengths = np.asarray(lengths, np.int64)
    syms = np.flatnonzero(lengths)
    if syms.size == 0:
        raise OSError("WebP lossless prefix code with no symbol")
    if syms.size == 1:
        return np.array([int(syms[0]) << 4], np.int32), 0
    lens = lengths[syms]
    if lens.max() > 15 or int((1 << (15 - lens)).sum()) != 1 << 15:
        raise OSError("WebP lossless prefix code is not complete")
    top = int(lens.max())
    order = np.lexsort((syms, lens))
    syms, lens = syms[order], lens[order]
    count = np.bincount(lens, minlength=top + 1)
    first, code = np.zeros(top + 1, np.int64), 0
    for n in range(1, top + 1):
        code = (code + count[n - 1]) << 1
        first[n] = code
    start = np.concatenate([[0], np.cumsum(count)])[lens]
    codes = first[lens] + np.arange(syms.size) - start
    rev = np.zeros_like(codes)
    for b in range(top):          # the stream sends a code's top bit first
        rev |= ((codes >> b) & 1) << np.maximum(lens - 1 - b, 0)
    reps = 1 << (top - lens)
    idx = np.repeat(rev, reps) + (np.arange(reps.sum()) - np.repeat(
        np.cumsum(reps) - reps, reps)) * np.repeat(1 << lens, reps)
    tab = np.empty(1 << top, np.int32)
    tab[idx] = np.repeat((syms << 4) | lens, reps)
    return tab, (1 << top) - 1


def _read_code(br: BitReader, size: int) -> tuple:
    """One prefix code of an alphabet of ``size`` symbols."""
    lengths = [0] * size
    if br.read(1):                               # simple: 1 or 2 symbols
        two = br.read(1)
        s = br.read(8 if br.read(1) else 1)
        if s < size:
            lengths[s] = 1
        if two:
            s = br.read(8)
            if s < size:
                lengths[s] = 1
        return _code(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_ORDER[i]] = br.read(3)
    lcode = _code(cl)
    if br.read(1):
        limit = 2 + br.read(2 + 2 * br.read(3))
        if limit > size:
            raise OSError("WebP lossless code lengths past the alphabet")
    else:
        limit = size
    prev, s = 8, 0
    while s < size:
        if limit == 0:
            break
        limit -= 1
        c = br.symbol(lcode)
        if c < 16:
            lengths[s] = c
            s += 1
            if c:
                prev = c
            continue
        extra, base = ((2, 3), (3, 3), (7, 11))[c - 16]
        rep = br.read(extra) + base
        if s + rep > size:
            raise OSError("WebP lossless code lengths past the alphabet")
        lengths[s:s + rep] = [prev if c == 16 else 0] * rep
        s += rep
    return _code(lengths)


def _plane_distance(code: int, xsize: int) -> int:
    if code > 120:
        return code - 120
    dx, dy = _NEAR[code - 1]
    return max(dy * xsize + dx, 1)


# mnt_vp8l_pixels's failures, each an OSError as in the plain version
_PIXEL_ERRORS = {1: "truncated WebP lossless bitstream",
                 2: "WebP lossless back-reference out of range",
                 3: "WebP lossless colour cache code out of range",
                 4: "WebP lossless tile group out of range"}


def _pixels(br: BitReader, w: int, h: int, cache_bits: int, groups: list,
            meta) -> np.ndarray:
    """``_pixels_plain`` in ``native/bitmap_vp8l.cpp``: the w * h ARGB
    words (uint32), ``br`` left after them; fails as the plain version
    does."""
    from ..native import bitmap_library, ptr
    codes = [code for group in groups for code in group]
    sizes = np.array([len(tab) for tab, _ in codes], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    tables = np.concatenate([tab for tab, _ in codes]).astype(np.int32)
    masks = np.array([mask for _, mask in codes], np.int32)
    if (sizes != masks.astype(np.int64) + 1).any():
        raise ValueError("a prefix code table does not match its mask")
    mbits, mxs, ent = meta if meta is not None else (30, 1, [0])
    ent = np.ascontiguousarray(ent, np.int32).reshape(-1)
    data = np.frombuffer(br.data, np.uint8)
    pos = np.array([br.bitpos], np.int64)
    out = np.empty(w * h, np.uint32)
    err = bitmap_library().mnt_vp8l_pixels(
        ptr(data), data.size, ptr(pos), w, h, cache_bits, ptr(tables),
        ptr(offsets), ptr(masks), len(groups), mbits, mxs, ptr(ent),
        ent.size, ptr(out))
    if err:
        raise OSError(_PIXEL_ERRORS[err])
    br.seek(int(pos[0]))
    return out


def _pixels_plain(br: BitReader, w: int, h: int, cache_bits: int,
                  groups: list, meta) -> list:
    """The w x h ARGB words of the entropy-coded image (before any
    transform), in Python: the plain version of ``_pixels``. ``groups``:
    five codes each; ``meta``: None or (bits, tiles a row, the group of
    each tile)."""
    groups = [[(tab.tolist(), mask) for tab, mask in group]
              for group in groups]
    if meta is not None:
        meta = (meta[0], meta[1], np.asarray(meta[2]).reshape(-1).tolist())
    n = w * h
    out = [0] * n
    data, pos, val, nb = br.data, br.pos, br.val, br.nb
    end = len(data)
    csize = (1 << cache_bits) if cache_bits else 0
    cache = [0] * csize
    cshift = 32 - cache_bits
    cached = 0                       # out[:cached] are in the cache
    if meta is None:             # one group: the tile test passes at x = 0
        meta = (30, 1, [0])
    mbits, mxs, ent = meta
    mmask = (1 << mbits) - 1
    i = x = y = 0
    gr = groups[0]
    (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = gr
    while i < n:
        if not x & mmask:
            gr = groups[ent[(y >> mbits) * mxs + (x >> mbits)]]
            (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = gr
        if nb < 60 and pos < end:
            chunk = data[pos:pos + 8]
            val |= int.from_bytes(chunk, 'little') << nb
            nb += 8 * len(chunk)
            pos += 8
        e = gt[val & gm]
        k = e & 15
        val >>= k
        nb -= k
        code = e >> 4
        if code < 256:
            e = rt[val & rm]
            k = e & 15
            val >>= k
            red = e >> 4
            nb -= k
            e = bt[val & bm]
            k = e & 15
            val >>= k
            blue = e >> 4
            nb -= k
            e = at[val & am]
            k = e & 15
            val >>= k
            nb -= k
            out[i] = ((e >> 4) << 24) | (red << 16) | (code << 8) | blue
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
        elif code < 280:
            s = code - 256
            if s < 4:
                length = s + 1
            else:
                k = (s - 2) >> 1
                length = ((2 + (s & 1)) << k) + (val & ((1 << k) - 1)) + 1
                val >>= k
                nb -= k
            e = dt[val & dm]
            k = e & 15
            val >>= k
            nb -= k
            s = e >> 4
            if s < 4:
                dist = s + 1
            else:
                k = (s - 2) >> 1
                dist = ((2 + (s & 1)) << k) + (val & ((1 << k) - 1)) + 1
                val >>= k
                nb -= k
            dist = _plane_distance(dist, w)
            if nb < 0:
                break
            if dist > i or i + length > n:
                raise OSError("WebP lossless back-reference out of range")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                run = out[i - dist:i]
                out[i:i + length] = (run * (length // dist + 1))[:length]
            i += length
            x += length
            if x >= w:
                y += x // w
                x %= w
            if x & mmask:
                gr = groups[ent[(y >> mbits) * mxs + (x >> mbits)]]
                (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = gr
        else:
            key = code - 280
            if key >= csize:
                raise OSError("WebP lossless colour cache code out of range")
            for px in out[cached:i]:
                cache[((px * 0x1e35a7bd) & 0xffffffff) >> cshift] = px
            cached = i
            out[i] = cache[key]
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
        if nb < 0:
            break
    if nb < 0:
        raise OSError("truncated WebP lossless bitstream")
    br.pos, br.val, br.nb = pos, val, nb
    return out


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _image(br: BitReader, w: int, h: int, top: bool) -> np.ndarray:
    """One entropy-coded image of w x h ARGB words: its colour cache,
    its groups of codes (with meta codes at the top level) and its
    pixels."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= _MAX_CACHE_BITS:
            raise OSError(f"WebP lossless colour cache of {cache_bits} bits")
    meta, ngroups = None, 1
    if top and br.read(1):
        bits = br.read(3) + 2
        xs = _sub(w, bits)
        ent = (_image(br, xs, _sub(h, bits), False) >> 8) & 0xFFFF
        ngroups = int(ent.max()) + 1
        meta = (bits, xs, ent.reshape(-1))
    sizes = list(_ALPHABETS)
    sizes[0] += (1 << cache_bits) if cache_bits else 0
    groups = [[_read_code(br, s) for s in sizes] for _ in range(ngroups)]
    return np.asarray(_pixels(br, w, h, cache_bits, groups, meta),
                      np.uint32).reshape(h, w)


def _add(a, b):
    """Per-byte sums of packed ARGB words (numpy arrays or ints)."""
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a, b):
    """Per-byte floor of the mean of packed ARGB words."""
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(t: int, left: int, tl: int) -> int:
    d = 0
    for s in (0, 8, 16, 24):
        c = (tl >> s) & 255
        d += abs(((left >> s) & 255) - c) - abs(((t >> s) & 255) - c)
    return t if d <= 0 else left


def _clamp_half(a: int, tl: int) -> int:
    v = 0
    for s in (0, 8, 16, 24):
        x = (a >> s) & 255
        d = x - ((tl >> s) & 255)
        c = x + (d // 2 if d >= 0 else -((-d) // 2))    # C's truncation
        v |= (0 if c < 0 else 255 if c > 255 else c) << s
    return v


# predictor modes that read the pixel to the left, and so run in order
_LEFT_MODES = (1, 5, 6, 7, 10, 11, 12, 13)


def _tiled(fn: str, px: np.ndarray, bits: int,
           tiles: np.ndarray) -> np.ndarray:
    """A tiled transform of ``native/bitmap_vp8l.cpp`` (``fn``) undone on
    the (h, w) pixels ``px``, each pixel's tile of ``tiles`` giving its
    parameters."""
    from ..native import bitmap_library, ptr
    h, w = px.shape
    if tiles.shape[0] < _sub(h, bits) or tiles.shape[1] < _sub(w, bits):
        raise IndexError("WebP lossless transform image too small")
    px = np.ascontiguousarray(px, np.uint32)
    tiles = np.ascontiguousarray(tiles, np.uint32)
    out = np.empty_like(px)
    getattr(bitmap_library(), fn)(ptr(px), w, h, bits, ptr(tiles),
                                  tiles.shape[1], ptr(out))
    return out


def _unpredict(res: np.ndarray, bits: int, tiles: np.ndarray) -> np.ndarray:
    """``_unpredict_plain`` in ``native/bitmap_vp8l.cpp``."""
    return _tiled('mnt_vp8l_unpredict', res, bits, tiles)


def _unpredict_plain(res: np.ndarray, bits: int,
                     tiles: np.ndarray) -> np.ndarray:
    """Undo the predictor transform: the top-left pixel predicted by
    opaque black, the rest of the top row by L, the left column by T,
    every other pixel by its tile's mode (the green byte's low 4 bits;
    14 and 15 act as 0, as in libwebp)."""
    h, w = res.shape
    out = np.empty_like(res)
    r0 = res[0].view(np.uint8).reshape(w, 4).astype(np.int64)
    r0[0, 3] += 0xFF
    out[0] = (np.cumsum(r0, axis=0) & 255).astype(np.uint8).view(
        np.uint32).reshape(w)
    modes = (tiles >> 8) & 15
    cols = np.arange(w) >> bits
    black = np.uint32(0xFF000000)
    for y in range(1, h):
        top = out[y - 1]
        m = modes[y >> bits][cols]
        m[0] = 2
        cur0 = _add(int(res[y, 0]), int(top[0]))
        tr = np.concatenate([top[1:], [cur0]])
        tl = np.concatenate([top[:1], top[:-1]])
        pred = np.where(m == 2, top, black)
        pred = np.where(m == 3, tr, pred)
        pred = np.where(m == 4, tl, pred)
        pred = np.where(m == 8, _avg(tl, top), pred)
        pred = np.where(m == 9, _avg(top, tr), pred)
        row = _add(res[y], pred)
        left_x = np.flatnonzero(np.isin(m, _LEFT_MODES))
        if left_x.size:
            cur = row.tolist()
            rl = res[y].tolist()
            tp = top.tolist()
            trl = tr.tolist()
            ml = m.tolist()
            for x in left_x.tolist():
                mode, left, t = ml[x], cur[x - 1], tp[x]
                if mode == 12:                      # clamp(L + T - TL)
                    # two bytes a 16-bit lane, biased by 256: a lane under
                    # 256 clamps to 0, one from 512 to 255
                    tl = tp[x - 1]
                    e = (left & 0xFF00FF) + (t & 0xFF00FF) + 0x1000100 - \
                        (tl & 0xFF00FF)
                    o = ((left >> 8) & 0xFF00FF) + ((t >> 8) & 0xFF00FF) + \
                        0x1000100 - ((tl >> 8) & 0xFF00FF)
                    eo, oo = (e >> 9) & 0x10001, (o >> 9) & 0x10001
                    p = ((e & ((e >> 8) & 0x10001 & ~eo) * 255) | eo * 255) \
                        | ((o & ((o >> 8) & 0x10001 & ~oo) * 255) | oo * 255) \
                        << 8
                elif mode == 1:
                    p = left
                elif mode == 7:
                    p = (((left ^ t) & 0xFEFEFEFE) >> 1) + (left & t)
                elif mode == 11:
                    p = _select(t, left, tp[x - 1])
                elif mode == 13:
                    p = _clamp_half((((left ^ t) & 0xFEFEFEFE) >> 1)
                                    + (left & t), tp[x - 1])
                elif mode == 5:
                    a = trl[x]
                    a = (((left ^ a) & 0xFEFEFEFE) >> 1) + (left & a)
                    p = (((a ^ t) & 0xFEFEFEFE) >> 1) + (a & t)
                elif mode == 6:
                    a = tp[x - 1]
                    p = (((left ^ a) & 0xFEFEFEFE) >> 1) + (left & a)
                else:                                 # 10
                    a, b = tp[x - 1], trl[x]
                    a = (((left ^ a) & 0xFEFEFEFE) >> 1) + (left & a)
                    b = (((t ^ b) & 0xFEFEFEFE) >> 1) + (t & b)
                    p = (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)
                r = rl[x]
                cur[x] = (((r & 0xFF00FF00) + (p & 0xFF00FF00))
                          & 0xFF00FF00) | (((r & 0x00FF00FF)
                                            + (p & 0x00FF00FF)) & 0x00FF00FF)
            row = np.array(cur, np.uint32)
        out[y] = row
    return out


def _tile_map(tiles: np.ndarray, bits: int, h: int, w: int) -> np.ndarray:
    """Each pixel's entry of a transform's tile image."""
    return tiles[(np.arange(h) >> bits)[:, None], (np.arange(w) >> bits)]


def _uncross(px: np.ndarray, bits: int, tiles: np.ndarray) -> np.ndarray:
    """``_uncross_plain`` in ``native/bitmap_vp8l.cpp``."""
    return _tiled('mnt_vp8l_uncross', px, bits, tiles)


def _uncross_plain(px: np.ndarray, bits: int,
                   tiles: np.ndarray) -> np.ndarray:
    """Undo the cross-colour transform (green to red, green to blue and
    red to blue, each a signed 3.5 fixed-point factor of its tile)."""
    m = _tile_map(tiles, bits, *px.shape)
    g2r = (m & 255).astype(np.uint8).view(np.int8).astype(np.int32)
    g2b = ((m >> 8) & 255).astype(np.uint8).view(np.int8).astype(np.int32)
    r2b = ((m >> 16) & 255).astype(np.uint8).view(np.int8).astype(np.int32)
    green = ((px >> 8) & 255).astype(np.uint8).view(np.int8).astype(
        np.int32)
    red = ((px >> 16) & 255).astype(np.int32)
    red = (red + ((g2r * green) >> 5)) & 255
    red8 = red.astype(np.uint8).view(np.int8).astype(np.int32)
    blue = ((px & 255).astype(np.int32) + ((g2b * green) >> 5)
            + ((r2b * red8) >> 5)) & 255
    return (px & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << 16) | \
        blue.astype(np.uint32)


def _add_green(px: np.ndarray) -> np.ndarray:
    g = (px >> 8) & 255
    rb = ((px & 0x00FF00FF) + (g << 16 | g)) & 0x00FF00FF
    return (px & np.uint32(0xFF00FF00)) | rb


def _unindex(px: np.ndarray, bits: int, palette: np.ndarray,
             w: int) -> np.ndarray:
    """Undo colour indexing: each index (2, 4 or 8 of them bundled into a
    green byte when the palette has at most 16, 4 or 2 colours) looks up
    the palette; indices past its end read transparent black."""
    full = np.zeros(1 << (8 >> bits), np.uint32)
    full[:min(palette.size, full.size)] = palette[:full.size]
    green = (px >> 8) & 255
    if bits:
        per = 1 << bits
        width = 8 >> bits
        x = np.arange(w)
        g = green[:, x >> bits]
        idx = (g >> ((x & (per - 1)) * width).astype(np.uint32)) & \
            ((1 << width) - 1)
    else:
        idx = green
    return full[idx]


def decode_stream(br: BitReader, w: int, h: int) -> np.ndarray:
    """The w x h ARGB words (uint32) of a top-level image: its
    transforms, then its entropy-coded pixels, then the transforms
    undone."""
    transforms, seen, xs = [], set(), w
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise OSError("WebP lossless transform repeated")
        seen.add(kind)
        if kind in (0, 1):                    # predictor, cross-colour
            bits = br.read(3) + 2
            transforms.append((kind, bits, _image(
                br, _sub(xs, bits), _sub(h, bits), False), xs))
        elif kind == 2:                       # subtract green
            transforms.append((kind, 0, None, xs))
        else:                                 # colour indexing
            ncol = br.read(8) + 1
            bits = 0 if ncol > 16 else 1 if ncol > 4 else 2 if ncol > 2 \
                else 3
            pal = _image(br, ncol, 1, False).reshape(-1)
            pal = (np.cumsum(pal.view(np.uint8).reshape(-1, 4).astype(
                np.int64), axis=0) & 255).astype(np.uint8).view(
                    np.uint32).reshape(-1)
            transforms.append((kind, bits, pal, xs))
            xs = _sub(xs, bits)
    px = _image(br, xs, h, True)
    for kind, bits, data, width in reversed(transforms):
        if kind == 0:
            px = _unpredict(px, bits, data)
        elif kind == 1:
            px = _uncross(px, bits, data)
        elif kind == 2:
            px = _add_green(px)
        else:
            px = _unindex(px, bits, data, width)
    return px


def header(data: bytes) -> tuple:
    """(width, height, alpha hint) of a VP8L bitstream; ``OSError`` if
    it is not one (signature 0x2f, version 0)."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        raise OSError("not a WebP lossless bitstream")
    v = int.from_bytes(data[1:5], 'little')
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, (v >> 28) & 1


def decode(data: bytes) -> np.ndarray:
    """A VP8L bitstream (a ``VP8L`` chunk's payload) to its (H, W) ARGB
    words, uint32."""
    w, h, _ = header(data)
    br = BitReader(data)
    br.read(32)
    br.read(8)
    return decode_stream(br, w, h)


def decode_alpha(data: bytes, w: int, h: int) -> np.ndarray:
    """The (H, W) uint8 alpha plane a headerless VP8L stream holds in its
    green bytes (an ``ALPH`` chunk compressed with method 1)."""
    px = decode_stream(BitReader(data), w, h)
    return ((px >> 8) & 255).astype(np.uint8)
