"""A TIFF decoder in numpy, zlib and the bitmap library (no PIL): the
first image (IFD).

Reads what PIL's ``TiffImagePlugin`` (and libtiff under it) reads, to the
same mode and samples, for the layouts of PIL's ``OPEN_INFO`` table that
are listed in ``_LAYOUTS``:

  * either byte order, classic TIFF and BigTIFF; strips and tiles (edge
    tiles cut); planar configuration 1 and 2; fill order 2;
  * compression none (1), LZW (5, in ``native/bitmap_lzw.cpp``), Deflate
    (8 and 32946), PackBits (32773), LZMA (34925: an xz stream a strip
    or tile, through the standard library's ``lzma``) and Zstandard
    (50000: a frame a strip or tile, ``utils/zstd.py``); predictor 2
    (horizontal differencing at 8, 16 and 32 bits) and 3 (libtiff's
    floating-point predictor) on LZW, Deflate, LZMA and Zstandard;
  * CCITT: modified Huffman (2), its word-aligned form (32771), T.4 (3:
    1-D and 2-D, ``T4Options``) and T.6 (4), in
    ``native/bitmap_ccitt.cpp`` (``utils/ccitt.py``);
  * ThunderScan (32809), 4-bit samples only, as libtiff's
    ``tif_thunder.c`` decodes it (``_thunderscan``, in
    ``native/bitmap_raster.cpp``), strips only;
  * SGILog (34676, 34677) and WebP (50001) raise ``OSError`` as PIL's
    load does: the photometrics SGILog needs are missing from PIL's
    table (``Image.open`` fails), its codec refuses every other, and the
    libtiff PIL bundles has no WebP codec;
  * photometric 0 (WhiteIsZero) and 1 (BlackIsZero) at 1, 2, 4, 8, 12
    (as ``I;16``, little-endian only, as PIL's table has it) and 16 bits
    and 32-bit integer or float samples; 2 (RGB, 8 or 16 bits, with
    unspecified, associated or unassociated alpha); 3 (palette, the
    16-bit colour map cut to its high byte as PIL does); 5 (CMYK) and 8
    (CIELab, as ``LAB``: its a* and b* offset by 128 as PIL unpacks them,
    converted to RGB by ``utils/lab.py``);
  * JPEG (compression 7) of every 8-bit layout, strips or tiles, each a
    JPEG stream after the shared ``JPEGTables`` (``utils/jpeg.py``): in
    one plane, YCbCr converted by libjpeg's tables and fancy upsampling,
    as libtiff's ``JPEGCOLORMODE_RGB`` asks under PIL, and the samples
    of any other photometric (grey, RGB, CMYK, with extra samples) taken
    as they are; in planes, each plane a one-component stream, YCbCr
    planes converted by libtiff's tables as PIL's RGBA reader does;
  * YCbCr (photometric 6) without JPEG, 8 bits in one plane, subsampling
    1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4 (1x4 and 2x4, which libtiff
    refuses, raise ``OSError``), as libtiff's RGBA reader under PIL
    converts it: each pixel takes its block's Cb and Cr whatever
    ``YCbCrPositioning`` says, through the integer tables that libtiff
    builds from ``YCbCrCoefficients`` and ``ReferenceBlackWhite`` in
    float32; uncompressed, as PIL's own reader unpacks it (as RGBX, strip
    by strip or tile by tile).
    Predictor 2 above 1x1 runs as libtiff runs it, over its "scanlines"
    of data units at a stride of 3 bytes, or not at all where those do
    not divide (the strip then converted undifferenced, as under PIL).
    In planes: uncompressed, the planes taken as RGB as PIL's reader
    takes them; compressed, converted at 1x1 and refused above. One
    sample: grey uncompressed, refused compressed (``OSError``);
  * old-style JPEG (6) as libtiff's OJPEG codec reads it: the stream
    ``JPEGInterchangeFormat`` points at, a stream held in the strips, or
    strips of entropy-coded data with the ``JPEGProc`` tables, each strip
    a restart interval; the components at their own resolution, through
    the YCbCr tables above;
  * every orientation, turned as PIL's ``exif_transpose`` turns the image
    at load (5-8 swap width and height).

A layout missing from PIL's table raises ``OSError``, as ``Image.open``
does, as does a compression missing from PIL's ``COMPRESSION_INFO``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

# PIL's COMPRESSION_INFO: the compressions its TIFF plugin opens
COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676,
                34677, 34925, 50000, 50001)
# the codecs the libtiff PIL bundles refuses on these files at load
_REFUSED = {34676: "SGILog", 34677: "SGILog", 50001: "WebP"}

# (photometric, sample format, bits a sample, extra samples) -> PIL mode;
# layouts PIL opens only in one byte order carry it as a fifth entry
_LAYOUTS = {}
for _ph in (0, 1):
    for _b in (1, 2, 4, 8):
        _LAYOUTS[(_ph, (1,), (_b,), ())] = '1' if _b == 1 else 'L'
_LAYOUTS.update({
    (1, (2,), (8,), ()): 'L',
    (0, (1,), (16,), (), 'II'): 'I;16',
    (1, (1,), (16,), (), 'II'): 'I;16',
    (1, (1,), (16,), (), 'MM'): 'I;16B',
    (1, (2,), (16,), ()): 'I',
    (0, (3,), (32,), ()): 'F',
    (1, (3,), (32,), ()): 'F',
    (1, (1,), (32,), (), 'II'): 'I',
    (1, (2,), (32,), ()): 'I',
    (1, (1,), (8, 8), (2,)): 'LA',
    (2, (1,), (8, 8, 8), ()): 'RGB',
    (2, (1,), (8, 8, 8, 8), ()): 'RGBA',
    (2, (1,), (16, 16, 16), ()): 'RGB',
    (2, (1,), (16, 16, 16, 16), ()): 'RGBA',
    (3, (1,), (1,), ()): 'P',
    (3, (1,), (2,), ()): 'P',
    (3, (1,), (4,), ()): 'P',
    (3, (1,), (8,), ()): 'P',
    (3, (1,), (8, 8), (0,)): 'P',
    (3, (1,), (8, 8), (2,)): 'PA',
    (5, (1,), (8, 8, 8, 8), ()): 'CMYK',
    (5, (1,), (8, 8, 8, 8, 8), (0,)): 'CMYK',
    (5, (1,), (8, 8, 8, 8, 8, 8), (0, 0)): 'CMYK',
    (5, (1,), (16, 16, 16, 16), ()): 'CMYK',
    # YCbCr: libtiff's RGBA reader, or libjpeg's conversion under JPEG
    (6, (1,), (8, 8, 8), ()): 'RGB',
    (6, (1,), (8,), ()): 'L',
    (8, (1,), (8, 8, 8), ()): 'LAB',
    (1, (1,), (12,), (), 'II'): 'I;16',
})
for _ex in ((0,), (0, 0), (0, 0, 0), (1,), (1, 0), (1, 0, 0), (2,), (2, 0),
            (2, 0, 0), (999,)):
    _LAYOUTS[(2, (1,), (8,) * (3 + len(_ex)), _ex)] = \
        'RGB' if _ex[0] == 0 else 'RGBA'
for _ex in ((0,), (1,), (2,)):
    _LAYOUTS[(2, (1,), (16,) * 4, _ex)] = 'RGB' if _ex[0] == 0 else 'RGBA'
# the layouts PIL's table also holds with fill order 2 (bits reversed)
_FILL2 = {(_ph, (1,), (_b,), ()) for _ph in (0, 1, 3) for _b in (1, 2, 4, 8)}
_FILL2 |= {(2, (1,), (8, 8, 8), ()), (1, (1,), (16,), (), 'II')}
# libtiff's defaults: YCbCrCoefficients, and ReferenceBlackWhite of YCbCr
_LUMA = (0.299, 0.587, 0.114)
_YCC_BLACK_WHITE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
# the subsamplings of libtiff's RGBA reader (putcontig8bitYCbCr*tile)
_YCC_SUBSAMPLING = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))

_TYPES = {1: 'B', 2: 's', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B',
          8: 'h', 9: 'i', 10: 'ii', 11: 'f', 12: 'd', 16: 'Q', 17: 'q',
          18: 'Q'}


def _ifd(data: bytes):
    """The first IFD's tags as {tag: tuple of values}, and the byte
    order ('<' or '>')."""
    bo = '<' if data[:2] == b'II' else '>'
    big = struct.unpack_from(bo + 'H', data, 2)[0] == 43
    if big and bo == '>':
        # PIL tests byte 2 of the header for BigTIFF, which holds 43 only
        # in the little-endian form: it opens no big-endian BigTIFF
        raise OSError("cannot identify image file (big-endian BigTIFF)")
    if big:
        pos = struct.unpack_from(bo + 'Q', data, 8)[0]
        n = struct.unpack_from(bo + 'Q', data, pos)[0]
        pos, esize, head, inline = pos + 8, 20, 'HHQ', 8
    else:
        pos = struct.unpack_from(bo + 'I', data, 4)[0]
        n = struct.unpack_from(bo + 'H', data, pos)[0]
        pos, esize, head, inline = pos + 2, 12, 'HHI', 4
    tags = {}
    for k in range(n):
        e = pos + k * esize
        tag, typ, count = struct.unpack_from(bo + head, data, e)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize('<' + fmt) * count
        off = e + 4 + (8 if big else 4)
        if size > inline:
            off = struct.unpack_from(bo + ('Q' if big else 'I'), data,
                                     e + 4 + (8 if big else 4))[0]
        if typ == 2:
            tags[tag] = (data[off:off + count].split(b'\0')[0],)
            continue
        vals = struct.unpack_from(f'{bo}{count * len(fmt)}{fmt[0]}', data, off)
        if len(fmt) == 2:                      # rationals
            vals = tuple(a / b if b else 0.0
                         for a, b in zip(vals[::2], vals[1::2]))
        tags[tag] = vals
    return tags, bo


def _lzw(src: bytes, expect: int) -> bytes:
    """TIFF LZW: the first ``expect`` bytes of the stream (fewer where it
    ends first), in ``native/bitmap_lzw.cpp``. Fails as ``_lzw_plain``
    does."""
    from ..native import bitmap_library, ptr
    if src[:1] == b'\0' and len(src) > 1 and src[1] & 1:
        raise OSError("old-style (LSB-first) TIFF LZW")
    buf = np.frombuffer(src, np.uint8)
    out = np.empty(max(expect, 0), np.uint8)
    n = bitmap_library().mnt_tiff_lzw(ptr(buf), buf.size, ptr(out),
                                      out.size)
    if n < 0:
        raise IndexError("list index out of range")
    return out[:min(n, out.size)].tobytes()


def _lzw_plain(src: bytes, expect: int) -> bytes:
    """``_lzw`` in Python, the plain version the tests hold it to: MSB-first
    codes from 9 to 12 bits, the width growing one code early, clear 256,
    end 257."""
    if src[:1] == b'\0' and len(src) > 1 and src[1] & 1:
        raise OSError("old-style (LSB-first) TIFF LZW")
    table = [bytes([i]) for i in range(256)] + [b'', b'']
    out = bytearray()
    width, acc, nacc, pos, prev = 9, 0, 0, 0, None
    n = len(src)
    while len(out) < expect:
        while nacc < width and pos < n:
            acc = (acc << 8) | src[pos]
            nacc += 8
            pos += 1
        if nacc < width:
            break
        nacc -= width
        code = (acc >> nacc) & ((1 << width) - 1)
        acc &= (1 << nacc) - 1
        if code == 256:
            table = table[:258]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            s = table[code]
        elif code < len(table):
            s = table[code]
            table.append(prev + s[:1])
        else:
            s = prev + prev[:1]
            table.append(s)
        out += s
        prev = s
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out[:max(expect, 0)])


def _packbits(src: bytes, expect: int) -> bytes:
    out, pos = bytearray(), 0
    while pos < len(src) and len(out) < expect:
        h = src[pos]
        pos += 1
        if h < 128:
            out += src[pos:pos + h + 1]
            pos += h + 1
        elif h > 128:
            out += src[pos:pos + 1] * (257 - h)
            pos += 1
    return bytes(out)


def _decompress(comp: int, src: bytes, expect: int, path: str) -> bytes:
    """A strip or tile of a byte-oriented compression, at least its first
    ``expect`` bytes where the data holds them."""
    if comp == 1:
        return src
    if comp == 5:
        return _lzw(src, expect)
    if comp in (8, 32946):
        return zlib.decompressobj().decompress(src)
    if comp == 32773:
        return _packbits(src, expect)
    if comp == 34925:
        # libtiff's LZMA codec: an xz stream, read until the strip is full
        import lzma
        try:
            return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
                src, max_length=expect)
        except lzma.LZMAError as e:
            raise OSError(f"{path}: LZMA data: {e}") from e
    # libtiff's Zstandard codec reads one frame until the strip is full
    from . import zstd
    return zstd.decompress(src, expect, 1)


def _thunderscan(src: bytes, width: int, rows: int) -> bytes:
    """``rows`` rows of ``width`` 4-bit pixels of ThunderScan data, each
    row packed high nibble first, in ``native/bitmap_raster.cpp``. Fails
    as ``_thunderscan_plain`` does."""
    from ..native import bitmap_library, ptr
    buf = np.frombuffer(src, np.uint8)
    out = np.empty(rows * ((width + 1) // 2), np.uint8)
    rc = bitmap_library().mnt_thunderscan(ptr(buf), buf.size, width, rows,
                                          ptr(out))
    if rc < 0:
        raise OSError("ThunderScan data: " + ("not enough data" if rc == -1
                                              else "too much data"))
    return out.tobytes()


_TWO_BIT = (0, 1, 0, -1)
_THREE_BIT = (0, 1, 2, 3, 0, -3, -2, -1)


def _thunderscan_plain(src: bytes, width: int, rows: int) -> bytes:
    """``_thunderscan`` in Python: libtiff's ``ThunderDecode``, a row at a
    time from the last pixel 0; a run that reaches or passes the row's
    end writes nothing, one that passes it fails the row."""
    stride = (width + 1) // 2
    out = bytearray(rows * stride)
    pos = 0
    for r in range(rows):
        op, last, n = r * stride, 0, 0

        def put(v):
            nonlocal op, last, n
            last = v & 15
            if n < width:
                if n & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                n += 1
        while pos < len(src) and n < width:
            c = src[pos]
            pos += 1
            kind = c & 0xC0
            if kind == 0:                       # a run of the last pixel
                c &= 0x3F
                if n & 1:
                    out[op] |= last
                    last = out[op]
                    op += 1
                    n += 1
                    c -= 1
                else:
                    last |= last << 4
                n += c
                if n < width:
                    while c > 0:
                        out[op] = last
                        op += 1
                        c -= 2
                if c == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 15
            elif kind == 0x40:
                for sh in (4, 2, 0):
                    if c >> sh & 3 != 2:
                        put(last + _TWO_BIT[c >> sh & 3])
            elif kind == 0x80:
                for sh in (3, 0):
                    if c >> sh & 7 != 4:
                        put(last + _THREE_BIT[c >> sh & 7])
            else:
                put(c)
        if n != width:
            raise OSError("ThunderScan data: " + ("not enough data" if
                                                  n < width else
                                                  "too much data"))
    return bytes(out)


def _unpredict(block: np.ndarray, pred: int, spp: int, bps: int,
               bo: str) -> np.ndarray:
    """A decompressed block (rows, row bytes) with its predictor undone:
    (rows, samples) in native order for 16 and 32 bits."""
    rows = block.shape[0]
    if pred == 3:                             # floating point
        nb = bps // 8
        acc = block.reshape(rows, -1, spp).astype(np.uint64)
        acc = (np.cumsum(acc, axis=1) & 0xFF).astype(np.uint8)
        planes = acc.reshape(rows, nb, -1)    # most significant first
        return np.ascontiguousarray(planes.transpose(0, 2, 1)).view(
            f'>f{nb}').astype(f'=f{nb}')
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bps]
    vals = block.view(np.dtype(dt).newbyteorder(bo)).astype(dt)
    if pred == 2:
        v = vals.reshape(rows, -1, spp)
        vals = np.cumsum(v, axis=1, dtype=dt).reshape(rows, -1)
    return vals


def _ycbcr_tables(luma, black_white):
    """libtiff's ``TIFFYCbCrToRGBInit`` (``tif_color.c``): the integer
    tables of its YCbCr -> RGB conversion, built in float32 as there."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)

    def fix(v):                  # FIX(CLAMP(v, 0, 2)): v * 2^16 + 0.5
        v = min(max(v, f32(0)), f32(2))
        return int(np.trunc(float(v * f32(65536)) + 0.5))

    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)

    def code2v(c, rb, rw, cr):   # Code2V, then CLAMP to +-4096, truncated
        den = f32(rw) - f32(rb)
        v = (c - int(np.trunc(f32(rb)))).astype(f32) * f32(cr) / \
            (den if den != 0 else f32(1))
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)
    x = np.arange(-128, 128)
    bw = [f32(v) for v in black_white]
    cr = code2v(x, bw[4] - f32(128), bw[5] - f32(128), 127)
    cb = code2v(x, bw[2] - f32(128), bw[3] - f32(128), 127)
    y = code2v(x + 128, bw[0], bw[1], 255)
    return (y, (d1 * cr + 32768) >> 16, d2 * cr, d4 * cb + 32768,
            (d3 * cb + 32768) >> 16)


def _ycbcr_to_rgb(units: np.ndarray, hs: int, vs: int, tables):
    """Decompressed YCbCr data units (block rows, blocks, hs * vs + 2) as
    (block rows * vs, blocks * hs, 3) RGB: each pixel of a block takes its
    block's Cb and Cr (libtiff's ``putcontig8bitYCbCr*tile``, which ignore
    ``YCbCrPositioning``) through ``TIFFYCbCrtoRGB``."""
    rows, cols = units.shape[:2]
    y = units[..., :hs * vs].reshape(rows, cols, vs, hs).transpose(
        0, 2, 1, 3).reshape(rows * vs, cols * hs).astype(np.int64)
    cb = np.repeat(np.repeat(units[..., -2], vs, 0), hs, 1).astype(np.int64)
    cr = np.repeat(np.repeat(units[..., -1], vs, 0), hs, 1).astype(np.int64)
    y_tab, cr_r, cr_g, cb_g, cb_b = tables
    yv = y_tab[y]
    rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16),
                    yv + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ycbcr_raw_chunks(data: bytes, W: int, H: int, tw: int, th: int,
                      offsets, path: str) -> np.ndarray:
    """An uncompressed YCbCr TIFF as PIL's own raw reader leaves it: its
    table unpacks the layout as ``RGBX``, four bytes a pixel, so each strip
    or tile (``tw`` x ``th``; a strip is the image's width), cut to the
    image, reads 4 bytes a pixel of a row from its offset on. A tile past
    the right edge steps its rows by the stride PIL gives it, 3 * tw
    bytes (its three 8-bit samples a pixel), and fails where that is
    shorter than the row it reads, as PIL's raw decoder does. A read past
    the file's end raises ``OSError`` as ``ImageFile.load`` does."""
    out = np.zeros((H, W, 3), np.uint8)
    across = -(-W // tw)
    for k, off in enumerate(offsets):
        ty, tx = divmod(k, across)
        y, x = ty * th, tx * tw
        if y >= H:
            break
        n, w = min(th, H - y), min(tw, W - x)
        stride = 3 * tw if x + tw > W else 4 * w
        if stride < 4 * w:
            raise OSError(f"{path}: decoder error -8")
        if off + (n - 1) * stride + 4 * w > len(data):
            raise OSError(f"{path}: image file is truncated")
        for r in range(n):
            start = off + r * stride
            out[y + r, x:x + w] = np.frombuffer(
                data, np.uint8, 4 * w, start).reshape(w, 4)[:, :3]
    return out


# PIL's load-time transposition of each orientation (ImageOps.exif_transpose)
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
           6: lambda a: np.rot90(a, -1),
           7: lambda a: np.rot90(a, 2).swapaxes(0, 1),
           8: lambda a: np.rot90(a, 1)}


def read_tiff(path: str):
    """Read a TIFF's first image to ``(mode, pixels, palette)``: ``1``,
    ``L``, ``I;16``, ``I;16B``, ``I``, ``F`` ((H, W)), ``LA``, ``PA``,
    ``RGB``, ``RGBA``, ``CMYK``, ``LAB`` ((H, W, C), 8-bit; 16-bit colour
    cut to its high byte and associated alpha divided out, as PIL unpacks
    them) or ``P`` ((H, W) indices and an (N, 3) palette), turned as its
    orientation says (PIL transposes at load)."""
    with open(path, 'rb') as f:
        data = f.read()
    tags, bo = _ifd(data)
    mode, px, pal = _read_image(data, tags, bo, path)
    turn = _ORIENT.get(tags.get(274, (1,))[0])
    return mode, px if turn is None else np.ascontiguousarray(turn(px)), pal


def _unpack12(raw: np.ndarray, nrows: int, width: int) -> np.ndarray:
    """Rows of 12-bit samples packed MSB first (PIL's ``I;12``), each row
    from a byte boundary: (nrows, width) uint16."""
    bits = np.unpackbits(raw.reshape(nrows, -1), axis=1)[:, :12 * width]
    return (bits.reshape(nrows, width, 12).astype(np.uint16)
            << np.arange(11, -1, -1, dtype=np.uint16)).sum(-1,
                                                           dtype=np.uint16)


def _ycbcr_unpredict(raw: np.ndarray, line: int):
    """libtiff's horizontal predictor over subsampled YCbCr data units:
    it runs over "rows" of ``line`` bytes (``TIFFScanlineSize``: a block
    row over its height, for strips; ``TIFFTileRowSize``: the tile width
    times 3, for tiles) at a stride of 3 bytes. Where the data is no
    whole number of rows, or a row no whole number of strides, it fails
    the strip, and the RGBA reader under PIL converts the data as it was
    decoded, undifferenced."""
    if line == 0 or raw.size % line or line % 3:
        return raw
    v = raw.reshape(-1, line // 3, 3)
    return np.cumsum(v, axis=1, dtype=np.uint8).reshape(-1)


def _ojpeg_units(stream: bytes, W: int, H: int, path: str):
    """An old-style JPEG stream's samples as libtiff's OJPEG codec hands
    them to its RGBA reader: the components' own resolution (libjpeg's raw
    output, no upsampling or colour conversion), as data units of hs x vs
    luma samples and one Cb and Cr; returns them (block rows, blocks,
    hs * vs + 2) with (hs, vs) from the stream's sampling factors."""
    from . import jpeg
    _, planes, comps = jpeg.decode(stream, path, 'raw')
    if len(planes) != 3:
        raise OSError(f"{path}: old-style JPEG of {len(planes)} components")
    hs, vs = comps[0]['h'] // comps[1]['h'], comps[0]['v'] // comps[1]['v']
    if any(c['h'] != 1 or c['v'] != 1 for c in comps[1:]) or \
            (hs, vs) not in _YCC_SUBSAMPLING:
        raise OSError(f"{path}: old-style JPEG sampling not supported")
    bh, bw = -(-H // vs), -(-W // hs)
    y = planes[0]
    if y.shape[0] < bh * vs or y.shape[1] < bw * hs or \
            planes[1].shape[0] < bh or planes[1].shape[1] < bw:
        raise OSError(f"{path}: old-style JPEG smaller than the image")
    luma = y[:bh * vs, :bw * hs].reshape(bh, vs, bw, hs).transpose(
        0, 2, 1, 3).reshape(bh, bw, vs * hs)
    return np.concatenate([luma, planes[1][:bh, :bw, None],
                           planes[2][:bh, :bw, None]], -1), hs, vs


def _read_image(data: bytes, tags: dict, bo: str, path: str):
    from . import ccitt, jpeg
    order = 'II' if bo == '<' else 'MM'
    W, H = tags[256][0], tags[257][0]
    comp = tags.get(259, (1,))[0]
    if comp not in COMPRESSIONS:
        # PIL's COMPRESSION_INFO lookup fails its open (a KeyError, which
        # its ImageFile turns into a failed open)
        raise OSError(f"cannot identify image file '{path}' (TIFF "
                      f"compression {comp})")
    photo = tags.get(262, (0,))[0]
    if comp == 6:                       # PIL: old JPEG is always YCbCr
        photo = 6
    fill = tags.get(266, (1,))[0]
    planar = tags.get(284, (1,))[0]
    pred = tags.get(317, (1,))[0]
    sfmt = tags.get(339, (1,))
    if len(sfmt) > 1 and max(sfmt) == min(sfmt) == 1:
        sfmt = (1,)
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    spp = tags.get(277, (3,) if comp == 6 and photo in (2, 6) else (1,))[0]
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise OSError(f"{path}: unknown TIFF data organization")
    key = (photo, tuple(sfmt), tuple(bps), tuple(extra))
    mode = _LAYOUTS.get(key, _LAYOUTS.get(key + (order,)))
    if mode is None or fill == 2 and not {key, key + (order,)} & _FILL2:
        raise OSError(f"{path}: TIFF layout PIL does not open {key}")
    if comp in _REFUSED:
        raise OSError(f"{path}: {_REFUSED[comp]} TIFF: decoder error -2")
    is_jpeg, ycbcr = comp == 7, photo == 6 and mode == 'RGB'
    if is_jpeg and bps[0] != 8:
        raise OSError(f"{path}: JPEG TIFF with {bps[0]}-bit samples "
                      "(libtiff's JPEG codec reads 8 bits here)")
    if comp in (2, 3, 4, 32771) and bps != (1,):
        raise OSError(f"{path}: CCITT TIFF with {bps} bits a sample "
                      "(libtiff: bits/sample must be 1)")
    if comp == 32809 and (bps[0] != 4 or 322 in tags):
        raise OSError(f"{path}: ThunderScan TIFF of {bps[0]}-bit samples "
                      "or tiles (libtiff decodes 4-bit strips only)")
    if photo == 6 and mode == 'L' and comp != 1:
        # libtiff's RGBA reader, which PIL's libtiff path takes for
        # YCbCr, has no routine for one sample
        raise OSError(f"{path}: one-sample YCbCr: decoder error -2")
    b = bps[0]                  # every layout of the table has one width
    if comp not in (5, 8, 32946, 34925, 50000):
        pred = 1                # libtiff's predictor rides on these codecs
    if pred not in (1, 2, 3) or pred > 1 and b not in (8, 16, 32, 64):
        raise OSError(f"{path}: TIFF predictor {pred} at {b} bits")
    if comp == 1 and (fill == 2 and key == (0, (1,), (8,), ()) or
                      planar == 2 and extra and extra[0] in (0, 1)):
        # PIL's own reader (uncompressed files) has no unpacker for these
        raise ValueError(f"{path}: unknown raw mode for this TIFF layout")
    if comp != 1 and planar == 2 and extra[:1] == (0,):
        raise OSError(f"{path}: PIL's libtiff reader refuses planar "
                      "unspecified extra samples")
    if comp != 1 and planar == 2 and key == (2, (1,), (8,) * 4, ()):
        extra = (1,)      # libtiff's planar path takes it as associated
    if 322 in tags:
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags.get(325)
    else:
        tw, th = W, tags.get(278, (H,))[0]
        th = min(th, H) if th else H
        offsets, counts = tags[273], tags.get(279)
    hs, vs = 1, 1
    if ycbcr and not is_jpeg:
        hs, vs = tags.get(530, (2, 2))[:2]
        if comp != 6 and ((hs, vs) in ((1, 4), (2, 4)) or comp != 1 and (
                (hs, vs) not in _YCC_SUBSAMPLING or
                planar == 2 and (hs, vs) != (1, 1))):
            # libtiff's RGBA reader has no routine for these (the stream
            # of an old JPEG sets its own)
            raise OSError(f"{path}: YCbCr subsampling {hs}x{vs}, planar "
                          f"{planar}: decoder error")
        if comp == 1 and planar == 1:
            return 'RGB', _ycbcr_raw_chunks(data, W, H, tw, th, offsets,
                                            path), None
        tables = _ycbcr_tables(tags.get(529, _LUMA),
                               tags.get(532, _YCC_BLACK_WHITE))
        if comp == 6:
            return 'RGB', _ojpeg(data, tags, W, H, th, offsets, counts,
                                 tables, path), None
        if planar == 2:
            hs = vs = 1                 # full-resolution planes
    jpeg_tables = bytes(tags.get(347, ()))
    if jpeg_tables[-2:] == b'\xff\xd9':
        jpeg_tables = jpeg_tables[:-2]      # tables, then each stream
    planes = spp if planar == 2 else 1
    cps = 1 if planar == 2 else spp             # samples in a chunk pixel
    row_bytes = (tw * cps * b + 7) // 8
    across = -(-W // tw)
    per_plane = across * -(-H // th)
    nat = {(16, 1): np.uint16, (16, 2): np.int16, (32, 1): np.uint32,
           (32, 2): np.int32, (32, 3): np.float32, (12, 1): np.uint16}.get(
        (b, sfmt[0]), np.uint8)
    samples = np.zeros((planes, H, W, cps), nat)
    units_layout = ycbcr and not is_jpeg and planar == 1
    for k, off in enumerate(offsets):
        plane, t = divmod(k, per_plane)
        if plane >= planes:
            break
        ty, tx = divmod(t, across)
        y, x = ty * th, tx * tw
        nrows = th if 322 in tags else min(th, H - y)
        expect = row_bytes * nrows
        if units_layout:
            block_row = (hs * vs + 2) * -(-tw // hs)
            expect = block_row * -(-nrows // vs)
        src = data[off:off + counts[k]] if counts else data[off:off + expect]
        if fill == 2:                           # bits of the coded bytes
            src = np.packbits(np.unpackbits(np.frombuffer(src, np.uint8),
                                            bitorder='little')).tobytes()
        h, w = min(nrows, H - y), min(tw, W - x)
        if is_jpeg:
            if jpeg_tables and src[:2] == b'\xff\xd8':
                src = jpeg_tables + src[2:]
            _, v, _ = jpeg.decode(src, path, 'YCbCr' if ycbcr and
                                  planar == 1 else 'samples')
            v = v.reshape(v.shape[0], v.shape[1], -1)
            if v.shape[2] != cps or v.shape[0] < h or v.shape[1] < w:
                raise OSError(f"{path}: JPEG strip or tile of another "
                              "shape than its place")
            samples[plane, y:y + h, x:x + w] = v[:h, :w]
            continue
        if comp in (2, 3, 4, 32771):
            raw = np.frombuffer(ccitt.decode(
                src, comp, tw, nrows, off & 1 if comp == 32771 else
                tags.get(292, (0,))[0]), np.uint8)
        elif comp == 32809:
            raw = np.frombuffer(_thunderscan(src, tw, nrows), np.uint8)
        else:
            raw = np.frombuffer(_decompress(comp, src, expect, path)[:expect],
                                np.uint8)
        if raw.size < expect:
            raise OSError(f"{path}: truncated TIFF strip or tile")
        if units_layout:
            if pred == 2 and hs * vs > 1:
                raw = _ycbcr_unpredict(raw, 3 * tw if 322 in tags else
                                       block_row // vs)
            else:
                raw = _unpredict(raw.reshape(-(-nrows // vs), -1), pred, 3,
                                 8, bo)
            v = _ycbcr_to_rgb(raw.reshape(-(-nrows // vs), -(-tw // hs),
                                          hs * vs + 2), hs, vs, tables)
            samples[0, y:y + h, x:x + w] = v[:h, :w]
            continue
        raw = raw.reshape(nrows, row_bytes)
        if b == 12:
            v = _unpack12(raw, nrows, tw * cps)
        elif b < 8:
            v = np.unpackbits(raw, axis=1)
            if b > 1:
                v = v[:, :v.shape[1] // b * b].reshape(nrows, -1, b)
                v = (v * (1 << np.arange(b - 1, -1, -1))).sum(-1)
            v = v[:, :tw * cps].astype(np.uint8)
        else:
            v = _unpredict(raw, pred, cps, b, bo)
        v = v.reshape(nrows, -1)[:, :tw * cps].reshape(nrows, tw, cps)
        samples[plane, y:y + h, x:x + w] = v[:h, :w].view(nat) \
            if v.dtype.itemsize == np.dtype(nat).itemsize else v[:h, :w]
    s = samples[..., 0].transpose(1, 2, 0) if planar == 2 else samples[0]
    if comp != 1 and bo == '>' and b == 32:
        # libtiff hands PIL native-order words, which PIL's big-endian
        # 32-bit unpackers then swap
        s = s.byteswap()
    if ycbcr and planar == 2 and comp != 1:
        return 'RGB', _ycbcr_to_rgb(s[..., :3], 1, 1, _ycbcr_tables(
            tags.get(529, _LUMA), tags.get(532, _YCC_BLACK_WHITE))), None
    if ycbcr:
        # uncompressed planes are read as they are, as PIL's own reader
        # reads them
        return 'RGB', np.ascontiguousarray(s[..., :3]), None
    return _to_mode(mode, s, photo, b, extra, tags, bo)


def _ojpeg_stream(data, tags, W, H, rps, offsets, counts, path) -> bytes:
    """The JPEG stream libtiff's OJPEG codec builds for strips without an
    interchange format: a baseline frame of three components, each with
    its quantisation table (``JPEGQTables``, 64 bytes in zig-zag order)
    and its DC and AC Huffman tables (``JPEGDCTables``, ``JPEGACTables``:
    16 counts, then the symbols), luma sampled as ``YCbCrSubsampling``
    says; the strips' entropy-coded data one after the other, a restart
    marker between two, every ``JPEGRestartInterval`` MCUs (by default
    the MCUs of a strip)."""
    if tags.get(512, (1,))[0] != 1:
        raise OSError(f"{path}: old-style JPEG process "
                      f"{tags[512][0]} (libtiff reads baseline only)")
    hs, vs = tags.get(530, (2, 2))[:2]
    try:
        qs = [data[o:o + 64] for o in tags[519]]
        hts = []
        for tag in (520, 521):
            hts.append([])
            for o in tags[tag]:
                n = sum(data[o:o + 16])
                hts[-1].append(data[o:o + 16 + n])
    except KeyError as e:
        raise OSError(f"{path}: old-style JPEG without tag {e}") from e
    if min(len(qs), len(hts[0]), len(hts[1])) < 3 or \
            any(len(q) < 64 for q in qs):
        raise OSError(f"{path}: old-style JPEG tables missing")

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack('>H', len(body) + 2) + body
    out = bytearray(b'\xff\xd8')
    for k in range(3):
        out += seg(0xDB, bytes([k]) + qs[k])
        out += seg(0xC4, bytes([k]) + hts[0][k])
        out += seg(0xC4, bytes([0x10 | k]) + hts[1][k])
    mcus_across = -(-W // (8 * hs))
    interval = tags.get(515, (rps // (8 * vs) * mcus_across,))[0]
    if len(offsets) > 1:
        out += seg(0xDD, struct.pack('>H', interval))
    out += seg(0xC0, struct.pack('>BHHB', 8, H, W, 3) + bytes(
        [1, (hs << 4) | vs, 0, 2, 0x11, 1, 3, 0x11, 2]))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x22, 0, 63, 0]))
    for k, off in enumerate(offsets):
        if k:
            out += bytes([0xFF, 0xD0 + (k - 1) % 8])
        out += data[off:off + counts[k]] if counts else data[off:]
    return bytes(out + b'\xff\xd9')


def _ojpeg(data, tags, W, H, rps, offsets, counts, tables, path):
    """An old-style JPEG (compression 6) TIFF as libtiff's OJPEG codec
    and RGBA reader give it: the whole image from the JPEG stream that
    ``JPEGInterchangeFormat`` points at, or a stream built from the
    ``JPEGProc`` tables and the strips (each strip a restart interval),
    converted through libtiff's YCbCr tables."""
    if 513 in tags:
        off = tags[513][0]
        n = tags.get(514, (len(data) - off,))[0]
        stream = data[off:off + n]
    elif 519 not in tags and data[offsets[0]:offsets[0] + 2] == b'\xff\xd8':
        # no tables: the strips hold the stream, markers and all
        stream = b''.join(data[o:o + c] for o, c in zip(
            offsets, counts or [len(data)] * len(offsets)))
    else:
        stream = _ojpeg_stream(data, tags, W, H, rps, offsets, counts, path)
    units, hs, vs = _ojpeg_units(stream, W, H, path)
    return _ycbcr_to_rgb(units, hs, vs, tables)[:H, :W]


def _to_mode(mode, s, photo, b, extra, tags, bo):
    """The decoded samples (H, W, spp) as PIL's unpacker leaves them in
    ``mode``."""
    if mode in ('1', 'L'):
        v = s[..., 0].astype(np.int64) * (255 // ((1 << b) - 1))
        if photo == 0:
            v = 255 - v
        return mode, v.astype(np.uint8), None
    if mode in ('I;16', 'I;16B'):
        return mode, s[..., 0].astype(np.uint16), None
    if mode == 'I':
        return 'I', s[..., 0].astype(np.int32), None
    if mode == 'F':
        return 'F', s[..., 0].astype(np.float32), None
    if mode == 'LAB':
        # PIL's LAB unpacker: a* and b* from signed to offset bytes
        return 'LAB', np.ascontiguousarray(
            s[..., :3].astype(np.uint8) ^ np.uint8([0, 128, 128])), None
    if mode in ('P', 'PA'):
        cmap = np.asarray(tags[320], np.int64).reshape(3, -1).T // 256
        return mode, s[..., 0].astype(np.uint8), cmap.astype(np.uint8)
    if b == 16:
        s = (s >> 8).astype(np.uint8)
    s = s.astype(np.uint8)
    if mode == 'LA':
        return 'LA', s[..., :2], None
    if mode == 'CMYK':
        return 'CMYK', np.ascontiguousarray(s[..., :4]), None
    rgb = s[..., :3]
    if extra and extra[0] == 1:                  # associated alpha
        a = s[..., 3:4].astype(np.int64)
        un = np.minimum(rgb.astype(np.int64) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un))
    return 'RGB', np.ascontiguousarray(rgb.astype(np.uint8)), None
