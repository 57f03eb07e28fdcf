"""Writers of the raster formats PIL reads and (mostly) cannot write, for
the fixtures and tests of ``utils/sun.py``, ``msp.py``, ``fli.py``,
``fits.py``, ``ftex.py``, ``gbr.py``, ``mcidas.py``, ``pixar.py``,
``xpm.py``, ``xvthumb.py``, ``pcd.py``, ``dcx.py``, ``im.py``, ``imt.py``,
``iptc.py`` and ``blp.py``, and of the six formats PIL opens and cannot
load (``stub_file``). Each returns the file's bytes. ``large_raster``
writes the seeded files at a texture's size (an RLE Sun raster and an
FLC whose first frame is BRUN, LC and SS2 chunks) that ``bitmap_stages
.large_file`` names.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

from .bitmap_stages import picture


# --- Sun raster --------------------------------------------------------------

def sun_rle(data: bytes, longest: int = 256) -> bytes:
    """Sun RLE of a byte stream: runs of 3 or more (up to ``longest``) as
    ``0x80 n-1 v``, a lone 0x80 as ``0x80 0``, other bytes as they are.
    Runs cross the rows, as the stream does."""
    v = np.frombuffer(data, np.uint8)
    if not len(v):
        return b''
    starts = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
    lens = np.diff(np.r_[starts, len(v)])
    parts = -(-lens // longest)                 # runs cut at `longest`
    val = np.repeat(v[starts], parts)
    run = np.full(len(val), longest)
    run[np.cumsum(parts) - 1] = lens - (parts - 1) * longest
    coded = (run >= 3) | ((val == 0x80) & (run == 2))
    lone = (val == 0x80) & (run == 1)
    size = np.where(coded, 3, np.where(lone, 2, run))
    at = np.r_[0, np.cumsum(size)[:-1]]
    out = np.zeros(int(size.sum()), np.uint8)
    out[at] = np.where(coded | lone, 0x80, val)
    out[at[coded] + 1] = run[coded] - 1
    out[at[coded] + 2] = val[coded]
    two = ~coded & ~lone & (run == 2)
    out[at[two] + 1] = val[two]
    return out.tobytes()


def sun_file(px: np.ndarray, depth: int, ftype: int = 1,
             colours: np.ndarray = None, rle_data: bytes = None) -> bytes:
    """A Sun raster file of ``px``: (H, W) 0/1 (depth 1), indices (4, 8),
    (H, W, 3) RGB (24) or (H, W, 4) RGBX (32), stored as BGR/XBGR unless
    ``ftype`` is 3; rows padded to 16 bits, or (``ftype`` 2) unpadded and
    RLE-coded (``rle_data`` given: those bytes instead); ``colours`` an
    (N, 3) RGB colour map, written as three planes."""
    h, w = px.shape[:2]
    if depth in (1, 4):
        v = (1 - px) if depth == 1 else px
        per = 8 // depth
        pad = -w % per
        v = np.pad(v.astype(np.uint8), ((0, 0), (0, pad))).reshape(
            h, -1, per)
        rows = (v << (8 - depth - depth * np.arange(per))).sum(
            -1).astype(np.uint8)
    elif depth == 8:
        rows = px.astype(np.uint8)
    else:
        c = px.astype(np.uint8)
        if ftype != 3:
            c = np.concatenate([c[..., 2::-1], c[..., 3:]], -1)
        if depth == 32:
            c = np.concatenate([c[..., 3:], c[..., :3]], -1)
        rows = c.reshape(h, -1)
    if ftype == 2:
        data = rle_data if rle_data is not None else sun_rle(rows.tobytes())
    else:
        stride = ((w * depth + 15) // 16) * 2
        data = np.pad(rows, ((0, 0), (0, stride - rows.shape[1]))).tobytes()
    cmap = b'' if colours is None else \
        np.asarray(colours, np.uint8).T.tobytes()
    return struct.pack('>8I', 0x59A66A95, w, h, depth, len(data), ftype,
                       1 if len(cmap) else 0, len(cmap)) + cmap + data


# --- MSP ---------------------------------------------------------------------

def msp_rows(bits: np.ndarray) -> list:
    """MSP version 2 rows of (H, W) 0/1 pixels (1 white): runs of 3 or
    more equal bytes as ``0 n v``, other bytes in copies of up to 255; an
    all-white row as an empty row (its map entry 0)."""
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    out = []
    for row in rows:
        if (row == 0xFF).all():
            out.append(b'')
            continue
        coded, i, n = bytearray(), 0, len(row)
        while i < n:
            run = 1
            while i + run < n and run < 255 and row[i + run] == row[i]:
                run += 1
            if run >= 3:
                coded += bytes([0, run, row[i]])
                i += run
                continue
            j = i + 1
            while j < n and j - i < 255 and not (
                    j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            coded += bytes([j - i]) + row[i:j].tobytes()
            i = j
        out.append(bytes(coded))
    return out


def msp_file(bits: np.ndarray, rows: list = None) -> bytes:
    """An MSP version 2 (``LinS``) file of (H, W) 0/1 pixels, its rows
    coded by ``msp_rows`` (``rows``: coded rows given instead), the
    header's checksum word making its words XOR to 0."""
    h, w = bits.shape
    rows = msp_rows(bits) if rows is None else rows
    words = [*struct.unpack('<2H', b'LinS'), w, h, 1, 1, 1, 1, w, h, 0, 0,
             0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return struct.pack('<16H', *words) + struct.pack(
        f'<{h}H', *[len(r) for r in rows]) + b''.join(rows)


# --- FLI / FLC ---------------------------------------------------------------

def fli_chunk(kind: int, body: bytes) -> bytes:
    """A frame's chunk: size, type, body (padded to an even size)."""
    body += b'\0' * (len(body) & 1)
    return struct.pack('<IH', 6 + len(body), kind) + body


def fli_colour(palette: np.ndarray, shift: int = 0, skip: int = 0) -> bytes:
    """A COLOR_256 (``shift`` 0) or COLOR_64 (2) chunk setting
    ``palette`` (N, 3) after ``skip`` entries, in one packet."""
    pal = np.asarray(palette, np.int64) >> shift
    n = len(pal)
    return fli_chunk(11 if shift else 4, struct.pack(
        '<HBB', 1, skip, n & 0xFF) + pal.astype(np.uint8).tobytes())


def fli_brun(img: np.ndarray, copies: bool = True) -> bytes:
    """A BRUN chunk of (H, W) indices: each row's runs of up to 127 as
    ``n v`` and (``copies``) the other bytes in copies of up to 128
    (``-n`` then the bytes); without ``copies``, every byte in a run (the
    rows coded at once, for the files at a texture's size)."""
    img = np.ascontiguousarray(img, np.uint8)
    if not copies:
        h, w = img.shape
        flat = img.reshape(-1)
        cut = np.zeros(flat.size, bool)
        cut[::w] = True
        cut[1:] |= flat[1:] != flat[:-1]
        starts = np.flatnonzero(cut)
        lens = np.diff(np.r_[starts, flat.size])
        parts = -(-lens // 127)
        val = np.repeat(flat[starts], parts)
        run = np.full(len(val), 127)
        run[np.cumsum(parts) - 1] = lens - (parts - 1) * 127
        row = np.repeat(starts // w, parts)
        per_row = np.bincount(row, minlength=h)
        out = np.zeros(h + 2 * len(val), np.uint8)
        pos = np.arange(len(val)) * 2 + row + 1      # after each row's byte
        out[pos] = run
        out[pos + 1] = val
        return fli_chunk(15, out.tobytes())
    out = bytearray()
    for row in img:
        out.append(0)
        i, n = 0, len(row)
        while i < n:
            run = 1
            while i + run < n and run < 127 and row[i + run] == row[i]:
                run += 1
            if run >= 2:
                out += bytes([run, row[i]])
                i += run
                continue
            j = i + 1
            while j < n and j - i < 128 and not (
                    j + 1 < n and row[j] == row[j + 1]):
                j += 1
            out += bytes([256 - (j - i)]) + row[i:j].tobytes()
            i = j
    return fli_chunk(15, bytes(out))


def fli_lc(prev: np.ndarray, img: np.ndarray) -> bytes:
    """An LC (byte delta) chunk turning ``prev`` into ``img``: the rows
    from the first to the last that change, each as packets of a skip
    and a run (``-n v``) or copy (``n`` bytes)."""
    prev, img = prev.astype(np.uint8), img.astype(np.uint8)
    changed = np.flatnonzero((prev != img).any(1))
    first = int(changed[0]) if len(changed) else 0
    last = int(changed[-1]) + 1 if len(changed) else 0
    out = bytearray(struct.pack('<HH', first, last - first))
    for y in range(first, last):
        packets, x, w = bytearray(), 0, img.shape[1]
        count = 0
        while True:
            diff = np.flatnonzero(prev[y, x:] != img[y, x:])
            if not len(diff):
                break
            skip = int(diff[0])
            while skip > 255:
                packets += bytes([255, 0])
                count += 1
                skip -= 255
            x += skip
            end = x
            while end < w and end - x < 127 and prev[y, end] != img[y, end]:
                end += 1
            seg = img[y, x:end]
            if len(seg) >= 3 and (seg == seg[0]).all():
                packets += bytes([skip, 256 - len(seg), seg[0]])
            else:
                packets += bytes([skip, len(seg)]) + seg.tobytes()
            count += 1
            x = end
        out += bytes([count]) + packets
    return fli_chunk(12, bytes(out))


def fli_ss2(prev: np.ndarray, img: np.ndarray) -> bytes:
    """An SS2 (word delta) chunk turning ``prev`` into ``img`` (an even
    width, or the last byte by its flag word): unchanged rows skipped by
    a skip word, each changed row as packets of a byte skip and a word
    run (``-n`` words) or copy (``n`` words)."""
    prev, img = prev.astype(np.uint8), img.astype(np.uint8)
    h, w = img.shape
    ww = w - (w & 1)
    out, lines, skip = bytearray(), 0, 0
    for y in range(h):
        if (prev[y] == img[y]).all():
            skip += 1
            continue
        row = bytearray()
        if skip:
            row += struct.pack('<H', 65536 - skip)
            skip = 0
        if w & 1:
            row += struct.pack('<H', 0x8000 | int(img[y, w - 1]))
        pw, iw = prev[y, :ww].view('<u2'), img[y, :ww].view('<u2')
        packets, count, x = bytearray(), 0, 0
        while True:
            diff = np.flatnonzero(pw[x:] != iw[x:])
            if not len(diff):
                break
            sk = int(diff[0])
            while sk > 127:
                packets += bytes([254, 0])
                count += 1
                sk -= 127
            x += sk
            end = x
            while end < len(iw) and end - x < 127 and pw[end] != iw[end]:
                end += 1
            seg = iw[x:end]
            if len(seg) >= 2 and (seg == seg[0]).all():
                packets += bytes([2 * sk, 256 - len(seg)]) + \
                    seg[:1].tobytes()
            else:
                packets += bytes([2 * sk, len(seg)]) + seg.tobytes()
            count += 1
            x = end
        row += struct.pack('<H', count) + packets
        out += row
        lines += 1
    return fli_chunk(7, struct.pack('<H', lines) + bytes(out))


def fli_frame(chunks, kind: int = 0xF1FA) -> bytes:
    """A frame (or, ``kind`` 0xF100, a prefix chunk) of ``chunks``."""
    body = b''.join(chunks)
    return struct.pack('<IHH8x', 16 + len(body), kind, len(chunks)) + body


def fli_file(w: int, h: int, frames, magic: int = 0xAF12) -> bytes:
    """An FLI (``magic`` 0xAF11) or FLC (0xAF12) file of ``frames``."""
    body = b''.join(frames)
    head = bytearray(128)
    struct.pack_into('<IHHHHHHI', head, 0, 128 + len(body), magic,
                     len(frames), w, h, 8, 3, 5)
    return bytes(head) + body


# --- FITS --------------------------------------------------------------------

def _cards(cards) -> bytes:
    out = b''.join(c.encode().ljust(80) for c in cards)
    return out + b' ' * (-len(out) % 2880)


def fits_file(px: np.ndarray, bitpix: int, gzip_tile: bool = False,
              extra=()) -> bytes:
    """A FITS file of (H, W) samples, BITPIX ``bitpix``, rows bottom-up:
    the primary image, or (``gzip_tile``) an empty primary header and a
    binary table holding the image as one ``GZIP_1`` tile of 4-byte
    words. ``extra``: more header cards."""
    h, w = px.shape
    dt = {8: '>u1', 16: '>i2', 32: '>i4', -32: '>f4', -64: '>f8'}[bitpix]
    if not gzip_tile:
        head = _cards(['SIMPLE  =                    T',
                       f'BITPIX  = {bitpix:20d}',
                       'NAXIS   =                    2',
                       f'NAXIS1  = {w:20d}', f'NAXIS2  = {h:20d}', *extra,
                       'END'])
        data = px[::-1].astype(dt).tobytes()
        return head + data + b'\0' * (-len(data) % 2880)
    words = px[::-1].astype('>i4').tobytes()
    body = gzip.compress(words, mtime=0)
    head = _cards(['SIMPLE  =                    T',
                   'BITPIX  =                    8',
                   'NAXIS   =                    0',
                   'EXTEND  =                    T',
                   'END'])
    ext = _cards(["XTENSION= 'BINTABLE'", 'BITPIX  =                    8',
                  'NAXIS   =                    2',
                  f'NAXIS1  = {8:20d}', 'NAXIS2  =                    1',
                  'ZIMAGE  =                    T',
                  "ZCMPTYPE= 'GZIP_1  '", f'ZBITPIX = {bitpix:20d}',
                  'ZNAXIS  =                    2', f'ZNAXIS1 = {w:20d}',
                  f'ZNAXIS2 = {h:20d}', *extra, 'END'])
    table = struct.pack('>2i', len(body), 8)
    return head + ext + table + body


# --- the other small formats -------------------------------------------------

def ftex_file(w: int, h: int, fmt: int, data: bytes, formats: int = 1,
              mipmaps: int = 1) -> bytes:
    """An FTEX file of one format (0 DXT1, 1 RGB) whose first mipmap is
    ``data``."""
    return b'FTEX' + struct.pack('<6i', 1, w, h, mipmaps, formats, fmt) + \
        struct.pack('<i', 32) + struct.pack('<i', len(data)) + data


def gbr_file(px: np.ndarray, version: int = 2,
             comment: bytes = b'brush') -> bytes:
    """A GIMP brush of (H, W) grey or (H, W, 4) RGBA pixels."""
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    name = comment + b'\0'
    head = 20 if version == 1 else 28
    out = struct.pack('>5I', head + len(name), version, w, h, depth)
    if version == 2:
        out += b'GIMP' + struct.pack('>I', 25)
    return out + name + px.astype(np.uint8).tobytes()


def mcidas_file(px: np.ndarray, bpp: int, prefix: int = 0,
                bands: int = 1) -> bytes:
    """A McIDAS area file of (H, W) samples of ``bpp`` bytes (big-endian),
    each row after ``prefix`` bytes, ``bands`` rows' width of data a row
    (the first band's read)."""
    h, w = px.shape
    d = [0] * 65
    d[2], d[9], d[10], d[11], d[14], d[15], d[34] = 4, h, w, bpp, bands, \
        prefix, 256
    dt = {1: '>u1', 2: '>u2', 4: '>i4'}[bpp]
    rows = np.zeros((h, prefix + w * bpp * bands), np.uint8)
    rows[:, prefix:prefix + w * bpp] = px.astype(dt).view(np.uint8).reshape(
        h, -1)
    return struct.pack('>64i', *d[1:]) + rows.tobytes()


def pixar_file(rgb: np.ndarray, layout=(14, 2)) -> bytes:
    """A PIXAR raster of (H, W, 3) RGB."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b'\x80\xe8\0\0'
    struct.pack_into('<2H', head, 416, h, w)
    struct.pack_into('<2H', head, 424, *layout)
    return bytes(head) + rgb.astype(np.uint8).tobytes()


def xpm_file(idx: np.ndarray, colours, keys=None, pixels_comment=True,
             none_key: bytes = None) -> bytes:
    """An XPM file of (H, W) indices into ``colours`` (N ``#rrggbb``
    strings or bytes), one key of ``cpp`` characters a colour (``keys``
    given, or made); ``none_key``: one more key, transparent."""
    h, w = idx.shape
    n = len(colours)
    alphabet = (b'.#abcdefghijklmnopqrstuvwxyz'
                b'ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789')
    k = len(alphabet)
    if keys is None:
        keys = [bytes([alphabet[i % k]]) if n <= k else
                bytes([alphabet[i // k], alphabet[i % k]]) for i in range(n)]
    cpp = len(keys[0])
    lines = [b'/* XPM */', b'static char *img[] = {',
             b'"%d %d %d %d",' % (w, h, n + (none_key is not None), cpp)]
    for k, c in zip(keys, colours):
        c = c.encode() if isinstance(c, str) else c
        lines.append(b'"' + k + b' c ' + c + b'",')
    if none_key is not None:
        lines.append(b'"' + none_key + b' c None",')
    if pixels_comment:
        lines.append(b'/* pixels */')
    for r in range(h):
        lines.append(b'"' + b''.join(keys[i] for i in idx[r]) + b'"' +
                     (b',' if r < h - 1 else b''))
    lines.append(b'};')
    return b'\n'.join(lines) + b'\n'


def xvthumb_file(idx: np.ndarray, comments=(b'#XVVERSION:Version 2.28',
                                            b'#END_OF_COMMENTS')) -> bytes:
    """An XV thumbnail of (H, W) 3-3-2 indices."""
    h, w = idx.shape
    return b'P7 332\n' + b''.join(c + b'\n' for c in comments) + \
        b'%d %d 255\n' % (w, h) + idx.astype(np.uint8).tobytes()


def pcd_file(chunks: np.ndarray, orientation: int = 0) -> bytes:
    """A Photo CD file of the base image's (256, 2304) chunks (two rows of
    768 luma samples, then 384 Cb and 384 Cr samples each)."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b'PCD_'
    head[2048 + 1538] = orientation
    return bytes(head) + np.asarray(chunks, np.uint8).tobytes()


def dcx_file(pages) -> bytes:
    """A DCX file of PCX files (bytes), its offsets table ended by 0."""
    offsets, pos = [], 4 + 4 * (len(pages) + 1)
    for p in pages:
        offsets.append(pos)
        pos += len(p)
    return struct.pack(f'<I{len(pages) + 1}I', 0x3ADE68B1, *offsets, 0) + \
        b''.join(pages)


def im_file(kind: str, w: int, h: int, body: bytes, lut: bytes = None,
            extra=(), end: bytes = b'\x1a') -> bytes:
    """A LabEye IM file: its header (``Image type: <kind> image``, the
    size, ``extra`` lines, a ``Lut`` line where ``lut`` is given), the
    header's end byte, the LUT and ``body``."""
    lines = [b'Image type: ' + kind.encode() + b' image',
             b'Image size (x*y): %d*%d' % (w, h), *extra]
    if lut is not None:
        lines.append(b'Lut: 1')
    return b''.join(line + b'\r\n' for line in lines) + end + \
        (lut or b'') + body


def imt_file(px: np.ndarray, comment: bytes = b'* made by numpy') -> bytes:
    """An IM Tools file of (H, W) grey pixels."""
    h, w = px.shape
    return comment + b'\nwidth %d\nheight %d\npixel n8\n\x0c' % (w, h) + \
        px.astype(np.uint8).tobytes()


def _iptc(tag, data: bytes) -> bytes:
    if len(data) < 0x8000:
        return bytes([0x1C, *tag]) + struct.pack('>H', len(data)) + data
    return bytes([0x1C, *tag, 0x84]) + struct.pack('>I', len(data)) + data


def iptc_file(body: bytes, w: int, h: int, layers: int = 1,
              component: int = 0, band: int = None, compression: int = 1,
              parts: int = 2) -> bytes:
    """An IPTC/NAA file: its records (an envelope record, the image's
    layers and component, size, compression and band), then ``body`` in
    ``parts`` 8:10 records."""
    out = _iptc((1, 90), b'\x1b%G') + _iptc((2, 0), b'\0\4')
    out += _iptc((3, 60), bytes([layers, component]))
    out += _iptc((3, 20), struct.pack('>H', w))
    out += _iptc((3, 30), struct.pack('>H', h))
    out += _iptc((3, 120), bytes([compression]))
    if band is not None:
        out += _iptc((3, 65), bytes([band]))
    step = -(-len(body) // parts) if body else 1
    for k in range(0, max(len(body), 1), step):
        out += _iptc((8, 10), body[k:k + step])
    return out


def blp_file(version: int, w: int, h: int, mip: bytes, *, compression=1,
             encoding=1, alpha=0, alpha_encoding=0, palette: bytes = None,
             jpeg_header: bytes = b'') -> bytes:
    """A BLP1 or BLP2 file whose first mipmap is ``mip``: a palette of
    256 BGRA entries (zeros where not given) and indices, DXT blocks
    (BLP2 ``encoding`` 2 and ``alpha_encoding`` 0, 1, 7), or (BLP1,
    ``compression`` 0) the JPEG stream's tail after ``jpeg_header``."""
    if version == 1:
        head = b'BLP1' + struct.pack('<iIIIii', compression, alpha, w, h,
                                     encoding, 0)
    else:
        head = b'BLP2' + struct.pack('<ibbbbII', compression, encoding,
                                     alpha, alpha_encoding, 0, w, h)
    pos = len(head) + 128
    if version == 1 and compression == 0:
        pre = struct.pack('<I', len(jpeg_header)) + jpeg_header
    else:
        pre = (palette or bytes(1024)).ljust(1024, b'\0')
    offsets = [pos + len(pre)] + [0] * 15
    lengths = [len(mip)] + [0] * 15
    return head + struct.pack('<16I', *offsets) + \
        struct.pack('<16I', *lengths) + pre + mip


def stub_file(fmt: str) -> bytes:
    """A small file of each format PIL opens and cannot load: BUFR, GRIB,
    HDF5, MPEG (a sequence header of a 64x48 picture), EPS (with its
    bounding box) and WMF (a placeable metafile)."""
    if fmt == 'BUFR':
        return b'BUFR' + bytes(60)
    if fmt == 'GRIB':
        return b'GRIB\0\0\0\1' + bytes(60)
    if fmt == 'HDF5':
        return b'\x89HDF\r\n\x1a\n' + bytes(60)
    if fmt == 'MPEG':
        return b'\0\0\1\xb3' + bytes([64 >> 4, ((64 & 15) << 4) | 0,
                                       48]) + bytes(60)
    if fmt == 'EPS':
        return (b'%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 16 16\n'
                b'%%EndComments\nnewpath 0 0 moveto 16 16 lineto stroke\n'
                b'showpage\n%%EOF\n')
    if fmt == 'WMF':
        head = bytearray(22)
        head[:6] = b'\xd7\xcd\xc6\x9a\0\0'
        struct.pack_into('<4hH', head, 6, 0, 0, 160, 120, 1440)
        return bytes(head) + b'\x01\x00\t\x00' + bytes(40)
    raise ValueError(fmt)


# --- the files at a texture's size -------------------------------------------

def large_raster(kind: str, side: int, seed: int) -> bytes:
    """A seeded file at a texture's size: ``sun_rle`` an 8-bit RLE Sun
    raster of the picture's green channel posterised to steps of 8;
    ``flc`` an FLC whose first frame is a COLOR_256 chunk of a seeded
    palette, a BRUN chunk of that picture as indices, an LC chunk and an
    SS2 chunk (each over a band of changed rows); ``pcd`` a Photo CD file
    of seeded random samples (768x512, turned a quarter: ``side`` is not
    used)."""
    if kind == 'pcd':
        chunks = np.random.default_rng(seed).integers(0, 256, (256, 2304))
        return pcd_file(chunks, orientation=1)
    img = picture(side, seed, 0.0)[..., 1] // 8 * 8
    if kind == 'sun_rle':
        return sun_file(img, 8, 2)
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (256, 3))
    band = img.copy()
    band[side // 4:side // 2, side // 8:side // 2] //= 2
    wide = band.copy()
    wide[side // 2:3 * side // 4] = 255 - wide[side // 2:3 * side // 4]
    frame = fli_frame([fli_colour(pal), fli_brun(img, copies=False),
                       fli_lc(img, band), fli_ss2(band, wide)])
    return fli_file(side, side, [frame])
