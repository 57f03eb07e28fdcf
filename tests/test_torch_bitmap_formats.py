"""The port's bitmap decoders (BMP, TGA, PNM/PFM, GIF, TIFF) and its
PIL-order format identification against the reference's ``load_bitmap``,
which opens every non-EXR file with PIL's ``Image.open(path)
.convert('RGB')``.

PIL writes each layout it can write at 37 x 23 (partial rows, strips and
tiles); the layouts it cannot write (RLE8/RLE4 BMP with delta and
end-of-line codes, the core and V4 headers, 16-bit 555/565 and 32-bit
bitfield BMP, colour-mapped TGA with a first index and 16-bit entries, RLE
packets across rows, plain PNM with comments and odd maxvals, PFM, a GIF
whose LZW table fills to 4,096 entries, local tables and frame offsets,
TIFF in big-endian order, tiles, planar configuration 2, associated alpha,
fill order 2, BigTIFF and 2/4-bit grey and palettes) are written here with
numpy; JPEG-in-TIFF in strips and tiles and YCbCr TIFF at each
subsampling through the libtiff PIL bundles (``libtiff_write`` of
``scripts/port_make_bitmaps.py``). Every file: the port's ``load_bitmap``
equals the reference's byte for byte with ``gamma`` True and False, and
``identify`` names the format PIL opens it as. Files PIL refuses raise ``OSError`` (or PIL's own error)
in both; a format PIL opens that the port does not read raises
``NotImplementedError`` naming ROADMAP 12.7. The layouts and formats of
slice 17 (the TIFF remainder, DDS, QOI, SGI, PCX) have files of their own:
``test_torch_tiff_rest.py``, ``test_torch_dds.py`` and
``test_torch_qoi_sgi_pcx.py``."""
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba_nlvrl_tpu import texture as jtex
from mitsuba_nlvrl_tpu_torch import texture as ptex

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts'))
from port_make_bitmaps import libtiff_write  # noqa: E402

torch.set_num_threads(1)   # one intra-op thread a test worker

H, W = 23, 37
_rng = np.random.default_rng(7)
RGB = _rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
RGBA = _rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
RGBA[0, :4, 3] = (0, 255, 1, 128)          # the unpremultiply edges
GREY = _rng.integers(0, 256, (H, W), dtype=np.uint8)


def _pil(mode):
    """A 37 x 23 PIL image in ``mode``."""
    if mode in ('RGB', 'RGBA', 'CMYK'):
        return Image.fromarray(RGBA if mode != 'RGB' else RGB, mode)
    if mode == 'L':
        return Image.fromarray(GREY, 'L')
    if mode == 'LA':
        return Image.fromarray(RGBA[..., :2], 'LA')
    if mode == '1':
        return Image.fromarray(GREY > 127).convert('1')
    if mode == 'PA':
        return Image.fromarray(RGB).quantize(100).convert('PA')
    if mode.startswith('P'):       # P, P16, P2: quantized to so many colours
        n = int(mode[1:] or 200)
        return Image.fromarray(RGB).quantize(n)
    if mode == 'I;16':
        return Image.frombytes('I;16', (W, H), _rng.integers(
            0, 65536, (H, W)).astype('<u2').tobytes())
    if mode == 'I':
        return Image.fromarray(_rng.integers(-500, 70000, (H, W)).astype(
            np.int32))
    if mode == 'F':
        return Image.fromarray(_rng.uniform(-20, 300, (H, W)).astype(
            np.float32))
    raise ValueError(mode)


# --- numpy writers for the layouts PIL does not write -----------------------

def _bmp(path, rows, bits, header=40, comp=0, palette=None, masks=None,
         top_down=False, colors=0, width=W, height=H):
    """A BMP: ``rows`` is the pixel data (already coded for RLE), in file
    order; ``palette`` (N, 3) RGB."""
    pal = b''
    if palette is not None:
        pad = 3 if header == 12 else 4
        pal = b''.join(bytes([b, g, r] + [0] * (pad - 3))
                       for r, g, b in np.asarray(palette, int))
    if header == 12:
        info = struct.pack('<IHHHH', 12, width, height, 1, bits)
    else:
        h = (2 ** 32 - height) if top_down else height
        info = struct.pack('<IIIHHIIIIII', header, width, h, 1, bits, comp,
                           len(rows), 2835, 2835, colors, 0)
        fields = b''
        if masks is not None:
            fields = struct.pack('<4I', *masks)
        if header == 40:
            info += fields[:12]
        else:
            info += (fields + bytes(16))[:16]
            info += bytes(header - 56)
    off = 14 + len(info) + len(pal)
    with open(path, 'wb') as f:
        f.write(b'BM' + struct.pack('<IHHI', off + len(rows), 0, 0, off))
        f.write(info + pal + rows)


def _bmp_rows(px, bits, width=W):
    """Packed, 4-byte padded rows, bottom row first."""
    stride = ((width * bits + 31) >> 3) & ~3
    out = b''
    for row in px[::-1]:
        if bits < 8:
            v = np.asarray(row, np.uint8)
            b = np.unpackbits(v[:, None], axis=1)[:, 8 - bits:].reshape(-1)
            r = np.packbits(b).tobytes()
        elif bits == 8:
            r = np.asarray(row, np.uint8).tobytes()
        elif bits == 16:
            r = np.asarray(row, '<u2').tobytes()
        elif bits == 24:
            r = np.asarray(row, np.uint8)[:, ::-1].tobytes()
        else:
            r = np.asarray(row, '<u4').tobytes()
        out += r.ljust(stride, b'\0')
    return out


def _rle_rows(px, rle4):
    """RLE8/RLE4 codes of ``px`` (bottom row first): each row a repeated
    run, an absolute run (odd length, so padded), a delta, the rest as a
    run, then end of line; end of bitmap at the end."""
    out = bytearray()
    for y, row in enumerate(px[::-1]):
        row = [int(v) for v in row]
        x = 0
        out += bytes([4, (row[0] << 4 | row[1]) if rle4 else row[0]])
        x += 4
        n = 7
        out += bytes([0, n])
        chunk = row[x:x + n]
        if rle4:
            chunk = chunk + [0]
            out += bytes((chunk[i] << 4) | chunk[i + 1]
                         for i in range(0, n, 2))
        else:
            out += bytes(chunk)
        if len(out) % 2:
            out += b'\0'
        x += n
        if y == 3:             # PIL reads two bytes past a delta's own
            out += bytes([0, 2, 3, 0, 3, 0])
            x += 3
        left = W - x
        while left > 0:
            k = min(left, 255)
            v = row[x]
            out += bytes([k, (v << 4 | v) if rle4 else v])
            left -= k
            x += k
        out += b'\0\0'
    return bytes(out + b'\0\1')


def _tga(path, itype, depth, px, cmap=None, first=0, cmap_depth=24,
         flags=0x20, rle=False, ident=b'id!', runs_cross_rows=False):
    """A TGA of pixel bytes ``px`` (H, W, bytes) in file row order. RLE:
    literal packets run on across rows; repeat packets do so only with
    ``runs_cross_rows`` (PIL refuses such a file)."""
    Hh, Ww = px.shape[:2]
    head = struct.pack('<BBBHHBHHHHBB', len(ident), cmap is not None,
                       itype | (8 if rle else 0), first,
                       0 if cmap is None else len(cmap) * 8 // cmap_depth,
                       cmap_depth, 0, 0,
                       Ww, Hh, depth, flags)
    body = px.reshape(-1, px.shape[-1])
    if rle:                     # runs and literal packets across rows
        data, i, n = bytearray(), 0, len(body)
        while i < n:
            j = i
            while j + 1 < n and j - i < 127 and (body[j + 1] ==
                                                 body[i]).all() and (
                    runs_cross_rows or (j + 1) % Ww):
                j += 1
            if j > i:
                data += bytes([0x80 | (j - i)]) + body[i].tobytes()
                i = j + 1
            else:
                k = min(n - i, 3 + i % 5)
                data += bytes([k - 1]) + body[i:i + k].tobytes()
                i += k
        pix = bytes(data)
    else:
        pix = body.tobytes()
    with open(path, 'wb') as f:
        f.write(head + ident + (b'' if cmap is None else cmap) + pix)


def _lzw_gif(idx, bits, clear_when_full):
    """GIF LZW codes of ``idx`` (minimum code size ``bits``), packed LSB
    first. With ``clear_when_full`` False the table fills to 4,096
    entries and coding goes on at 12 bits (a deferred clear)."""
    clear, eoi = 1 << bits, (1 << bits) + 1
    size, nxt = bits + 1, eoi + 1
    table = {(i,): i for i in range(clear)}
    codes = [(clear, size)]
    cur = ()
    for v in idx.tolist():
        s = cur + (v,)
        if s in table:
            cur = s
            continue
        codes.append((table[cur], size))
        if nxt < 4096:
            table[s] = nxt
            if nxt == (1 << size) and size < 12:
                size += 1
            nxt += 1
        elif clear_when_full:
            codes.append((clear, size))
            table = {(i,): i for i in range(clear)}
            size, nxt = bits + 1, eoi + 1
        cur = (v,)
    codes.append((table[cur], size))
    codes.append((eoi, size))
    acc = nacc = 0
    out = bytearray()
    for c, n in codes:
        acc |= c << nacc
        nacc += n
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
    if nacc:
        out.append(acc)
    return bytes(out)


def _gif(path, idx, palette, local=False, interlace=False,
         transparency=None, offset=(0, 0), screen=None, bits=8,
         clear_when_full=False, version=b'GIF89a'):
    fh, fw = idx.shape
    sw, sh = screen or (fw + offset[0], fh + offset[1])
    tbits = max(1, int(np.ceil(np.log2(max(len(palette), 2))))) - 1
    table = np.zeros((2 << tbits, 3), np.uint8)
    table[:len(palette)] = palette
    gflags = 0 if local else 0x80 | tbits
    out = version + struct.pack('<HHBBB', sw, sh, gflags, 0, 0)
    if not local:
        out += table.tobytes()
    if transparency is not None:
        out += bytes([0x21, 0xF9, 4, 1, 0, 0, transparency, 0])
    out += bytes([0x21, 0xFE, 3]) + b'abc' + b'\0'          # a comment
    fflags = (0x80 | tbits if local else 0) | (0x40 if interlace else 0)
    out += b',' + struct.pack('<HHHHB', *offset, fw, fh, fflags)
    if local:
        out += table.tobytes()
    rows = idx
    if interlace:
        order = np.concatenate([np.arange(fh)[s::k] for s, k in
                                ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = idx[order]
    data = _lzw_gif(rows.reshape(-1), bits, clear_when_full)
    out += bytes([bits])
    for i in range(0, len(data), 255):
        out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    out += b'\0;'
    with open(path, 'wb') as f:
        f.write(out)


def _packbits(b):
    out, i = bytearray(), 0
    while i < len(b):
        j = i
        while j + 1 < len(b) and b[j + 1] == b[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), b[i]])
            i = j + 1
            continue
        j = i
        while j + 1 < len(b) and j - i < 127 and not (
                j + 2 < len(b) and b[j + 1] == b[j + 2]):
            j += 1
        out += bytes([j - i]) + b[i:j + 1]
        i = j + 1
    return bytes(out)


def _tiff(path, s, photo, bps, bo='<', extra=(), tile=None, planar=1,
          comp=1, pred=1, cmap=None, fill=1, sfmt=1, big=False,
          rows_per_strip=None):
    """A TIFF of samples ``s`` (H, W, spp): strips (or ``tile`` (w, h)
    tiles), compression 1, 8 or 32773, predictor 2 at 8/16 bits, a 16-bit
    colour map (N, 3), fill order 2 (bits of the coded bytes reversed)."""
    Hh, Ww, spp = s.shape
    dt = np.dtype({8: 'u1', 16: 'u2', 32: 'u4'}.get(bps, 'u1'))
    if sfmt == 3:
        dt = np.dtype('f4')
    elif sfmt == 2:
        dt = np.dtype({8: 'i1', 16: 'i2', 32: 'i4'}[bps])
    planes = [s[..., k:k + 1] for k in range(spp)] if planar == 2 else [s]
    tw, th = tile if tile else (Ww, rows_per_strip or Hh)
    chunks = []
    for pl in planes:
        c = pl.shape[-1]
        for y in range(0, Hh, th):
            for x in range(0, Ww, tw):
                blk = pl[y:y + th, x:x + tw]
                if tile:
                    full = np.zeros((th, tw, c), blk.dtype)
                    full[:blk.shape[0], :blk.shape[1]] = blk
                    blk = full
                if bps < 8:
                    v = blk.reshape(blk.shape[0], -1).astype(np.uint8)
                    b = np.unpackbits(v[..., None], axis=-1)[..., 8 - bps:]
                    raw = np.packbits(b.reshape(v.shape[0], -1),
                                      axis=1).tobytes()
                else:
                    v = blk.reshape(blk.shape[0], -1, c).astype(dt)
                    if pred == 2:
                        d = v.copy()
                        d[:, 1:] = v[:, 1:] - v[:, :-1]
                        v = d
                    raw = v.astype(dt.newbyteorder(bo)).tobytes()
                raw = {1: bytes, 8: zlib.compress,
                       32773: _packbits}[comp](raw)
                if fill == 2:
                    r = np.unpackbits(np.frombuffer(raw, np.uint8))
                    raw = np.packbits(r.reshape(-1, 8)[:, ::-1]).tobytes()
                chunks.append(raw)
    tags = {256: (4, [Ww]), 257: (4, [Hh]), 258: (3, [bps] * spp),
            259: (3, [comp]), 262: (3, [photo]), 277: (3, [spp]),
            284: (3, [planar])}
    if extra:
        tags[338] = (3, list(extra))
    if pred != 1:
        tags[317] = (3, [pred])
    if fill != 1:
        tags[266] = (3, [fill])
    if sfmt != 1:
        tags[339] = (3, [sfmt] * spp)
    if cmap is not None:
        tags[320] = (3, list(np.asarray(cmap).T.reshape(-1)))
    if tile:
        tags[322], tags[323] = (3, [tw]), (3, [th])
    else:
        tags[278] = (4, [th])
    base = 16 if big else 8
    body, offs = b'', []
    for c in chunks:
        offs.append(base + len(body))
        body += c + b'\0' * (len(c) % 2)
    lt = 16 if big else 4
    tags[324 if tile else 273] = (lt, offs)
    tags[325 if tile else 279] = (lt, [len(c) for c in chunks])
    ifd_off = base + len(body)
    esize, inl = (20, 8) if big else (12, 4)
    start = ifd_off + (8 if big else 2) + len(tags) * esize + (8 if big
                                                               else 4)
    entries, spill = b'', b''
    for tag in sorted(tags):
        typ, vals = tags[tag]
        payload = struct.pack(bo + f'{len(vals)}' + {3: 'H', 4: 'I',
                                                     16: 'Q'}[typ],
                              *[int(v) for v in vals])
        if len(payload) <= inl:
            field = payload.ljust(inl, b'\0')
        else:
            field = struct.pack(bo + ('Q' if big else 'I'),
                                start + len(spill))
            spill += payload + b'\0' * (len(payload) % 2)
        entries += struct.pack(bo + ('HHQ' if big else 'HHI'), tag, typ,
                               len(vals)) + field
    head = b'II' if bo == '<' else b'MM'
    head += struct.pack(bo + 'HHHQ', 43, 8, 0, ifd_off) if big else \
        struct.pack(bo + 'HI', 42, ifd_off)
    ifd = struct.pack(bo + ('Q' if big else 'H'), len(tags)) + entries + \
        bytes(8 if big else 4)
    with open(path, 'wb') as f:
        f.write(head + body + ifd + spill)


# --- the cases --------------------------------------------------------------

def _save(mode, suffix, **kw):
    def write(path):
        _pil(mode).save(path, **kw)
    return write, suffix


CASES = {}
for _m in ('RGB', 'RGBA', 'L', '1', 'P', 'P16', 'P2'):
    CASES[f'bmp-pil-{_m}'] = _save(_m, 'bmp')
for _m in ('RGB', 'RGBA', 'L', 'LA', '1', 'P'):
    for _c in (None, 'tga_rle')[:1 if _m == '1' else 2]:
        for _o in (1, -1):
            CASES[f'tga-pil-{_m}-{_c}-{_o}'] = _save(
                _m, 'tga', orientation=_o, **({'compression': _c} if _c
                                              else {}))
for _m, _s in (('RGB', 'ppm'), ('L', 'pgm'), ('1', 'pbm')):
    CASES[f'pnm-pil-{_s}'] = _save(_m, _s)
for _m in ('RGB', 'L', 'P', 'P16', 'P2', 'RGBA', 'LA'):
    for _i in (False, True):
        CASES[f'gif-pil-{_m}-{_i}'] = _save(
            _m, 'gif', interlace=_i, **({'transparency': 5} if _m == 'P'
                                        else {}))
for _m in ('1', 'L', 'LA', 'P', 'PA', 'I;16', 'I', 'F', 'RGB', 'RGBA',
           'CMYK'):
    for _c in ('raw', 'packbits', 'tiff_lzw', 'tiff_deflate',
               'tiff_adobe_deflate'):
        CASES[f'tiff-pil-{_m}-{_c}'] = _save(_m, 'tif', compression=_c)
for _m, _p in (('L', 2), ('RGB', 2), ('I;16', 2), ('RGBA', 2), ('F', 3)):
    for _c in ('tiff_lzw', 'tiff_deflate'):
        CASES[f'tiff-pil-{_m}-{_c}-pred{_p}'] = _save(
            _m, 'tif', compression=_c, tiffinfo={317: _p})


def _case(name, suffix):
    def deco(fn):
        CASES[name] = (fn, suffix)
        return fn
    return deco


_IDX8 = _rng.integers(0, 256, (H, W))
_PAL = _rng.integers(0, 256, (256, 3))


@_case('bmp-core-8', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_IDX8, 8), 8, header=12, palette=_PAL)


@_case('bmp-v4-4bit-top-down', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_IDX8[::-1] % 16, 4), 4, header=108,
         palette=_PAL[:16], top_down=True)


@_case('bmp-v5-1bit', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_IDX8 % 2, 1), 1, header=124, palette=_PAL[:2])


@_case('bmp-short-palette', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_IDX8, 8), 8, palette=_PAL[:40], colors=40)


@_case('bmp-16-555-rgb', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_rng.integers(0, 65536, (H, W)), 16), 16)


@_case('bmp-16-555-bitfields', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_rng.integers(0, 65536, (H, W)), 16), 16, comp=3,
         masks=(0x7C00, 0x3E0, 0x1F, 0))


@_case('bmp-16-565-bitfields-v5', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_rng.integers(0, 65536, (H, W)), 16), 16, comp=3,
         masks=(0xF800, 0x7E0, 0x1F, 0), header=124)


@_case('bmp-24-v4', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(RGB, 24), 24, header=108)


@_case('bmp-32-rgb', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_rng.integers(0, 2 ** 32, (H, W)), 32), 32)


@_case('bmp-32-bitfields-alpha', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_rng.integers(0, 2 ** 32, (H, W)), 32), 32, comp=3,
         masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=124)


@_case('bmp-32-bitfields-abgr', 'bmp')
def _(p):
    _bmp(p, _bmp_rows(_rng.integers(0, 2 ** 32, (H, W)), 32), 32, comp=3,
         masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF), header=56)


@_case('bmp-rle8', 'bmp')
def _(p):
    _bmp(p, _rle_rows(_IDX8, False), 8, comp=1, palette=_PAL)


@_case('bmp-rle4', 'bmp')
def _(p):
    _bmp(p, _rle_rows(_IDX8 % 16, True), 4, comp=2, palette=_PAL[:16])


@_case('tga-cmap-first-16bit-entries', 'tga')
def _(p):
    cmap = _rng.integers(0, 65536, 60).astype('<u2').tobytes()
    _tga(p, 1, 8, (5 + _IDX8 % 60).astype(np.uint8)[..., None], cmap=cmap,
         first=5, cmap_depth=16)


@_case('tga-cmap-rle-bottom-up', 'tga')
def _(p):
    cmap = _rng.integers(0, 256, (256, 3)).astype(np.uint8).tobytes()
    idx = (_IDX8 // 64).astype(np.uint8)[..., None]
    _tga(p, 1, 8, idx, cmap=cmap, flags=0, rle=True)


@_case('tga-16bit-truecolor-right-to-left', 'tga')
def _(p):
    px = _rng.integers(0, 65536, (H, W)).astype('<u2').view(np.uint8)
    _tga(p, 2, 16, px.reshape(H, W, 2), flags=0x30)


@_case('tga-24bit-rle-runs-across-rows', 'tga')
def _(p):
    px = np.repeat(RGB[:, ::8], 8, axis=1)[:, :W]
    _tga(p, 2, 24, np.ascontiguousarray(px[..., ::-1]), rle=True,
         flags=0x10)


@_case('tga-grey-rle', 'tga')
def _(p):
    _tga(p, 3, 8, (GREY // 32 * 32)[..., None], rle=True)


@_case('pnm-plain-with-comments', 'ppm')
def _(p):
    body = ' '.join(str(v) for v in (RGB.reshape(-1) % 200))
    with open(p, 'w') as f:
        f.write(f'P3\n# a comment\n{W} # width\n{H}\n199\n{body}\n')


@_case('pnm-plain-grey-maxval-1000', 'pgm')
def _(p):
    v = _rng.integers(0, 1001, (H, W))
    rows = '\n'.join(' '.join(map(str, r)) + ' # row' for r in v)
    with open(p, 'w') as f:
        f.write(f'P2 {W} {H} 1000\n{rows}\n')


@_case('pnm-plain-bitmap', 'pbm')
def _(p):
    rows = '\n'.join(''.join(map(str, r)) for r in (GREY > 100) * 1)
    with open(p, 'w') as f:
        f.write(f'P1\n#c\n{W} {H}\n{rows}\n')


@_case('pnm-binary-maxval-100', 'ppm')
def _(p):
    with open(p, 'wb') as f:
        f.write(f'P6 {W}\n#x\n{H} 100\n'.encode())
        f.write((RGB % 101).astype(np.uint8).tobytes())


@_case('pnm-16bit-colour', 'ppm')
def _(p):
    with open(p, 'wb') as f:
        f.write(f'P6\n{W} {H}\n65535\n'.encode())
        f.write(_rng.integers(0, 65536, (H, W, 3)).astype('>u2').tobytes())


@_case('pnm-16bit-grey', 'pgm')
def _(p):
    with open(p, 'wb') as f:
        f.write(f'P5\n{W} {H}\n65535\n'.encode())
        f.write(_rng.integers(0, 400, (H, W)).astype('>u2').tobytes())


@_case('pnm-grey-maxval-4000', 'pgm')
def _(p):
    with open(p, 'wb') as f:
        f.write(f'P5\n{W} {H}\n4000\n'.encode())
        f.write(_rng.integers(0, 4001, (H, W)).astype('>u2').tobytes())


@_case('pfm-grey-little-endian', 'pfm')
def _(p):
    with open(p, 'wb') as f:
        f.write(f'Pf\n{W} {H}\n-1.0\n'.encode())
        f.write(_rng.uniform(-10, 300, (H, W)).astype('<f4').tobytes())


@_case('pfm-grey-big-endian', 'pfm')
def _(p):
    with open(p, 'wb') as f:
        f.write(f'Pf\n{W} {H}\n2.0\n'.encode())
        f.write(_rng.uniform(0, 260, (H, W)).astype('>f4').tobytes())


@_case('gif-full-lzw-table', 'gif')
def _(p):
    _gif(p, _rng.integers(0, 256, (64, 96)), _PAL)


@_case('gif-cleared-table-local-palette-interlaced', 'gif')
def _(p):
    _gif(p, _rng.integers(0, 256, (64, 96)), _PAL, local=True,
         interlace=True, clear_when_full=True)


@_case('gif87a-offset-frame-transparency', 'gif')
def _(p):
    _gif(p, _IDX8 % 8, _PAL[:8], bits=3, offset=(3, 2),
         screen=(W + 9, H + 4), transparency=6, version=b'GIF87a')


@_case('gif-grey-ramp-palette', 'gif')
def _(p):
    ramp = np.repeat(np.arange(16)[:, None], 3, 1)
    _gif(p, _IDX8 % 16, ramp, bits=4)


_S16 = _rng.integers(0, 65536, (H, W, 4))
_F32 = _rng.uniform(-5, 300, (H, W, 1)).astype(np.float32)
_TIFF_NP = {
    'rgb': (RGB, 2, 8, {}),
    'rgba-associated': (RGBA, 2, 8, {'extra': (1,)}),
    'rgba-unassociated': (RGBA, 2, 8, {'extra': (2,)}),
    'rgbx': (RGBA, 2, 8, {'extra': (0,)}),
    'rgb16': (_S16[..., :3], 2, 16, {}),
    'rgba16-associated': (_S16, 2, 16, {'extra': (1,)}),
    'grey16': (_S16[..., :1], 1, 16, {}),
    'float': (_F32, 1, 32, {'sfmt': 3}),
    'int32': (_rng.integers(-500, 70000, (H, W, 1)), 1, 32, {'sfmt': 2}),
    'cmyk': (RGBA, 5, 8, {}),
    'cmyk16': (_S16, 5, 16, {}),
    'white-is-zero-4bit': (_IDX8[..., None] % 16, 0, 4, {}),
    'grey-2bit': (_IDX8[..., None] % 4, 1, 2, {}),
    'palette-4bit': (_IDX8[..., None] % 16, 3, 4,
                     {'cmap': _rng.integers(0, 65536, (16, 3))}),
    'palette-8bit-alpha': (np.stack([_IDX8, GREY], -1), 3, 8,
                           {'extra': (2,), 'cmap': _rng.integers(
                               0, 65536, (256, 3))}),
}
for _n, (_s, _ph, _b, _kw) in _TIFF_NP.items():
    for _bo, _comp, _tile in (('>', 1, None), ('<', 8, (16, 16)),
                              ('>', 32773, (16, 16))):
        CASES[f'tiff-np-{_n}-{_bo}-{_comp}-{_tile}'] = (
            lambda p, s=_s, ph=_ph, b=_b, kw=_kw, bo=_bo, c=_comp, t=_tile:
            _tiff(p, s, ph, b, bo=bo, comp=c, tile=t, **kw), 'tif')
for _bo, _comp in (('<', 1), ('>', 8), ('<', 32773)):
    CASES[f'tiff-np-planar-rgb-{_bo}-{_comp}'] = (
        lambda p, bo=_bo, c=_comp: _tiff(p, RGB, 2, 8, bo=bo, comp=c,
                                         planar=2), 'tif')
    # PIL's own reader (uncompressed) miscounts an edge tile's stride
    # when ExtraSamples is missing, so that file is tiled only compressed
    CASES[f'tiff-np-planar-rgba-{_bo}-{_comp}'] = (
        lambda p, bo=_bo, c=_comp: _tiff(p, RGBA, 2, 8, bo=bo, comp=c,
                                         planar=2, tile=(16, 16) if c != 1
                                         else None), 'tif')
    CASES[f'tiff-np-fill2-grey1-{_bo}-{_comp}'] = (
        lambda p, bo=_bo, c=_comp: _tiff(p, _IDX8[..., None] % 2, 0, 1,
                                         bo=bo, comp=c, fill=2), 'tif')
    CASES[f'tiff-np-fill2-rgb-{_bo}-{_comp}'] = (
        lambda p, bo=_bo, c=_comp: _tiff(p, RGB, 2, 8, bo=bo, comp=c,
                                         fill=2), 'tif')
    CASES[f'tiff-np-pred2-grey16-{_bo}-{_comp}'] = (
        lambda p, bo=_bo, c=_comp: _tiff(p, _S16[..., :1], 1, 16, bo=bo,
                                         comp=c, pred=2), 'tif')


@_case('dib-8bit-palette', 'dib')
def _(p):
    """A BMP without its 14-byte file header (PIL's DIB)."""
    _bmp(p, _bmp_rows(_IDX8, 8), 8, palette=_PAL)
    with open(p, 'rb') as f:
        data = f.read()
    with open(p, 'wb') as f:
        f.write(data[14:])


# JPEG-in-TIFF and YCbCr TIFF through the libtiff that PIL bundles (PIL's
# save asks for no strip height, tiles or YCbCr subsampling): name ->
# (pixels: RGB or grey for JPEG, full-resolution YCbCr otherwise,
# photometric, compression, libtiff_write's arguments)
_YCC = np.asarray(Image.fromarray(RGB).convert('YCbCr'))
_LIBTIFF = {
    'jpeg-rgb-strips': (RGB, 2, 7, {'strip': 16}),
    'jpeg-rgb-tiles': (RGB, 2, 7, {'tile': (16, 16)}),
    'jpeg-grey-strips': (GREY[..., None], 1, 7, {'strip': 8}),
    'jpeg-ycbcr22-strips': (RGB, 6, 7, {'strip': 16, 'subsampling': (2, 2)}),
    'jpeg-ycbcr22-tiles': (RGB, 6, 7, {'tile': (32, 16),
                                       'subsampling': (2, 2)}),
    'jpeg-ycbcr21-strips': (RGB, 6, 7, {'strip': 8, 'subsampling': (2, 1)}),
    'jpeg-ycbcr11-tiles': (RGB, 6, 7, {'tile': (16, 16),
                                       'subsampling': (1, 1)}),
    'ycbcr22-lzw-tiles': (_YCC, 6, 5, {'tile': (16, 16),
                                       'subsampling': (2, 2)}),
    'ycbcr11-deflate-pred2': (_YCC, 6, 8, {
        'strip': 8, 'subsampling': (1, 1), 'tags': ((317, 2),)}),
    'ycbcr22-lzw-black-white': (_YCC, 6, 5, {
        'strip': 6, 'subsampling': (2, 2),
        'tags': ((532, [16.0, 235.0, 128.0, 240.0, 128.0, 240.0]),)}),
    'ycbcr11-lzw-coefficients': (_YCC, 6, 5, {
        'strip': 8, 'subsampling': (1, 1),
        'tags': ((529, [0.2126, 0.7152, 0.0722]),)}),
    'ycbcr21-packbits-cosited': (_YCC, 6, 32773, {
        'strip': 8, 'subsampling': (2, 1), 'tags': ((531, 2),)}),
}
for _hs, _vs in ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4)):
    for _comp in (5, 8, 32773):
        _LIBTIFF[f'ycbcr{_hs}{_vs}-{_comp}'] = (_YCC, 6, _comp, {
            'strip': 8, 'subsampling': (_hs, _vs)})
for _name, (_px, _photo, _comp, _kw) in _LIBTIFF.items():
    CASES[f'tiff-libtiff-{_name}'] = (
        lambda p, a=(_px, _photo, _comp), kw=_kw: libtiff_write(p, *a, **kw),
        'tif')
for _c in ('jpeg', 'tiff_lzw', 'tiff_deflate', 'packbits'):
    CASES[f'tiff-pil-YCbCr-{_c}'] = (
        lambda p, c=_c: _pil('RGB').convert('YCbCr').save(p, compression=c),
        'tif')
for _m in ('RGB', 'L'):
    CASES[f'tiff-pil-{_m}-jpeg'] = _save(_m, 'tif', compression='jpeg')

CASES['tiff-np-bigtiff'] = (lambda p: _tiff(p, RGB, 2, 8, big=True,
                                            comp=8, tile=(16, 16)), 'tif')
CASES['tiff-np-strips-of-5'] = (lambda p: _tiff(p, RGB, 2, 8, comp=32773,
                                                rows_per_strip=5), 'tif')


def _reference(path):
    """The reference's loads with gamma True and False, or the type of
    the exception it raises."""
    try:
        return [jtex.load_bitmap(path, gamma=g) for g in (True, False)]
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e)


@pytest.mark.parametrize('name', list(CASES))
def test_load_bitmap_matches_reference(tmp_path, name):
    write, suffix = CASES[name]
    path = str(tmp_path / f'{name}.{suffix}')
    write(path)
    ref = _reference(path)
    assert not isinstance(ref, type), f"the reference refuses: {ref}"
    assert ptex.identify(path) == Image.open(path).format
    for got, want in zip([ptex.load_bitmap(path, gamma=g)
                          for g in (True, False)], ref):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


# files PIL identifies but refuses, and what it raises
REFUSED = {
    'tga-pil-1-rle': (_save('1', 'tga', compression='tga_rle')[0], 'tga',
                      OSError),
    'tga-15bit': (lambda p: _tga(p, 2, 15, RGB[..., :2]), 'tga', OSError),
    'tga-cmap-32bit-entries': (lambda p: _tga(
        p, 1, 8, (_IDX8 // 64).astype(np.uint8)[..., None], cmap=bytes(1024),
        cmap_depth=32), 'tga', ValueError),
    'tga-rle-run-across-rows': (lambda p: _tga(
        p, 3, 8, (_IDX8 // 64).astype(np.uint8)[..., None], rle=True,
        runs_cross_rows=True), 'tga', OSError),
    'pfm-colour': (lambda p: open(p, 'wb').write(
        f'PF\n{W} {H}\n-1.0\n'.encode() + RGB.astype('<f4').tobytes()),
        'pfm', OSError),
    'bmp-bad-bitfields': (lambda p: _bmp(
        p, _bmp_rows(_rng.integers(0, 2 ** 32, (H, W)), 32), 32, comp=3,
        masks=(0xFF, 0xFF00, 0xFF0000, 0)), 'bmp', OSError),
    'tiff-big-endian-bigtiff': (lambda p: _tiff(p, RGB, 2, 8, bo='>',
                                                big=True), 'tif', OSError),
    'tiff-planar-associated-alpha-uncompressed': (lambda p: _tiff(
        p, RGBA, 2, 8, planar=2, extra=(1,)), 'tif', ValueError),
    # PIL's own reader unpacks uncompressed YCbCr as RGBX, 4 bytes a pixel,
    # and runs past the file's end
    'tiff-ycbcr-uncompressed': (lambda p: libtiff_write(
        p, _YCC, 6, 1, strip=8, subsampling=(2, 2)), 'tif', OSError),
    'tiff-ycbcr-subsampling-2x4': (lambda p: libtiff_write(
        p, _YCC, 6, 5, strip=8, subsampling=(2, 4)), 'tif', OSError),
}


@pytest.mark.parametrize('name', list(REFUSED))
def test_refused_layouts_raise_as_in_reference(tmp_path, name):
    write, suffix, exc = REFUSED[name]
    path = str(tmp_path / f'{name}.{suffix}')
    write(path)
    ref = _reference(path)
    assert isinstance(ref, type) and issubclass(ref, exc), ref
    with pytest.raises(exc):
        ptex.load_bitmap(path)


def test_unidentified_file_raises_oserror_in_both(tmp_path):
    rgbe = tmp_path / 'sky.hdr'           # RGBE: no PIL plugin opens it
    rgbe.write_bytes(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 2\n'
                     + bytes(16))
    junk = tmp_path / 'junk.png'
    junk.write_bytes(bytes(range(64)))
    for path in (str(rgbe), str(junk)):
        with pytest.raises(OSError):
            jtex.load_bitmap(path)
        with pytest.raises(OSError):
            ptex.load_bitmap(path)


@pytest.mark.parametrize('fmt,kw', [('SGI', {}),
                                    ('QOI', {}),
                                    ('PCX', {})])
def test_formats_outside_the_slice_name_their_roadmap_entry(tmp_path, fmt,
                                                            kw):
    """SGI, QOI and PCX, outside the port until slice 17, now decode as
    the reference does; a format still outside (AVIF, ROADMAP 12.7's
    remainder) raises naming its entry."""
    path = str(tmp_path / f'img.{fmt.lower()}')
    _pil('RGB').save(path, fmt, **kw)
    assert ptex.identify(path) == fmt
    ref = _reference(path)
    assert not isinstance(ref, type), ref
    for g, want in zip((True, False), ref):
        assert ptex.load_bitmap(path, gamma=g).tobytes() == want.tobytes()
    avif = str(tmp_path / 'img.avif')
    _pil('RGB').save(avif, 'AVIF')
    assert ptex.identify(avif) == 'AVIF'
    assert jtex.load_bitmap(avif).shape[2] == 3
    with pytest.raises(NotImplementedError, match=r'item 12\.7'):
        ptex.load_bitmap(avif)


def _old_jpeg(path):
    """A JPEG-in-TIFF whose compression tag says old-style JPEG (6)."""
    _pil('RGB').save(path, compression='jpeg')
    with open(path, 'r+b') as f:
        data = f.read()
        pos = struct.unpack_from('<I', data, 4)[0]
        for k in range(struct.unpack_from('<H', data, pos)[0]):
            e = pos + 2 + 12 * k
            if struct.unpack_from('<H', data, e)[0] == 259:
                f.seek(e + 8)
                f.write(struct.pack('<H', 6))


# TIFF layouts the port left until slice 17 (the reference opens them
# through PIL; a PIL JPEG-in-TIFF marked old-style JPEG, whose strips lack
# their tables, and the 12-bit file ``_tiff`` writes with a byte a sample,
# whose strip falls short, fail in both)
LEFT = {
    'old-jpeg': _old_jpeg,
    'ccitt-group4': lambda p: _pil('1').save(p, compression='group4'),
    'ccitt-group3': lambda p: _pil('1').save(p, compression='group3'),
    'cielab': lambda p: _pil('RGB').convert('LAB').save(p),
    'grey-12-bit': lambda p: _tiff(p, GREY[..., None], 1, 12),
    'orientation-6': lambda p: _pil('RGB').save(p, tiffinfo={274: 6}),
}


@pytest.mark.parametrize('name', list(LEFT))
def test_tiff_layouts_left_name_their_roadmap_entry(tmp_path, name):
    """Slice 17 ported these: each decodes as the reference does, or
    raises the reference's error type."""
    path = str(tmp_path / f'{name}.tif')
    LEFT[name](path)
    assert ptex.identify(path) == Image.open(path).format == 'TIFF'
    ref = _reference(path)
    if isinstance(ref, type):
        assert name in ('old-jpeg', 'grey-12-bit') and \
            issubclass(ref, OSError), ref
        with pytest.raises(ref):
            ptex.load_bitmap(path)
        return
    for g, want in zip((True, False), ref):
        assert ptex.load_bitmap(path, gamma=g).tobytes() == want.tobytes()


@pytest.mark.parametrize('mode', ['1', 'L', 'LA', 'P', 'PA', 'I', 'I;16',
                                  'I;16B', 'F', 'RGB', 'RGBA', 'RGBX',
                                  'CMYK', 'YCbCr', 'I;16L'])
def test_pil_rgb_equals_convert(mode):
    """``_pil_rgb`` against PIL's ``convert('RGB')`` on random samples of
    each mode (palettes of 40 entries: indices past them read PIL's grey
    ramp)."""
    rng = np.random.default_rng(3)
    if mode in ('P', 'PA'):
        px = rng.integers(0, 256, (H, W, len(mode))).astype(np.uint8)
        pal = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        im = Image.frombytes(mode, (W, H), px.tobytes())
        im.putpalette(pal.tobytes())
        want = np.asarray(im.convert('RGB'))
        assert ptex._pil_rgb(mode, px[..., 0] if mode == 'P' else px,
                             pal).tobytes() == want.tobytes()
        return
    dtype, bands = {'I': (np.int32, 1), 'I;16': ('<u2', 1),
                    'I;16B': ('>u2', 1), 'I;16L': ('<u2', 1),
                    'YCbCr': (np.uint8, 3), 'F': (np.float32, 1),
                    '1': (np.uint8, 1), 'L': (np.uint8, 1),
                    'LA': (np.uint8, 2)}.get(mode, (np.uint8, len(mode)))
    if mode == 'F':
        px = rng.uniform(-50, 400, (H, W)).astype(np.float32)
        px[0, :4] = (254.999, 0.5, -0.5, 255.5)
    elif mode in ('I', 'I;16', 'I;16B', 'I;16L'):
        px = rng.integers(-300 if mode == 'I' else 0, 65536,
                          (H, W)).astype(dtype)
    else:
        px = rng.integers(0, 256, (H, W, bands)).astype(np.uint8)
        if mode == '1':
            px = (px > 127).astype(np.uint8) * 255
        px = px[..., 0] if bands == 1 else px
    raw = px.tobytes() if mode != '1' else np.packbits(px > 0,
                                                       axis=1).tobytes()
    want = np.asarray(Image.frombytes(mode, (W, H), raw).convert('RGB'))
    assert ptex._pil_rgb(mode, px).tobytes() == want.tobytes()


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                        'bitmaps')


def test_fixtures_decode_to_pils_stored_bytes():
    """The committed fixtures (``scripts/port_make_bitmaps.py``) that
    ``chip_smoke.py`` decodes on the card's machine, which has no PIL:
    the port's bytes equal the stored PIL bytes, and those equal what
    this PIL makes of the files now."""
    want = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
    assert len(want.files) == len(os.listdir(FIXTURES)) - 1
    for name in want.files:
        path = os.path.join(FIXTURES, name)
        assert ptex.read_rgb8(path).tobytes() == want[name].tobytes(), name
        pil = np.asarray(Image.open(path).convert('RGB'))
        assert pil.tobytes() == want[name].tobytes(), name


def test_textured_render_equal_across_lossless_formats(tmp_path):
    """``cbox_textured`` (16x16, 1 spp, on the CPU) with the 64x64
    picture as every bitmap renders the same image in every bit from each
    of its eleven lossless copies, the reversible JP2, the ICO (a PNG
    icon), the RLE PSD and the Zstandard TIFF among them (the card's
    ``textured_formats`` phase at a smaller size)."""
    import mitsuba_nlvrl_tpu_torch as P
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_textured
    imgs = {}
    for ext in ('png', 'bmp', 'tga', 'ppm', 'gif', 'tif', 'webp', 'jp2',
                'ico', 'psd', 'zstd.tif'):
        path = cbox_textured(str(tmp_path / ext), spp=1, res=16,
                             bitmap=os.path.join(FIXTURES,
                                                 f'picture64.{ext}'))
        scene, meta = P.build_scene(load_file(path), device='cpu')
        assert scene.textures.data.shape[1:3] == (64, 64)
        imgs[ext] = P.render(scene, meta, seed=0)
    for ext, img in imgs.items():
        assert torch.equal(img, imgs['png']), ext
