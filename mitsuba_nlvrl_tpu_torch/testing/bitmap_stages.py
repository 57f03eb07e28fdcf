"""The bitmap decoders' native stages and their plain twins.

Each stage that ``native/bitmap_*.cpp`` computes for the decoders of
``utils/`` has a twin of the same arguments, results and failures in
numpy and Python, named ``<stage>_plain`` beside it. The load path calls
the native stages only; the tests and ``scripts/port_bitmap_speed.py``
swap the plain twins in with ``plain()`` to hold one against the other.
``png_filtered`` writes the PNG files that exercise the row filters,
``tiff_lzw`` LZW TIFF files of given pixels at a texture's size,
``jpeg_lossless`` lossless JPEG files, ``picture`` the smooth seeded
pictures the large files are made of, ``dds_file`` DDS files of given
headers and data, ``bcn_random_dds`` DDS files of seeded random blocks
(every bit pattern is a block PIL decodes), ``large_file`` the path of a
large fixture, writing the seeded ones it names (``raster_files`` writes
the Sun raster, FLC and Photo CD ones), and the JPEG 2000 and
icon writers: ``j2k_segments`` and ``j2k_join`` split and rejoin a
codestream's marker segments, ``jp2_file`` wraps a codestream in JP2
boxes, ``dib`` and ``icon_file`` write ICO and CUR files of DIB or PNG
icons, ``icns_rle`` and ``icns_file`` ICNS files; ``thunderscan`` and
``ccitt_rlew`` code the strips of ThunderScan and word-aligned CCITT RLE
TIFF files (libtiff has no encoder of either), ``packbits`` and
``psd_file`` write PSD files.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import struct
import zlib

import numpy as np

# (module of utils, stage): each has its twin, stage + '_plain'
STAGES = (('io', '_png_unfilter'), ('jpeg', '_decode_scan'),
          ('jpeg', '_idct_plane'), ('jpeg', '_upsample'),
          ('jpeg', '_ycc_to_rgb'), ('vp8l', '_pixels'),
          ('vp8l', '_unpredict'), ('vp8l', '_uncross'),
          ('vp8', '_macroblocks'), ('vp8', 'yuv_to_rgb'),
          ('jpeg', '_decode_lossless'), ('webp', '_unfilter_gradient'),
          ('tiff', '_lzw'), ('gif', '_lzw'), ('ccitt', 'decode'),
          ('dds', '_bcn'), ('qoi', '_qoi'), ('sgi', '_sgi_rle'),
          ('pcx', '_pcx_rle'), ('j2k', '_t1'), ('j2k', '_idwt53'),
          ('j2k', '_idwt97'), ('j2k', '_finish'), ('zstd', 'decompress'),
          ('tiff', '_thunderscan'), ('sun', '_sun_rle'), ('msp', '_msp_rle'),
          ('fli', '_fli_frame'))


def _module(name: str):
    return importlib.import_module(f'{__package__.rsplit(".", 1)[0]}'
                                   f'.utils.{name}')


@contextlib.contextmanager
def plain():
    """Decode through the plain twins while the block runs."""
    saved = []
    try:
        for mod, stage in STAGES:
            m = _module(mod)
            saved.append((m, stage, getattr(m, stage)))
            setattr(m, stage, getattr(m, stage + '_plain'))
        yield
    finally:
        for m, stage, fn in reversed(saved):
            setattr(m, stage, fn)


@contextlib.contextmanager
def forbid_plain():
    """Make every plain twin raise while the block runs: what decodes in
    it took the native path."""
    saved = []

    def refuse(*args, **kwargs):
        raise AssertionError("a plain twin was called on the load path")
    try:
        for mod, stage in STAGES:
            m = _module(mod)
            saved.append((m, stage + '_plain', getattr(m, stage + '_plain')))
            setattr(m, stage + '_plain', refuse)
        yield
    finally:
        for m, name, fn in reversed(saved):
            setattr(m, name, fn)


def png_filtered(img: np.ndarray, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG file of an (H, W, 3) or (H, W, 4) uint8 image, 8 bits a
    sample, its row y filtered by ``filters[y % len(filters)]`` (0 none, 1
    sub, 2 up, 3 average, 4 Paeth), as libpng writes photographs."""
    H, W, C = img.shape
    # the image with a zero row above and C zero bytes to the left
    xp = np.zeros((H + 1, (W + 1) * C), np.int16)
    xp[1:, C:] = img.reshape(H, W * C)
    x, left, up, ul = xp[1:, C:], xp[1:, :-C], xp[:-1, C:], xp[:-1, :-C]
    ftype = np.asarray(filters, np.uint8)[np.arange(H) % len(filters)]
    rows = np.empty((H, W * C + 1), np.uint8)
    rows[:, 0] = ftype
    for f in np.unique(ftype):
        if f == 4:
            pa, pb = np.abs(up - ul), np.abs(left - ul)
            pc = np.abs(left + up - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = (0, left, up, (left + up) >> 1)[f]
        res = (x - pred).astype(np.uint8)        # mod 256
        sel = ftype == f
        rows[sel, 1:] = res[sel] if len(filters) > 1 else res

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return struct.pack('>I', len(payload)) + tag + payload + \
            struct.pack('>I', zlib.crc32(tag + payload) & 0xFFFFFFFF)
    ihdr = struct.pack('>IIBBBBB', W, H, 8, {3: 2, 4: 6}[C], 0, 0, 0)
    return b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr) + chunk(
        b'IDAT', zlib.compress(rows.tobytes(), 1)) + chunk(b'IEND', b'')


def picture(n: int, seed: int, noisy: float = 1.0) -> np.ndarray:
    """An n x n RGB uint8 picture as a texture's photograph is: smooth
    colour waves, seeded darker discs, and mild Gaussian noise (sigma 2)
    on the top ``noisy`` share of its rows (a lossless file of noise
    everywhere would be mostly noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n
    img = 127.5 + 110 * np.sin(2 * np.pi * np.stack(
        [3 * xx + yy, 2 * yy - xx, 4 * (xx + yy) * (1 + 0.3 * xx)], -1))
    for cy, cx, r in rng.uniform(0, 1, (24, 3)):
        r = 0.02 + 0.06 * r
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] *= 0.6
    rows = int(round(noisy * n))
    img[:rows] += rng.normal(0.0, 2.0, (rows, n, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def tiff_lzw(img: np.ndarray, rows: int = 64) -> bytes:
    """A little-endian TIFF of an (H, W, 3) uint8 image: LZW with
    predictor 2, in strips of ``rows`` rows. Each strip's LZW stream holds
    every byte as a 9-bit literal code, a clear code first and after each
    253 codes (before the decoder's table reaches 511 entries and widens
    its codes) and the end code last: a valid stream written fast in
    numpy, not a compact one."""
    H, W, _ = img.shape
    diff = img.astype(np.int16)
    diff[:, 1:] -= img[:, :-1].astype(np.int16)
    diff = (diff & 0xFF).astype(np.uint16).reshape(H, W * 3)
    strips = []
    for y in range(0, H, rows):
        data = diff[y:y + rows].reshape(-1)
        groups = -(-data.size // 253)
        codes = np.full(groups * 254 + 1, 256, np.uint16)   # clear codes
        lit = np.arange(groups * 254).reshape(groups, 254)[:, 1:].reshape(-1)
        codes[lit[:data.size]] = data
        codes = np.delete(codes, lit[data.size:])
        codes[-1] = 257                                     # end
        bits = np.unpackbits(codes.astype('>u2').view(np.uint8)).reshape(
            -1, 16)[:, 7:]
        strips.append(np.packbits(bits.reshape(-1)).tobytes())
    n_strips = len(strips)
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8, 8, 8]),
            (259, 3, [5]), (262, 3, [2]), (273, 4, [0] * n_strips),
            (277, 3, [3]), (278, 4, [rows]),
            (279, 4, [len(s) for s in strips]), (284, 3, [1]),
            (317, 3, [2])]
    ifd_size = 2 + 12 * len(tags) + 4
    extra = 8 + ifd_size                 # arrays that do not fit inline
    layout = {}
    for tag, typ, vals in tags:
        size = (2 if typ == 3 else 4) * len(vals)
        if size > 4:
            layout[tag] = extra
            extra += size
    offsets = np.cumsum([extra] + [len(s) for s in strips])[:-1]
    tags[5] = (273, 4, [int(o) for o in offsets])
    head = b'II*\x00' + struct.pack('<I', 8) + struct.pack('<H', len(tags))
    arrays = b''
    for tag, typ, vals in tags:
        fmt = '<%d%s' % (len(vals), 'H' if typ == 3 else 'I')
        packed = struct.pack(fmt, *vals)
        if tag in layout:
            head += struct.pack('<HHII', tag, typ, len(vals), layout[tag])
            arrays += packed
        else:
            head += struct.pack('<HHI', tag, typ, len(vals)) + \
                packed.ljust(4, b'\0')
    return head + struct.pack('<I', 0) + arrays + b''.join(strips)


def jpeg_lossless(img: np.ndarray, psv: int = 1, restart_rows: int = 0,
                  pt: int = 0) -> bytes:
    """A lossless (SOF3) JPEG of an (H, W) or (H, W, C) uint8 image:
    predictor ``psv`` (1-7), point transform ``pt``, one interleaved scan,
    every difference category coded in 5 bits, a restart marker every
    ``restart_rows`` rows (0: none). The differences are taken from the
    image's own (shifted) samples, so the whole file is written in numpy."""
    x = (img if img.ndim == 3 else img[..., None]).astype(np.int64) >> pt
    H, W, C = x.shape
    a = np.zeros_like(x)
    b = np.zeros_like(x)
    c = np.zeros_like(x)
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pred = (a, b, c, a + b - c, a + ((b - c) >> 1), b + ((a - c) >> 1),
            (a + b) >> 1)[psv - 1].copy()
    first = np.zeros(H, bool)
    first[::restart_rows or H] = True
    pred[:, 0] = b[:, 0]
    pred[first] = a[first]
    pred[first, 0] = 1 << (7 - pt)
    d = (x - pred) & 0xFFFF
    d = np.where(d >= 32768, d - 65536, d)
    n = np.zeros(d.shape, np.int64)
    nz = d != 0
    n[nz] = np.floor(np.log2(np.abs(d[nz]))).astype(np.int64) + 1
    v = np.where(d > 0, d, d + (1 << n) - 1) & ((1 << n) - 1)
    code, length = (n << n) | v, 5 + n          # category, then the bits
    rows_per = restart_rows or H
    scan = b''
    for y0 in range(0, H, rows_per):
        cd = code[y0:y0 + rows_per].reshape(-1)
        ln = length[y0:y0 + rows_per].reshape(-1)
        ends = np.cumsum(ln)
        bits = np.ones(-(-int(ends[-1]) // 8) * 8, np.uint8)   # 1-fill
        for k in range(21):                     # bit k from each code's end
            sel = ln > k
            bits[ends[sel] - 1 - k] = (cd[sel] >> k) & 1
        seg = np.packbits(bits).tobytes().replace(b'\xff', b'\xff\x00')
        if y0:
            scan += bytes([0xFF, 0xD0 + (y0 // rows_per - 1) % 8])
        scan += seg
    sof = struct.pack('>BHHB', 8, H, W, C) + b''.join(
        bytes([i + 1, 0x11, 0]) for i in range(C))
    dht = bytes([0, 0, 0, 0, 0, 17] + [0] * 11) + bytes(range(17))
    sos = bytes([C]) + b''.join(bytes([i + 1, 0]) for i in range(C)) + \
        bytes([psv, 0, pt])

    def seg_(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack('>H', len(body) + 2) + body
    dri = seg_(0xDD, struct.pack('>H', restart_rows * W)) \
        if restart_rows else b''
    return (b'\xff\xd8' + seg_(0xC3, sof) + seg_(0xC4, dht) + dri +
            seg_(0xDA, sos) + scan + b'\xff\xd9')


def dds_file(w: int, h: int, data: bytes, *, fourcc: bytes = None,
             dxgi: int = None, pfflags: int = 0, bitcount: int = 0,
             masks=(), mipmaps: int = 1) -> bytes:
    """A DDS file of a ``w`` x ``h`` surface: ``data`` after the 124-byte
    header, behind a DX10 header where ``dxgi`` is given (FourCC
    ``DX10``), else with ``fourcc`` or the pixel format flags, bit count
    and masks given."""
    head = bytearray(128)
    head[:4] = b'DDS '
    struct.pack_into('<7I', head, 4, 124, 0x1007 | 0x20000, h, w, 0, 0,
                     mipmaps)
    if dxgi is not None:
        fourcc = b'DX10'
    if fourcc is not None:
        pfflags |= 0x4
    struct.pack_into('<4I', head, 76, 32, pfflags,
                     struct.unpack('<I', fourcc)[0] if fourcc else 0,
                     bitcount)
    struct.pack_into(f'<{len(masks)}I', head, 92, *masks)
    struct.pack_into('<I', head, 108, 0x1000)
    dx10 = struct.pack('<5I', dxgi, 3, 0, 1, 0) if dxgi is not None else b''
    return bytes(head) + dx10 + data


# DXGI formats of the BCn blocks: number (1-7) and bytes a block
BCN_DXGI = {71: (1, 8), 74: (2, 16), 77: (3, 16), 80: (4, 8), 83: (5, 16),
            84: (5, 16), 95: (6, 16), 96: (6, 16), 98: (7, 16)}


def bcn_random_dds(w: int, h: int, dxgi: int, seed: int) -> bytes:
    """A DX10 DDS file of ``dxgi`` BCn blocks drawn uniformly from a
    seeded generator, enough for a ``w`` x ``h`` surface."""
    blocks = -(-w // 4) * -(-h // 4) * BCN_DXGI[dxgi][1]
    data = np.random.default_rng(seed).integers(0, 256, blocks,
                                                dtype=np.uint8)
    return dds_file(w, h, data.tobytes(), dxgi=dxgi)


def large_file(folder: str, name: str, entry: dict, workdir: str) -> str:
    """The path of the large fixture ``name`` of ``folder``'s digests
    (``entry`` its record): the file there, or, for an entry that names
    its ``seeded`` content (random BCn blocks, or a ``kind`` of
    ``raster_files.large_raster``), the file written into ``workdir``."""
    seeded = entry.get('seeded')
    if not seeded:
        return os.path.join(folder, name)
    path = os.path.join(workdir, name)
    if 'kind' in seeded:
        from .raster_files import large_raster
        data = large_raster(seeded['kind'], seeded['side'], seeded['seed'])
    else:
        data = bcn_random_dds(seeded['side'], seeded['side'],
                              seeded['dxgi'], seeded['seed'])
    with open(path, 'wb') as f:
        f.write(data)
    return path


# --- JPEG 2000 ---------------------------------------------------------------

def j2k_segments(cs: bytes) -> list:
    """A codestream's parts in order: ``(marker, body)`` of each marker
    segment of the main header and of each tile part's header (SOC, SOD
    and EOC with empty bodies), and ``(0, data)`` for each tile part's
    data after its SOD."""
    out, pos = [(0xFF4F, b'')], 2
    while pos < len(cs):
        m = struct.unpack_from('>H', cs, pos)[0]
        if m == 0xFFD9:
            out.append((m, b''))
            break
        n = struct.unpack_from('>H', cs, pos + 2)[0]
        out.append((m, cs[pos + 4:pos + 2 + n]))
        if m != 0xFF90:
            pos += 2 + n
            continue
        psot = struct.unpack_from('>I', cs, pos + 6)[0]
        end = pos + psot if psot else len(cs) - 2
        pos += 2 + n
        while struct.unpack_from('>H', cs, pos)[0] != 0xFF93:
            m = struct.unpack_from('>H', cs, pos)[0]
            n = struct.unpack_from('>H', cs, pos + 2)[0]
            out.append((m, cs[pos + 4:pos + 2 + n]))
            pos += 2 + n
        out += [(0xFF93, b''), (0, cs[pos + 2:end])]
        pos = end
    return out


def j2k_join(parts: list) -> bytes:
    """``j2k_segments``' inverse: each SOT's Psot set to its part's
    length, where it is not 0 (a last part running to EOC)."""
    out, sots = bytearray(), []
    for m, body in parts:
        if m == 0:
            out += body
        elif m in (0xFF4F, 0xFF93, 0xFFD9):
            if m == 0xFFD9:
                sots.append(len(out))
            out += struct.pack('>H', m)
        else:
            if m == 0xFF90:
                sots.append(len(out))
            out += struct.pack('>HH', m, len(body) + 2) + body
    for start, end in zip(sots, sots[1:]):
        if struct.unpack_from('>I', out, start + 6)[0]:
            struct.pack_into('>I', out, start + 6, end - start)
    return bytes(out)


def jp2_box(tag: bytes, body: bytes) -> bytes:
    return struct.pack('>I', 8 + len(body)) + tag + body


def jp2_file(cs: bytes, nc: int, bpc: int, w: int, h: int, enumcs: int = 16,
             extra: bytes = b'') -> bytes:
    """A JP2 file of the codestream ``cs``: signature, ``ftyp``, a
    ``jp2h`` of ``ihdr`` (``nc`` components, depth field ``bpc``),
    ``colr`` (enumerated space ``enumcs``) and the boxes ``extra``, then
    ``jp2c``."""
    ihdr = jp2_box(b'ihdr', struct.pack('>IIHBBBB', h, w, nc, bpc, 7, 0, 0))
    colr = jp2_box(b'colr', struct.pack('>BBBI', 1, 0, 0, enumcs))
    return (jp2_box(b'jP  ', b'\r\n\x87\n') +
            jp2_box(b'ftyp', b'jp2 \0\0\0\0jp2 ') +
            jp2_box(b'jp2h', ihdr + colr + extra) + jp2_box(b'jp2c', cs))


# --- ICO, CUR and ICNS -------------------------------------------------------

def dib(index: np.ndarray, bits: int, palette=None, mask=None) -> bytes:
    """An icon's DIB: a 40-byte info header of twice the height, the
    palette (``bits`` 1, 4 or 8), the colour rows bottom up (``index``:
    (H, W) indices, or (H, W, 3) RGB for 24 bits, (H, W, 4) RGBA for 32,
    stored BGR(A)), then the AND mask's rows (``mask`` (H, W) of 0 and 1,
    1 transparent; none where None), 32-bit padded."""
    H, W = index.shape[:2]
    if bits <= 8:
        pal = np.zeros((1 << bits, 4), np.uint8)
        pal[:len(palette), :3] = np.asarray(palette, np.uint8)[:, ::-1]
        ppr = 8 // bits
        idx = np.zeros((H, -(-W // ppr) * ppr), np.uint8)
        idx[:, :W] = index
        packed = np.zeros((H, idx.shape[1] // ppr), np.uint8)
        for k in range(ppr):
            packed |= idx[:, k::ppr] << (8 - bits * (k + 1))
        rows, head = packed, pal.tobytes()
    else:
        c = index.shape[2]
        rows, head = index[..., [2, 1, 0, 3][:c]].reshape(H, W * c), b''
    stride = -(-rows.shape[1] // 4) * 4
    colour = np.zeros((H, stride), np.uint8)
    colour[:, :rows.shape[1]] = rows
    body = colour[::-1].tobytes()
    if mask is not None:
        mstride = -(-W // 32) * 4
        m = np.zeros((H, mstride * 8), np.uint8)
        m[:, :W] = mask
        body += np.packbits(m, axis=1)[::-1].tobytes()
    info = struct.pack('<IiiHHIIiiII', 40, W, 2 * H, 1, bits, 0,
                       len(body), 0, 0, 0, 0)
    return info + head + body


def icon_file(entries, cursor: bool = False) -> bytes:
    """An ICO (or CUR) file of ``entries``: (width, height, colour count,
    bits, payload) each, the payload a DIB or a PNG file's bytes, stored
    in order after the directory."""
    out = struct.pack('<HHH', 0, 2 if cursor else 1, len(entries))
    offset = 6 + 16 * len(entries)
    data = b''
    for w, h, ncol, bits, payload in entries:
        out += struct.pack('<BBBBHHII', w & 255, h & 255, ncol, 0,
                           1 if not cursor else 0, bits, len(payload),
                           offset + len(data))
        data += payload
    return out + data


def icns_rle(plane: np.ndarray) -> bytes:
    """One plane in the run-length code of ICNS's legacy icons: a run of
    3-130 equal bytes as 0x80 + (n - 3) and the byte, else literals of up
    to 128 bytes as n - 1 and the bytes."""
    return _run_coded(bytes(np.asarray(plane, np.uint8).reshape(-1)), 130,
                      lambda n: 0x80 + n - 3)


def packbits(row: bytes) -> bytes:
    """PackBits of one row: runs of 3-128 equal bytes as 257 - n and the
    byte, else literals of up to 128 bytes as n - 1 and the bytes."""
    return _run_coded(bytes(row), 128, lambda n: 257 - n)


def _run_coded(b: bytes, longest: int, run_head) -> bytes:
    """Runs of 3 to ``longest`` equal bytes as ``run_head(n)`` and the
    byte, the bytes between them as literals of up to 128 bytes (n - 1,
    then the bytes)."""
    out, i, lit = bytearray(), 0, bytearray()

    def flush():
        while lit:
            out.append(min(len(lit), 128) - 1)
            out.extend(lit[:128])
            del lit[:128]
    while i < len(b):
        j = i
        while j < len(b) and j - i < longest and b[j] == b[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([run_head(j - i), b[i]])
            i = j
        else:
            lit.append(b[i])
            i += 1
    flush()
    return bytes(out)


def icns_file(entries) -> bytes:
    """An ICNS file of ``entries``: (four-byte type, payload) each."""
    body = b''.join(t + struct.pack('>I', 8 + len(p)) + p
                    for t, p in entries)
    return b'icns' + struct.pack('>I', 8 + len(body)) + body


def thunderscan(img: np.ndarray, seed: int = 0) -> bytes:
    """ThunderScan data of (rows, width) 4-bit pixels (0-15), each row
    coded from the last pixel 0 by a seeded choice among the codes that
    fit: runs of the last pixel (none reaching the row's end, where
    libtiff writes nothing), three 2-bit deltas (the skip code 2 where
    fewer fit), two 3-bit deltas (skip code 4) and raw pixels. Deltas
    wrap modulo 16, as libtiff keeps the low four bits."""
    rng = np.random.default_rng(seed)
    two = {0: 0, 1: 1, 15: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
    out = bytearray()
    for row in np.asarray(img, np.int64):
        last, x, w = 0, 0, len(row)
        while x < w:
            opts = ['raw']
            run = 0
            while x + run < w and row[x + run] == last and run < 63:
                run += 1
            if run and x + run < w:
                opts.append('run')
            d = [(int(v) - last) % 16 for v in row[x:x + 3]]
            k2 = 0
            prev = last
            for v in row[x:x + 3]:
                if (int(v) - prev) % 16 not in two:
                    break
                prev, k2 = int(v), k2 + 1
            if k2:
                opts.append('two')
            if d and d[0] in three:
                opts.append('three')
            pick = opts[rng.integers(len(opts))]
            if pick == 'run':
                out.append(run)
                x += run
            elif pick == 'two':
                codes, prev = [], last
                for v in row[x:x + k2]:
                    codes.append(two[(int(v) - prev) % 16])
                    prev = int(v)
                codes += [2] * (3 - k2)
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                last, x = prev, x + k2
            elif pick == 'three':
                codes, prev = [], last
                for v in row[x:x + 2]:
                    if (int(v) - prev) % 16 not in three:
                        break
                    codes.append(three[(int(v) - prev) % 16])
                    prev = int(v)
                x += len(codes)
                codes += [4] * (2 - len(codes))
                out.append(0x80 | codes[0] << 3 | codes[1])
                last = prev
            else:
                last = int(row[x])
                out.append(0xC0 | last)
                x += 1
    return bytes(out)


def _mh_codes():
    from ..utils import ccitt
    out = []
    for term, makeup in ((ccitt.W_TERM, ccitt.W_MAKEUP),
                         (ccitt.B_TERM, ccitt.B_MAKEUP)):
        out.append((term.split(), makeup.split(), ccitt.EXT_MAKEUP.split()))
    return out


def ccitt_rlew(bits: np.ndarray, odd: int = 0) -> bytes:
    """Word-aligned CCITT RLE (TIFF compression 32771) of (rows, width)
    0/1 pixels (1 black): each row's modified Huffman runs, white first,
    then zero bits up to where libtiff's reader starts the next row
    (``utils/ccitt.py``: its accumulator's bits cut to a multiple of 16,
    and a byte skipped at an odd address; ``odd`` is the parity of the
    data's offset in the file), and two zero bytes at the end (the
    reader's look-ahead past the last row)."""
    tables = _mh_codes()
    out, pos, loaded = [], 0, 0
    for y, row in enumerate(np.asarray(bits, np.uint8)):
        if y:
            held = (loaded * 8 - pos) & ~15
            target = loaded * 8 - held
            if held == 0 and (loaded + odd) & 1:
                loaded += 1
                target = loaded * 8
            out += [0] * (target - pos)
            pos = target
        edges = np.flatnonzero(np.diff(np.concatenate([[0], row, [2]])))
        # a change at 0 where the row starts black: a white run of 0
        runs = np.diff(np.concatenate([[0], edges])).tolist()
        for colour, r in enumerate(runs):
            term, makeup, ext = tables[colour % 2]
            codes = []
            while r >= 2560:
                codes.append(ext[-1])
                r -= 2560
            if r >= 1792:
                codes.append(ext[(r - 1792) // 64])
                r %= 64
            elif r >= 64:
                codes.append(makeup[r // 64 - 1])
                r %= 64
            codes.append(term[r])
            for c in codes:
                loaded = max(loaded, -(-(pos + 12 + colour % 2) // 8))
                out += [int(b) for b in c]
                pos += len(c)
    out += [0] * (-len(out) % 8 + 16)
    return np.packbits(np.asarray(out, np.uint8)).tobytes()


def psd_file(planes: np.ndarray, mode: int, *, bits: int = 8,
             compression: int = 0, colour: bytes = b'', resources=(),
             layers: bytes = b'', version: int = 1) -> bytes:
    """A PSD file of ``planes`` (C, H, W) uint8 channels, each written as
    it is (``bits`` 1: 0/1 pixels, packed a row at a time MSB first;
    16: each value times 257, big-endian), Photoshop ``mode``
    (0 bitmap ... 9 Lab), ``compression`` 0 (raw) or 1 (RLE: every
    channel's row byte counts, then the PackBits rows); ``colour`` the
    colour mode data, ``resources`` (id, data) image resources and
    ``layers`` the layer and mask section's body."""
    planes = np.asarray(planes)
    C, H, W = planes.shape
    if bits == 1:
        rows = [np.packbits(p.astype(np.uint8), axis=1) for p in planes]
    elif bits == 16:
        rows = [(p.astype('>u2') * 257).view(np.uint8).reshape(H, -1)
                for p in planes]
    else:
        rows = [p.astype(np.uint8) for p in planes]
    res = bytearray()
    for rid, data in resources:
        res += b'8BIM' + struct.pack('>HBxI', rid, 0, len(data)) + data + \
            b'\0' * (len(data) & 1)
    out = bytearray(b'8BPS' + struct.pack('>H6xHIIHH', version, C, H, W,
                                          bits, mode))
    out += struct.pack('>I', len(colour)) + colour
    out += struct.pack('>I', len(res)) + res
    out += struct.pack('>I', len(layers)) + layers
    out += struct.pack('>H', compression)
    if compression == 1:
        coded = [[packbits(r.tobytes()) for r in ch] for ch in rows]
        out += b''.join(struct.pack('>H', len(r)) for ch in coded for r in ch)
        out += b''.join(r for ch in coded for r in ch)
    else:
        out += b''.join(ch.tobytes() for ch in rows)
    return bytes(out)
