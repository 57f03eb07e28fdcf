"""Image IO: OpenEXR (float32; read: none, zip, zips and PIZ), PNG
(read and write, without PIL; the rows unfiltered in host C++,
``native/bitmap_png.cpp``), JPEG (read, without PIL: ``utils/jpeg.py``),
PFM, PPM and RGBE, and image resampling. The other
bitmap formats a texture may name are read in ``utils/bmp.py``,
``tga.py``, ``pnm.py``, ``gif.py``, ``tiff.py`` and ``webp.py`` (with
``vp8.py`` and ``vp8l.py``), behind ``texture.read_rgb8``.

Port of ``mitsuba_nlvrl_tpu/utils/io.py`` (pure python, numpy and zlib, so
the port keeps its own copy). The writers and ``resample_image`` take a
numpy array or a tensor on any device: a tensor is copied to the host once
(``host_array``) and written from there. EXR files written here are
standard scanline float32 images readable by any OpenEXR tool.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from .jpeg import read_jpeg  # noqa: F401


def host_array(image) -> np.ndarray:
    """A numpy view of ``image``; a tensor is copied to the host in one
    transfer."""
    if hasattr(image, 'detach'):
        return image.detach().cpu().numpy()
    return np.asarray(image)


# --- EXR --------------------------------------------------------------------

_PIXELTYPE_FLOAT = 2  # 32-bit float


def _exr_attr(name: str, type_: str, data: bytes) -> bytes:
    return name.encode() + b'\x00' + type_.encode() + b'\x00' + \
        struct.pack('<i', len(data)) + data


def write_exr(path: str, image: np.ndarray, channel_names=None) -> None:
    """Write (H, W, C) float32 as an uncompressed scanline EXR."""
    image = np.asarray(host_array(image), np.float32)
    if image.ndim == 2:
        image = image[:, :, None]
    H, W, C = image.shape
    if channel_names is None:
        channel_names = {1: ['Y'], 3: ['R', 'G', 'B'],
                         4: ['R', 'G', 'B', 'A']}.get(C) or \
            [f'ch{i:02d}' for i in range(C)]
    # channels must be stored alphabetically
    order = sorted(range(C), key=lambda i: channel_names[i])

    chan_data = b''
    for i in order:
        chan_data += channel_names[i].encode() + b'\x00' + \
            struct.pack('<iiii', _PIXELTYPE_FLOAT, 0, 1, 1)
    chan_data += b'\x00'

    header = b''
    header += _exr_attr('channels', 'chlist', chan_data)
    header += _exr_attr('compression', 'compression', b'\x00')  # none
    box = struct.pack('<iiii', 0, 0, W - 1, H - 1)
    header += _exr_attr('dataWindow', 'box2i', box)
    header += _exr_attr('displayWindow', 'box2i', box)
    header += _exr_attr('lineOrder', 'lineOrder', b'\x00')
    header += _exr_attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
    header += _exr_attr('screenWindowCenter', 'v2f', struct.pack('<ff', 0, 0))
    header += _exr_attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
    header += b'\x00'

    magic = struct.pack('<i', 20000630) + struct.pack('<i', 2)
    offset_table_pos = len(magic) + len(header)
    data_start = offset_table_pos + 8 * H

    scanline_size = 8 + W * 4 * C
    offsets = b''.join(struct.pack('<Q', data_start + y * scanline_size)
                       for y in range(H))

    with open(path, 'wb') as f:
        f.write(magic)
        f.write(header)
        f.write(offsets)
        for y in range(H):
            f.write(struct.pack('<ii', y, W * 4 * C))
            row = np.concatenate([image[y, :, i] for i in order])
            f.write(row.astype('<f4').tobytes())


def read_exr(path: str) -> Tuple[np.ndarray, list]:
    """Minimal scanline EXR reader (none/zip/zips compression, float32/half).
    Returns (H, W, C) float32 and channel names (alphabetical order)."""
    with open(path, 'rb') as f:
        data = f.read()
    magic, version = struct.unpack_from('<ii', data, 0)
    if magic != 20000630:
        raise ValueError(f"{path}: not an EXR")
    pos = 8
    attrs: Dict[str, tuple] = {}
    while data[pos] != 0:
        e = data.index(b'\x00', pos); name = data[pos:e].decode(); pos = e + 1
        e = data.index(b'\x00', pos); atype = data[pos:e].decode(); pos = e + 1
        (size,) = struct.unpack_from('<i', data, pos); pos += 4
        attrs[name] = (atype, data[pos:pos + size]); pos += size
    pos += 1
    # channels
    chans = []
    cdata = attrs['channels'][1]
    cpos = 0
    while cdata[cpos] != 0:
        e = cdata.index(b'\x00', cpos)
        cname = cdata[cpos:e].decode(); cpos = e + 1
        ptype, = struct.unpack_from('<i', cdata, cpos); cpos += 16
        chans.append((cname, ptype))
    comp = attrs['compression'][1][0]
    x0, y0, x1, y1 = struct.unpack('<iiii', attrs['dataWindow'][1])
    W, H = x1 - x0 + 1, y1 - y0 + 1
    C = len(chans)
    lines_per_block = {0: 1, 2: 1, 3: 16, 4: 32}.get(comp)
    if lines_per_block is None:
        raise ValueError(f"{path}: unsupported compression {comp}")
    nblocks = -(-H // lines_per_block)
    pos += 8 * nblocks  # skip offset table
    out = np.zeros((H, W, C), np.float32)
    dtypes = {1: np.dtype('<u4'), 2: np.dtype('<f4'), 0: np.dtype('<u4')}
    for _ in range(nblocks):
        y, size = struct.unpack_from('<ii', data, pos); pos += 8
        block = data[pos:pos + size]; pos += size
        ny = min(lines_per_block, H - (y - y0))
        raw_size = sum(W * (2 if pt == 1 else 4) for _, pt in chans) * ny
        if comp == 4:  # PIZ
            from .exr_piz import piz_uncompress
            per_chan = piz_uncompress(block, chans, W, ny)
            for ci, (cname, ptype) in enumerate(chans):
                rows = per_chan[cname]
                if ptype == 1:   # half
                    vals = rows.view(np.uint16).astype('<u2').view('<f2')
                    out[y - y0:y - y0 + ny, :, ci] = vals.astype(np.float32)
                else:            # float: two uint16 halves per value
                    b = rows.reshape(ny, W, 2).astype('<u2')
                    fl = (b[..., 0].astype(np.uint32) << 16) \
                        | b[..., 1].astype(np.uint32)
                    out[y - y0:y - y0 + ny, :, ci] = fl.view(np.float32)
            continue
        if comp in (2, 3) and size < raw_size:
            # exr zip predictor: delta + interleave
            raw = _exr_unpredict(np.frombuffer(zlib.decompress(block),
                                               np.uint8))
        else:
            raw = np.frombuffer(block, np.uint8)
        rpos = 0
        for line in range(ny):
            for ci, (cname, ptype) in enumerate(chans):
                esize = 2 if ptype == 1 else 4
                n = W * esize
                buf = raw[rpos:rpos + n]; rpos += n
                if ptype == 1:  # half
                    vals = np.frombuffer(buf.tobytes(), '<f2').astype(np.float32)
                else:
                    vals = np.frombuffer(buf.tobytes(), '<f4')
                out[y - y0 + line, :, ci] = vals
    return out, [c for c, _ in chans]


def _exr_unpredict(d: np.ndarray) -> np.ndarray:
    """Undo EXR zip predictor: running delta then de-interleave halves."""
    d = d.astype(np.uint8).copy()
    # reference algorithm: t[i] += t[i-1] - 128
    acc = np.cumsum(d.astype(np.int64))
    acc = acc - 128 * np.arange(len(d))
    t = (acc % 256).astype(np.uint8)
    half = (len(t) + 1) // 2
    out = np.empty_like(t)
    out[0::2] = t[:half]
    out[1::2] = t[half:len(t)]
    return out


# --- PNG --------------------------------------------------------------------

def write_png(path: str, image: np.ndarray, gamma: bool = True) -> None:
    """Write (H, W, 3) image; float inputs are tonemapped (sRGB) to 8-bit."""
    img = host_array(image)
    if img.dtype != np.uint8:
        x = np.clip(img, 0.0, 1.0)
        if gamma:
            x = np.where(x <= 0.0031308, 12.92 * x,
                         1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)
        img = (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, 2)
    H, W, C = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[C]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        c = struct.pack('>I', len(payload)) + tag + payload
        return c + struct.pack('>I', zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack('>IIBBBBB', W, H, 8, ctype, 0, 0, 0)
    raw = b''.join(b'\x00' + img[y].tobytes() for y in range(H))
    f = path if hasattr(path, 'write') else open(path, 'wb')
    try:
        f.write(b'\x89PNG\r\n\x1a\n')
        f.write(chunk(b'IHDR', ihdr))
        f.write(chunk(b'IDAT', zlib.compress(raw, 6)))
        f.write(chunk(b'IEND', b''))
    finally:
        if f is not path:
            f.close()


def _png_unfilter(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (none, sub, up, average, paeth) of a
    non-interlaced PNG, or of one pass of an interlaced one: (H, stride)
    uint8, in ``native/bitmap_png.cpp``. Fails as ``_png_unfilter_plain``
    does."""
    from ..native import bitmap_library, ptr
    out = np.empty((H, stride), np.uint8)
    buf = np.frombuffer(raw, np.uint8)
    bad = np.zeros(1, np.int64)
    err = bitmap_library().mnt_png_unfilter(ptr(buf), buf.size, H, stride,
                                            bpp, ptr(out), ptr(bad))
    if err == 1:
        raise IndexError("index out of range")
    if err == 2:
        raise ValueError("buffer is smaller than requested size")
    if err == 3:
        raise ValueError(f"PNG row filter {int(bad[0])}")
    return out


def _png_unfilter_plain(raw: bytes, H: int, stride: int,
                        bpp: int) -> np.ndarray:
    """``_png_unfilter`` in numpy and Python, the plain version the tests
    hold it to (a row that averages or Paeth-predicts is walked byte by
    byte)."""
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    pos = 0
    for y in range(H):
        ftype = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += stride + 1
        if ftype == 0:
            cur = row
        elif ftype == 1:        # sub: a running sum along each byte lane
            pad = -stride % bpp
            lanes = np.concatenate([row, np.zeros(pad, np.int64)]
                                   ).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).reshape(-1)[:stride]
        elif ftype == 2:
            cur = (row + prior) & 0xFF
        elif ftype in (3, 4):   # average, paeth: a byte needs its left one
            r, b = row.tolist(), prior.tolist()
            c = [0] * stride
            for i in range(stride):
                left = c[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    c[i] = (r[i] + ((left + b[i]) >> 1)) & 0xFF
                    continue
                ul = b[i - bpp] if i >= bpp else 0
                p_ = left + b[i] - ul
                pa, pb, pc = abs(p_ - left), abs(p_ - b[i]), abs(p_ - ul)
                pred = left if pa <= pb and pa <= pc else \
                    (b[i] if pb <= pc else ul)
                c[i] = (r[i] + pred) & 0xFF
            cur = np.asarray(c, np.int64)
        else:
            raise ValueError(f"PNG row filter {ftype}")
        out[y] = cur
        prior = cur
    return out


# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(rows: np.ndarray, W: int, depth: int, ctype: int,
                 chans: int) -> np.ndarray:
    """The (H, W, chans) samples of unfiltered rows (H, stride): uint16 at
    16 bits, else uint8; grey of 1, 2 or 4 bits widened to 8."""
    H = rows.shape[0]
    if depth == 16:
        return rows.view('>u2').astype(np.uint16).reshape(H, W, chans)
    if depth == 8:
        return rows.reshape(H, W, chans)
    per = 8 // depth       # 1, 2 or 4 bits a sample: grey or palette indices
    shifts = np.arange(per - 1, -1, -1) * depth
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    img = samples.reshape(H, -1)[:, :W, None].astype(np.uint8)
    if ctype == 0:      # widen grey to 8 bits, as decoders do
        img = (img.astype(np.uint16) * (255 // ((1 << depth) - 1))
               ).astype(np.uint8)
    return img


def read_png(path: str) -> np.ndarray:
    """Read a PNG file to its samples (``decode_png``)."""
    with open(path, 'rb') as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = '<bytes>') -> np.ndarray:
    """A PNG's bytes (a file's, or an icon's inside ICO or ICNS; ``path``
    names them in errors) to its samples, (H, W, C) uint8 or uint16 (C: 1
    grey, 2 grey and alpha, 3 RGB, 4 RGBA). Palette images expand to RGB,
    or to RGBA when they carry transparency; grey and palette images of 1,
    2 or 4 bits widen to 8. An Adam7-interlaced file is decoded pass by
    pass: each pass unfiltered with its own row stride (a pass that holds
    no pixel of a small image has no rows) and its pixels scattered into
    the image (a plain file is one pass of the whole image). Needs zlib,
    numpy and the native bitmap library (``_png_unfilter``)."""
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, plte, trns = 8, [], None, None
    while pos < len(data):
        n, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b'IHDR':
            W, H, depth, ctype, _, _, interlace = struct.unpack('>IIBBBBB',
                                                                body)
        elif tag == b'PLTE':
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b'tRNS':
            trns = body
        elif tag == b'IDAT':
            idat.append(body)
        elif tag == b'IEND':
            break
    if interlace not in (0, 1):
        raise ValueError(f"{path}: PNG interlace method {interlace}")
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bits = chans * depth
    bpp = max(1, bits // 8)
    raw = zlib.decompress(b''.join(idat))
    img = np.zeros((H, W, chans), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits + 7) // 8
        rows = _png_unfilter(raw[pos:pos + ph * (stride + 1)], ph, stride,
                             bpp)
        pos += ph * (stride + 1)
        img[y0::dy, x0::dx] = _png_samples(rows, pw, depth, ctype, chans)
    if ctype == 3:
        idx = img[..., 0]
        rgb = plte[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    return img


# --- PFM / PPM / RGBE -------------------------------------------------------
# The remaining bitmap formats of the reference's IO layer
# (src/libcore/bitmap.cpp). RGBE follows Ward's shared-exponent encoding.

def write_pfm(path: str, image: np.ndarray) -> None:
    """Portable FloatMap: 'PF' color / 'Pf' gray, bottom-up rows,
    little-endian (negative scale)."""
    img = np.asarray(host_array(image), np.float32)
    color = img.ndim == 3 and img.shape[2] >= 3
    if color:
        img = img[:, :, :3]
    H, W = img.shape[:2]
    with open(path, 'wb') as f:
        f.write(b'PF\n' if color else b'Pf\n')
        f.write(f'{W} {H}\n-1.0\n'.encode())
        f.write(np.ascontiguousarray(img[::-1]).tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        color = magic == b'PF'
        if magic not in (b'PF', b'Pf'):
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().split()
        W, H = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        dt = '<f4' if scale < 0 else '>f4'
        n = W * H * (3 if color else 1)
        img = np.frombuffer(f.read(4 * n), dt, n).astype(np.float32)
    img = img.reshape(H, W, 3) if color else img.reshape(H, W)
    img = img[::-1]  # bottom-up storage
    if abs(scale) not in (0.0, 1.0):
        img = img * abs(scale)
    return np.ascontiguousarray(img)


def write_ppm(path: str, image: np.ndarray, gamma: bool = True) -> None:
    """Binary P6; float input is sRGB-tonemapped to 8 bit like write_png."""
    img = host_array(image)
    if img.dtype != np.uint8:
        x = np.clip(img, 0.0, 1.0)
        if gamma:
            x = np.where(x <= 0.0031308, 12.92 * x,
                         1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4)
                         - 0.055)
        img = (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, 2)
    H, W = img.shape[:2]
    with open(path, 'wb') as f:
        f.write(f'P6\n{W} {H}\n255\n'.encode())
        f.write(np.ascontiguousarray(img[:, :, :3]).tobytes())


def read_ppm(path: str) -> np.ndarray:
    """P6 (and P5 gray) -> uint8 array."""
    with open(path, 'rb') as f:
        data = f.read()
    # header: magic, W, H, maxval separated by whitespace (skip comments)
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b'#':
            pos = data.index(b'\n', pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        tokens.append(data[pos:end])
        pos = end
    pos += 1  # single whitespace after maxval
    magic, W, H = tokens[0], int(tokens[1]), int(tokens[2])
    C = {b'P6': 3, b'P5': 1}[magic]
    img = np.frombuffer(data, np.uint8, W * H * C, pos).reshape(H, W, C)
    return img[:, :, 0] if C == 1 else img


def write_rgbe(path: str, image: np.ndarray) -> None:
    """Radiance HDR (.hdr/.rgbe): shared-exponent RGBE, flat scanlines."""
    img = np.asarray(host_array(image), np.float32)[:, :, :3]
    H, W = img.shape[:2]
    mx = img.max(axis=2)
    e = np.zeros((H, W), np.int32)
    nz = mx >= 1e-32
    m, e_nz = np.frexp(np.where(nz, mx, 1.0))
    scale = np.where(nz, m * 256.0 / np.where(nz, mx, 1.0), 0.0)
    rgbe = np.zeros((H, W, 4), np.uint8)
    rgbe[:, :, :3] = np.clip(img * scale[:, :, None], 0, 255).astype(np.uint8)
    rgbe[:, :, 3] = np.where(nz, e_nz + 128, 0).astype(np.uint8)
    with open(path, 'wb') as f:
        f.write(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n')
        f.write(f'-Y {H} +X {W}\n'.encode())
        f.write(rgbe.tobytes())


def read_rgbe(path: str) -> np.ndarray:
    """Radiance HDR reader: flat and RLE scanlines -> float32 (H, W, 3)."""
    with open(path, 'rb') as f:
        if not f.readline().startswith(b'#?'):
            raise ValueError(f"{path}: not a Radiance HDR file")
        while True:
            line = f.readline()
            if line.strip() == b'':
                break
        dims = f.readline().split()
        H, W = int(dims[1]), int(dims[3])
        data = f.read()
    rgbe = np.zeros((H, W, 4), np.uint8)
    pos = 0
    for y in range(H):
        if W >= 8 and W < 32768 and data[pos] == 2 and data[pos + 1] == 2:
            # adaptive RLE scanline: 4 component streams
            pos += 4
            for c in range(4):
                x = 0
                while x < W:
                    cnt = data[pos]
                    if cnt > 128:  # run
                        rgbe[y, x:x + cnt - 128, c] = data[pos + 1]
                        x += cnt - 128
                        pos += 2
                    else:          # literal
                        rgbe[y, x:x + cnt, c] = np.frombuffer(
                            data, np.uint8, cnt, pos + 1)
                        x += cnt
                        pos += 1 + cnt
        else:
            row = np.frombuffer(data, np.uint8, 4 * W, pos).reshape(W, 4)
            rgbe[y] = row
            pos += 4 * W
    e = rgbe[:, :, 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (rgbe[:, :, :3].astype(np.float32) * scale[:, :, None]) \
        .astype(np.float32)


# --- image resampling (reference Resampler, include/mitsuba/core/rfilter.h:90)

_FILTER_RADII = {'box': 0.5, 'tent': 1.0, 'gaussian': 2.0,
                 'mitchell': 2.0, 'catmullrom': 2.0, 'lanczos': 3.0}


def _rfilter_eval(name: str, x: np.ndarray) -> np.ndarray:
    """Numpy twin of the film's 1-d reconstruction filters."""
    ax = np.abs(x)
    if name == 'box':
        return np.where(ax <= 0.5, 1.0, 0.0)
    if name == 'tent':
        return np.maximum(0.0, 1.0 - ax)
    if name == 'gaussian':
        std = 0.5
        alpha = -1.0 / (2.0 * std * std)
        r = _FILTER_RADII['gaussian']
        return np.maximum(0.0, np.exp(alpha * ax * ax)
                          - np.exp(alpha * r * r))
    if name in ('mitchell', 'catmullrom'):
        B = C = 1.0 / 3.0
        if name == 'catmullrom':
            B, C = 0.0, 0.5
        x2, x3 = ax * ax, ax ** 3
        y1 = ((12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2
              + (6 - 2 * B)) / 6.0
        y2 = ((-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
              + (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) / 6.0
        return np.where(ax < 1.0, y1, np.where(ax < 2.0, y2, 0.0))
    if name == 'lanczos':
        tau = 3.0
        return np.where(ax < tau, np.sinc(ax) * np.sinc(ax / tau), 0.0)
    raise ValueError(f"unknown rfilter '{name}'")


def _resample_matrix(src: int, dst: int, rfilter: str, boundary: str
                     ) -> np.ndarray:
    """(dst, src) weight matrix of the reference Resampler
    (rfilter.h:107-214): filter scaled by src/dst when minifying, taps
    centered on output-sample positions, per-row normalization, boundary
    handling by index folding (clamp / wrap / mirror) or dropping (zero)."""
    radius = _FILTER_RADII[rfilter]
    scale = max(src / dst, 1.0)                  # low-pass when minifying
    fr = radius * scale
    taps = int(np.ceil(fr * 2))
    if src == dst and taps % 2 != 1:
        taps -= 1
    if radius < 1.0:
        taps = min(taps, src)
    W = np.zeros((dst, src), np.float64)
    if src == dst:                               # filtering mode
        half = taps // 2
        w = _rfilter_eval(rfilter, np.arange(taps) - half)
        idx0 = np.arange(dst)[:, None] - half + np.arange(taps)[None, :]
        w = np.broadcast_to(w, (dst, taps))
    else:                                        # resampling mode
        center = (np.arange(dst) + 0.5) / dst * src
        start = np.floor(center - fr + 0.5).astype(np.int64)
        j = np.arange(taps)
        pos = start[:, None] + j[None, :] + 0.5 - center[:, None]
        w = _rfilter_eval(rfilter, pos / scale)
        idx0 = start[:, None] + j[None, :]
    if boundary == 'clamp':
        idx = np.clip(idx0, 0, src - 1)
    elif boundary == 'wrap':
        idx = np.mod(idx0, src)
    elif boundary == 'mirror':
        period = max(2 * src - 2, 1)
        idx = np.abs(np.mod(idx0, period))
        idx = np.where(idx >= src, period - idx, idx)
    elif boundary == 'zero':
        idx = np.clip(idx0, 0, src - 1)
        w = np.where((idx0 < 0) | (idx0 >= src), 0.0, w)
    else:
        raise ValueError(f"unknown boundary '{boundary}'")
    rows = np.repeat(np.arange(dst), taps)
    np.add.at(W, (rows, idx.ravel()), w.ravel())
    norm = W.sum(1, keepdims=True)
    if np.any(norm == 0):
        raise ValueError("Resampler: filter footprint too small, some "
                         "output samples have empty support")
    return W / norm


def resample_image(image: np.ndarray, size, rfilter: str = 'lanczos',
                   boundary: str = 'clamp',
                   clamp_range=(-np.inf, np.inf)) -> np.ndarray:
    """Separable image resampling (reference Bitmap::resample,
    src/libcore/bitmap.cpp, built on Resampler rows/columns).

    image: (H, W) or (H, W, C). size: (new_W, new_H). boundary:
    clamp | wrap | mirror | zero. clamp_range bounds ringing of
    negative-lobe filters (bitmap.cpp clamps to the valid range)."""
    img = np.asarray(host_array(image), np.float64)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    H, W = img.shape[:2]
    new_w, new_h = int(size[0]), int(size[1])
    if new_w != W:
        Wx = _resample_matrix(W, new_w, rfilter, boundary)
        img = np.einsum('tw,hwc->htc', Wx, img)
    if new_h != H:
        Wy = _resample_matrix(H, new_h, rfilter, boundary)
        img = np.einsum('th,hwc->twc', Wy, img)
    img = np.clip(img, clamp_range[0], clamp_range[1])
    out = img.astype(np.float32)
    return out[:, :, 0] if squeeze else out
