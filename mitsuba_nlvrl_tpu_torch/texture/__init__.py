"""Textures: bitmap, checkerboard, constant, grid3d, constant3d and
mesh_attribute.

Port of ``mitsuba_nlvrl_tpu/texture/__init__.py``: per-lane texture ids
gather from a stack of bitmaps padded to the largest one (bilinear,
wrapping in u); checkerboards and constants evaluate procedurally;
``grid3d`` trilerps a volume at the world hit position; ``mesh_attribute``
interpolates the per-corner colours of the hit triangle. ``pack`` (host
side) makes a texture's row and loads its bitmap or volume.

Bitmaps load without PIL: EXR by suffix through ``utils/io.read_exr``;
any other file identified by content in PIL's order (``identify``) and
decoded by the port's own PNG, JPEG, BMP, GIF, TIFF, PNM, TGA, WebP, DDS,
QOI, SGI, PCX, JPEG 2000, ICO, CUR, ICNS, PSD, Sun raster, BLP, FTEX,
FITS, SPIDER, IM, IMT, MSP, FLI/FLC, XBM, XPM, GBR, McIDAS, PIXAR, XV
thumbnail, Photo CD, DCX and IPTC readers (``utils/``) to the bytes of
PIL's ``convert('RGB')``; BUFR, GRIB, HDF5, MPEG, EPS and WMF raise as PIL
raises (it opens them and cannot load them). AVIF, the one format PIL
opens that the port does not read, raises, naming its ROADMAP entry.
Lanes whose row is not a bitmap or a volume read a clamped, valid index
(the reference relies on JAX clamping there); their value is masked out.
"""
from __future__ import annotations

import importlib
from typing import Tuple

import numpy as np
import torch

from ..scene.types import TEXTURE_TYPES, TEX_NPARAM, not_in_slice


def _pil_rgb(mode: str, px: np.ndarray, palette=None) -> np.ndarray:
    """The 8-bit RGB that PIL's ``Image.convert('RGB')`` makes of an
    image PIL holds in ``mode`` (the decoders return it so): grey (``1``,
    ``L``, ``LA``) replicated; ``P`` and ``PA`` through the palette (an
    index past its end reads black, as in PIL, and every index of an
    image without one); the integer modes (``I``, ``I;16``, ``I;16L``,
    ``I;16B``) clipped to 0..255; ``F`` clipped, then truncated; alpha
    and padding dropped; ``CMYK`` by PIL's integer formula (each of C, M,
    Y times 255 - K, over 255); ``LAB`` (PIL's bytes: L, then a* and b*
    offset by 128) as PIL's LittleCMS transform from its Lab profile to
    sRGB converts it (``utils/lab.py``); ``YCbCr`` through PIL's integer
    tables (``utils/ycbcr.py``)."""
    if mode == 'LAB':
        from ..utils.lab import lab_to_rgb
        return lab_to_rgb(px)
    if mode == 'YCbCr':
        from ..utils.ycbcr import ycbcr_to_rgb
        return ycbcr_to_rgb(px)
    if mode in ('P', 'PA'):
        idx = px if px.ndim == 2 else px[..., 0]
        if palette is None:                      # PIL's default: none
            palette = np.zeros((0, 3), np.uint8)
        pal = np.zeros((256, 3), np.uint8)
        n = min(len(palette), 256)
        pal[:n] = palette[:n, :3]
        return pal[idx]
    if mode == 'CMYK':
        c = px.astype(np.int64)
        nk = 255 - c[..., 3:]
        t = c[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    if mode in ('I', 'I;16', 'I;16L', 'I;16B'):
        grey = np.clip(px, 0, 255).astype(np.uint8)
    elif mode == 'F':
        grey = np.clip(np.nan_to_num(px, nan=0.0), 0, 255).astype(np.uint8)
    elif mode in ('1', 'L', 'LA'):
        grey = px if px.ndim == 2 else px[..., 0]
    else:                                        # RGB, RGBA, RGBX
        return np.ascontiguousarray(px[..., :3], np.uint8)
    return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=-1)


def _png_mode(img: np.ndarray):
    """A PNG's samples (``utils/io.read_png``) as PIL opens them: 16-bit
    grey as ``I`` (32-bit integers), 16-bit colour and grey-alpha cut to
    their high byte."""
    c = img.shape[-1]
    if img.dtype == np.uint16:
        if c == 1:
            return 'I', img[..., 0].astype(np.int32)
        img = (img >> 8).astype(np.uint8)
    return {1: 'L', 2: 'LA', 3: 'RGB', 4: 'RGBA'}[c], \
        img[..., 0] if c == 1 else img


# The formats PIL's ``Image.open`` tries, in its order: the five plugins
# it loads first, then the rest as PIL registers them. Each row: name and
# its test on the file's head (PIL's ``_accept``; ``None``: TGA, which has
# no test, and its header check stands in; an ``_Opens``: a plugin PIL
# tries by opening the file, whose open's checks stand in). PIL's DIB is
# a BMP without its file header.
def _u32(p: bytes, big: bool = False) -> int:
    return int.from_bytes(p[:4].ljust(4, b'\0'), 'big' if big else 'little')


def _gbr_opens(p: bytes) -> bool:
    """PIL's GBR test and then its header checks (PIL tries the plugin's
    open, and a file that fails them goes on to the plugins after it, as
    a 1- or 2-pixel-wide QOI file does)."""
    if len(p) < 20 or _u32(p, True) < 20 or _u32(p[4:], True) not in (1, 2):
        return False
    if _u32(p[8:], True) == 0 or _u32(p[12:], True) == 0 or \
            _u32(p[16:], True) not in (1, 4):
        return False
    return _u32(p[4:], True) == 1 or (p[20:24] == b'GIMP' and len(p) >= 28)


class _Opens:
    """A plugin PIL tries by opening the file: ``utils.<module>.opens``
    (path, head) says whether its open gets past its checks."""

    def __init__(self, module: str):
        self.module = module

    def __call__(self, path: str, head: bytes) -> bool:
        return importlib.import_module(f'..utils.{self.module}',
                                       __package__).opens(path, head)


def _mpeg_opens(p: bytes) -> bool:
    """PIL's MPEG test, then its open's: 12-bit width and height both
    nonzero."""
    if p[:4] != b'\0\0\1\xb3' or len(p) < 7:
        return False
    bits = int.from_bytes(p[4:7], 'big')
    return bits >> 12 > 0 and bits & 0xFFF > 0


_OPEN_ORDER = [
    ('BMP', lambda p: p[:2] == b'BM'),
    ('DIB', lambda p: _u32(p) in (12, 40, 52, 56, 64, 108, 124)),
    ('GIF', lambda p: p[:6] in (b'GIF87a', b'GIF89a')),
    ('JPEG', lambda p: p[:3] == b'\xff\xd8\xff'),
    ('PPM', lambda p: p[:1] == b'P' and p[1:2] != b'' and
     p[1] in b'0123456fy'),
    ('PNG', lambda p: p[:8] == b'\x89PNG\r\n\x1a\n'),
    ('AVIF', lambda p: p[4:8] == b'ftyp' and p[8:12] in (
        b'avif', b'avis', b'mif1', b'msf1')),
    ('BLP', lambda p: p[:4] in (b'BLP1', b'BLP2')),
    ('BUFR', lambda p: p[:4] in (b'BUFR', b'ZCZC')),
    ('CUR', lambda p: p[:4] == b'\0\0\2\0' and
     int.from_bytes(p[4:6], 'little') > 0),
    ('PCX', lambda p: p[:1] == b'\n' and p[1:2] in
     (b'\0', b'\2', b'\3', b'\5')),
    ('DCX', lambda p: _u32(p) == 987654321),
    ('DDS', lambda p: p[:4] == b'DDS '),
    ('EPS', lambda p: p[:4] == b'%!PS' or _u32(p) == 0xC6D3D0C5),
    ('FITS', lambda p: p[:6] == b'SIMPLE'),
    ('FLI', lambda p: len(p) >= 16 and int.from_bytes(p[4:6], 'little') in
     (0xAF11, 0xAF12) and int.from_bytes(p[14:16], 'little') in (0, 3)),
    ('FTEX', lambda p: p[:4] == b'FTEX'),
    ('GBR', lambda p: _gbr_opens(p)),
    ('GRIB', lambda p: p[:4] == b'GRIB' and p[7:8] == b'\1'),
    ('HDF5', lambda p: p[:8] == b'\x89HDF\r\n\x1a\n'),
    ('JPEG2000', lambda p: p[:4] == b'\xffO\xffQ' or
     p[:12] == b'\0\0\0\x0cjP  \r\n\x87\n'),
    ('ICNS', lambda p: p[:4] == b'icns'),
    ('ICO', lambda p: p[:4] == b'\0\0\1\0'),
    ('IM', _Opens('im')),
    ('IMT', _Opens('imt')),
    ('IPTC', _Opens('iptc')),
    ('MCIDAS', lambda p: p[:8] == b'\0\0\0\0\0\0\0\4'),
    ('MPEG', _mpeg_opens),
    ('TIFF', lambda p: p[:4] in (b'MM\0*', b'II*\0', b'MM*\0', b'II\0*',
                                 b'MM\0+', b'II+\0')),
    ('MSP', lambda p: p[:4] in (b'DanM', b'LinS')),
    ('PCD', _Opens('pcd')),
    ('PIXAR', lambda p: p[:4] == b'\x80\xe8\0\0'),
    ('PSD', lambda p: p[:4] == b'8BPS'),
    ('QOI', lambda p: p[:4] == b'qoif'),
    ('SGI', lambda p: p[:2] == b'\x01\xda'),
    ('SPIDER', _Opens('spider')),
    ('SUN', lambda p: _u32(p, True) == 0x59A66A95),
    ('TGA', None),
    ('WEBP', lambda p: p[:4] == b'RIFF' and p[8:12] == b'WEBP' and
     p[12:16] in (b'VP8 ', b'VP8X', b'VP8L')),
    ('WMF', lambda p: p[:6] == b'\xd7\xcd\xc6\x9a\0\0' or
     p[:4] == b'\1\0\0\0'),
    ('XBM', lambda p: p.lstrip()[:7] == b'#define'),
    ('XPM', lambda p: p[:9] == b'/* XPM */'),
    ('XVThumb', lambda p: p[:6] == b'P7 332'),
]


def identify(path: str) -> str:
    """The format PIL's ``Image.open`` finds for the file, by content:
    the first plugin in PIL's order whose test passes (for GBR and MPEG,
    also the header checks their opens make before PIL moves on). Raises
    ``OSError`` (PIL's ``UnidentifiedImageError`` is one) when none does.
    TGA, which has no signature, is tried where PIL tries it, by its
    header checks; IM, IMT, IPTC, PCD and SPIDER, which PIL tries by
    opening them, by their opens' checks (``utils/im.py``, ``imt.py``,
    ``iptc.py``, ``pcd.py``, ``spider.py``; the first 4 KiB of the file,
    all of it where an IM, IMT or IPTC header needs it). The names are
    PIL's formats: ``_READERS`` maps those the port decodes besides PNG
    (``JPEG2000`` for JP2 files and raw codestreams, ``ICO``, ``CUR``,
    ``ICNS`` among them; ``PSD`` for Photoshop files, ``XVThumb`` for XV
    thumbnails) and ``_STUBS`` the six PIL opens and cannot load."""
    from ..utils.tga import is_tga
    with open(path, 'rb') as f:
        head = f.read(4096)
    for name, accept in _OPEN_ORDER:
        if isinstance(accept, _Opens):
            if accept(path, head):
                return name
        elif accept(head) if accept else is_tga(head):
            return name
    raise OSError(f"cannot identify image file '{path}'")


# the port's decoder of each format it reads: (module of utils, function),
# each returning (mode, pixels, palette) as PIL opens the file
_READERS = {'JPEG': ('jpeg', 'read_jpeg_mode'), 'BMP': ('bmp', 'read_bmp'),
            'DIB': ('bmp', 'read_bmp'), 'GIF': ('gif', 'read_gif'),
            'PPM': ('pnm', 'read_pnm'), 'TIFF': ('tiff', 'read_tiff'),
            'TGA': ('tga', 'read_tga'), 'WEBP': ('webp', 'read_webp'),
            'DDS': ('dds', 'read_dds'), 'QOI': ('qoi', 'read_qoi'),
            'SGI': ('sgi', 'read_sgi'), 'PCX': ('pcx', 'read_pcx'),
            'JPEG2000': ('jp2', 'read_jpeg2000'), 'ICO': ('ico', 'read_ico'),
            'CUR': ('ico', 'read_cur'), 'ICNS': ('icns', 'read_icns'),
            'PSD': ('psd', 'read_psd'), 'SUN': ('sun', 'read_sun'),
            'BLP': ('blp', 'read_blp'), 'FTEX': ('ftex', 'read_ftex'),
            'FITS': ('fits', 'read_fits'),
            'SPIDER': ('spider', 'read_spider'), 'IM': ('im', 'read_im'),
            'IMT': ('imt', 'read_imt'), 'MSP': ('msp', 'read_msp'),
            'FLI': ('fli', 'read_fli'), 'XBM': ('xbm', 'read_xbm'),
            'XPM': ('xpm', 'read_xpm'), 'GBR': ('gbr', 'read_gbr'),
            'MCIDAS': ('mcidas', 'read_mcidas'),
            'PIXAR': ('pixar', 'read_pixar'),
            'XVThumb': ('xvthumb', 'read_xvthumb'),
            'PCD': ('pcd', 'read_pcd'), 'DCX': ('dcx', 'read_dcx'),
            'IPTC': ('iptc', 'read_iptc')}
# the formats PIL opens and cannot load here: each raises PIL's error
_STUBS = {'BUFR': ('stubs', 'read_bufr'), 'GRIB': ('stubs', 'read_grib'),
          'HDF5': ('stubs', 'read_hdf5'), 'MPEG': ('stubs', 'read_mpeg'),
          'EPS': ('stubs', 'read_eps'), 'WMF': ('stubs', 'read_wmf')}


def _decode(path: str):
    """(mode, pixels, palette) of a bitmap file as PIL opens it."""
    fmt = identify(path)
    if fmt == 'PNG':
        from ..utils.io import read_png
        return _png_mode(read_png(path)) + (None,)
    reader = _READERS.get(fmt) or _STUBS.get(fmt)
    if reader is None:
        raise not_in_slice(f"bitmap '{path}' ({fmt})",
                           "item 12.7 (other bitmap formats)")
    module, fn = reader
    return getattr(importlib.import_module(f'..utils.{module}',
                                           __package__), fn)(path)


def read_rgb8(path: str) -> np.ndarray:
    """A bitmap file as PIL's ``Image.open(path).convert('RGB')`` gives
    it: (H, W, 3) uint8."""
    return _pil_rgb(*_decode(path))


def load_bitmap(path: str, gamma: bool = True) -> np.ndarray:
    """Load an image file to linear float32 (H, W, 3). EXR by its suffix;
    any other file by its content, as PIL identifies it. PNG, JPEG
    (baseline, progressive, lossless; grey, YCbCr, RGB, CMYK, YCCK), BMP,
    GIF, PNM, TGA, WebP, TIFF (strips and tiles, every orientation; every
    compression of PIL's table: none, LZW, Deflate, PackBits, LZMA,
    Zstandard, CCITT RLE and its word-aligned form, G3 and G4,
    ThunderScan, JPEG in one plane or in planes and old-style JPEG, with
    SGILog and WebP refused as PIL refuses them; bilevel, grey to 32 bits
    and 12-bit, palette, RGB, CMYK, CIELab and YCbCr), DDS
    (uncompressed, BC1-BC7), QOI, SGI, PCX, JPEG 2000 (JP2 and raw
    codestreams: both wavelets, layers, tiles, offsets, every
    progression, the colour transforms, 1 to 16 bits, palettes), ICO and
    CUR (PNG and BMP icons), ICNS (PNG, JPEG 2000 and the RLE icons),
    PSD (the composite image of every mode PIL opens, raw and RLE), Sun
    raster (1 to 32 bits, raw and RLE, colour maps), BLP (BLP1 JPEG and
    palettes, BLP2 palettes and DXT1/3/5), FTEX (DXT1 and RGB), FITS
    (BITPIX 8 to -64, ``GZIP_1`` tiles), SPIDER (both byte orders,
    stacks), IM (every image type of PIL's table, LUTs, planar RGB), IMT,
    MSP (versions 1 and 2), FLI/FLC (the first frame's chunks), XBM, XPM,
    GBR, McIDAS, PIXAR, XV thumbnails, Photo CD (the base image), DCX and
    IPTC decode here; IM, IMT, IPTC, PCD and SPIDER, which PIL finds by
    opening them, are identified by their opens' checks. BUFR, GRIB,
    HDF5, MPEG, EPS and WMF raise ``OSError`` as PIL does. AVIF, or a
    JPEG 2000 feature outside the port, raises ``NotImplementedError``
    naming ROADMAP 12.7; a file PIL does not open raises ``OSError``, and
    what PIL refuses otherwise raises PIL's exception class."""
    if path.lower().endswith('.exr'):
        from ..utils.io import read_exr
        img, names = read_exr(path)
        if set('RGB') <= set(names):
            img = img[:, :, [names.index(c) for c in 'RGB']]
        return np.ascontiguousarray(img[:, :, :3], np.float32)
    img = np.asarray(read_rgb8(path), np.float32) / 255.0
    if gamma:  # sRGB -> linear
        img = np.where(img <= 0.04045, img / 12.92,
                       ((img + 0.055) / 1.055) ** 2.4)
    return img.astype(np.float32)


def pack(props: dict, bitmaps: list, volumes: list = None
         ) -> Tuple[int, list]:
    """Returns (type_code, params); appends loaded bitmaps and volumes to
    the given lists. Checkerboard rows: color0 [0:3], color1 [3:6], uv
    scale [6:8]; bitmap: its slot [0], uv scale [6:8]; grid3d: its volume
    slot [0], the world-to-unit-cube 3x4 map [8:20], scale [20];
    constant and constant3d: the value [0:3]; mesh_attribute: scale [20].
    Any other type packs as a constant, as in the reference."""
    t = props.get('type', 'constant')
    p = [0.0] * TEX_NPARAM

    def rgb(key, default):
        v = props.get(key, default)
        if isinstance(v, (int, float)):
            return [float(v)] * 3
        return [float(x) for x in v]

    if t == 'grid3d' or (t == 'gridvolume' and volumes is not None):
        # evaluated at the world hit position: the row maps world space
        # into the grid's unit cube
        from ..scene.vol_io import load_vol
        if 'grid' in props:          # an array given directly
            data = np.asarray(props['grid'], np.float32)
            bb_lo = np.asarray(props.get('bbox_min', (0, 0, 0)), np.float32)
            bb_hi = np.asarray(props.get('bbox_max', (1, 1, 1)), np.float32)
        else:
            vg = load_vol(props['filename'])
            data, bb_lo, bb_hi = vg.data, vg.bbox_min, vg.bbox_max
        if data.ndim == 3:
            data = data[..., None]
        if data.shape[-1] == 1:
            data = np.repeat(data, 3, axis=-1)
        tw = props.get('to_world')
        M = np.asarray(tw.m) if tw is not None else np.eye(4)
        Minv = np.linalg.inv(M)
        ext = np.maximum(bb_hi - bb_lo, 1e-12)
        # p_unit = (Minv @ p_world - bb_lo) / ext, folded into one 3x4
        A = Minv[:3, :3] / ext[:, None]
        b = (Minv[:3, 3] - bb_lo) / ext
        p[0] = len(volumes)
        p[8:20] = np.concatenate([A, b[:, None]], axis=1).reshape(-1)
        p[20] = float(props.get('scale', 1.0))
        volumes.append(data[..., :3].astype(np.float32))
        return TEXTURE_TYPES['grid3d'], p
    if t == 'constant3d':
        p[0:3] = rgb('value', rgb('color', 0.5))
        return TEXTURE_TYPES['constant3d'], p
    if t == 'mesh_attribute':
        p[20] = float(props.get('scale', 1.0))
        return TEXTURE_TYPES['mesh_attribute'], p
    if t == 'bitmap':
        img = load_bitmap(props['filename'],
                          gamma=props.get('raw', False) is False)
        p[0] = len(bitmaps)        # bitmap slot
        p[6] = float(props.get('uscale', 1.0))
        p[7] = float(props.get('vscale', 1.0))
        bitmaps.append(img)
        return TEXTURE_TYPES['bitmap'], p
    if t == 'checkerboard':
        p[0:3] = rgb('color0', 0.4)
        p[3:6] = rgb('color1', 0.2)
        p[6] = float(props.get('uscale', 1.0))
        p[7] = float(props.get('vscale', 1.0))
        return TEXTURE_TYPES['checkerboard'], p
    p[0:3] = rgb('value', 0.5)
    return TEXTURE_TYPES['constant'], p


def vertex_attr(scene, si):
    """The per-corner colour interpolated at a surface hit. The hit
    record has no barycentrics, so they are solved from the hit position
    (the 2x2 normal equations of p - v0 = u e1 + v e2). Lanes whose
    primitive is not a triangle of the hit shape (spheres, misses) or
    whose point is off its plane give zeros."""
    geo = scene.geo
    if not isinstance(getattr(geo, 'c0', ()), torch.Tensor):
        return torch.zeros(si.p.shape, device=si.p.device)
    T = geo.v0.shape[0]
    idx = torch.clamp(si.prim_index.long(), 0, max(T - 1, 0))
    v0 = geo.v0[idx]
    e1 = geo.e1[idx]
    e2 = geo.e2[idx]
    d = si.p - v0
    a11 = torch.sum(e1 * e1, -1)
    a12 = torch.sum(e1 * e2, -1)
    a22 = torch.sum(e2 * e2, -1)
    b1 = torch.sum(d * e1, -1)
    b2 = torch.sum(d * e2, -1)
    det = torch.clamp(a11 * a22 - a12 * a12, min=1e-18)
    u = (a22 * b1 - a12 * b2) / det
    v = (a11 * b2 - a12 * b1) / det
    w = 1.0 - u - v
    col = (w[:, None] * geo.c0[idx] + u[:, None] * geo.c1[idx]
           + v[:, None] * geo.c2[idx])
    recon = v0 + u[:, None] * e1 + v[:, None] * e2
    on_tri = (torch.sum((recon - si.p) ** 2, -1)
              <= 1e-6 * torch.maximum(a11, a22))
    ok = si.valid & (geo.shape_idx[idx] == si.shape_idx) & on_tri
    return torch.where(ok[:, None], col, 0.0)


def eval(scene, tex_id, uv, p_world=None, attr=None):
    """Per-lane texture lookup: tex_id (N,) int (-1 -> zeros), uv (N, 2).
    ``p_world`` enables the grid3d rows, ``attr`` (the interpolated
    vertex colour) the mesh_attribute rows. Returns (N, 3)."""
    tt = scene.textures
    tid = torch.clamp(tex_id.long(), min=0)
    ttype = tt.type[tid]
    P = tt.params[tid]
    us = P[:, 6]
    vs = P[:, 7]
    u = uv[:, 0] * torch.where(us != 0, us, 1.0)
    v = uv[:, 1] * torch.where(vs != 0, vs, 1.0)

    out = P[:, 0:3]  # constant, and a checkerboard's color0

    # checkerboard: parity of floor(2u) + floor(2v)
    par = (torch.floor(u * 2.0).to(torch.int32)
           + torch.floor(v * 2.0).to(torch.int32)) & 1
    chk = torch.where((par == 0)[:, None], P[:, 0:3], P[:, 3:6])
    out = torch.where((ttype == TEXTURE_TYPES['checkerboard'])[:, None],
                      chk, out)

    if tt.data.shape[0] > 0 and tt.data.shape[1] > 1:
        nb, Hm, Wm = tt.data.shape[0], tt.data.shape[1], tt.data.shape[2]
        slot = torch.clamp(P[:, 0].to(torch.int64), 0, nb - 1)
        H = tt.size[tid, 0].long()
        W = tt.size[tid, 1].long()
        # bilinear with wrap in u, flip v (image row 0 = top, v=0 bottom)
        x = torch.remainder(u, 1.0) * W.to(torch.float32) - 0.5
        y = (1.0 - torch.remainder(v, 1.0)) * H.to(torch.float32) - 0.5
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        tx = x - x0
        ty = y - y0

        def at(yy, xx):
            # the reference's clip(yy, 0, H - 1); rows that are not
            # bitmaps (H = W = 0) read texel (0, 0)
            yy = torch.clamp(torch.minimum(torch.clamp(yy, min=0), H - 1),
                             0, Hm - 1)
            xx = torch.clamp(torch.remainder(xx, torch.clamp(W, min=1)),
                             0, Wm - 1)
            return tt.data[slot, yy, xx]

        bil = (at(y0, x0) * ((1 - tx) * (1 - ty))[:, None]
               + at(y0, x0 + 1) * (tx * (1 - ty))[:, None]
               + at(y0 + 1, x0) * ((1 - tx) * ty)[:, None]
               + at(y0 + 1, x0 + 1) * (tx * ty)[:, None])
        out = torch.where((ttype == TEXTURE_TYPES['bitmap'])[:, None], bil,
                          out)

    # grid3d: trilerp the volume at the world-to-unit-cube mapped position
    vol = getattr(tt, 'vol', ())
    if p_world is not None and isinstance(vol, torch.Tensor) \
            and vol.ndim == 5:
        A = P[:, 8:20].reshape(-1, 3, 4)
        lp = (A[:, :, 0] * p_world[:, 0:1] + A[:, :, 1] * p_world[:, 1:2]
              + A[:, :, 2] * p_world[:, 2:3]) + A[:, :, 3]
        slot = torch.clamp(P[:, 0].to(torch.int64), 0, vol.shape[0] - 1)
        D = tt.vol_size[tid, 0].to(torch.float32)
        Hh = tt.vol_size[tid, 1].to(torch.float32)
        Ww = tt.vol_size[tid, 2].to(torch.float32)
        inside = torch.all((lp >= 0.0) & (lp <= 1.0), dim=-1)
        # voxel-centre sampling, like the medium grids
        fx = torch.clamp(torch.clamp(lp[:, 0] * Ww - 0.5, min=0.0),
                         max=Ww - 1.0)
        fy = torch.clamp(torch.clamp(lp[:, 1] * Hh - 0.5, min=0.0),
                         max=Hh - 1.0)
        fz = torch.clamp(torch.clamp(lp[:, 2] * D - 0.5, min=0.0),
                         max=D - 1.0)
        x0 = fx.to(torch.int64)
        y0 = fy.to(torch.int64)
        z0 = fz.to(torch.int64)
        txf, tyf, tzf = fx - x0, fy - y0, fz - z0
        xm, ym, zm = ((s - 1.0).to(torch.int64) for s in (Ww, Hh, D))
        acc = 0.0
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    w = ((txf if dx else 1 - txf) * (tyf if dy else 1 - tyf)
                         * (tzf if dz else 1 - tzf))
                    xi = torch.clamp(torch.minimum(x0 + dx, xm), 0,
                                     vol.shape[3] - 1)
                    yi = torch.clamp(torch.minimum(y0 + dy, ym), 0,
                                     vol.shape[2] - 1)
                    zi = torch.clamp(torch.minimum(z0 + dz, zm), 0,
                                     vol.shape[1] - 1)
                    acc = acc + w[:, None] * vol[slot, zi, yi, xi]
        g3 = torch.where(inside[:, None], acc * P[:, 20:21], 0.0)
        out = torch.where((ttype == TEXTURE_TYPES['grid3d'])[:, None], g3,
                          out)

    if isinstance(attr, torch.Tensor):
        out = torch.where((ttype == TEXTURE_TYPES['mesh_attribute'])[:, None],
                          attr * P[:, 20:21], out)
    return torch.where((tex_id >= 0)[:, None], out, 0.0)
