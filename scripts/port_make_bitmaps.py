"""Write the bitmap fixtures of the port's decoders with PIL.

    python scripts/port_make_bitmaps.py [--out tests/data/bitmaps]

Needs PIL, so it runs where PIL is installed (the card's machine has
none, which is why the files are committed), and libwebp's shared
library for the WebP layouts PIL's ``save`` cannot ask for. It writes:

  * ``picture64.{png,bmp,tga,ppm,gif,tif,webp}``: one 64x64 picture of at
    most 256 colours, written losslessly in seven formats (PNG, BMP and
    TGA with its palette, GIF, PPM, LZW TIFF and lossless WebP as RGB),
    so that all seven hold the same pixels; ``chip_smoke.py``'s
    ``textured_formats`` phase renders ``cbox_textured`` with each as its
    bitmaps;
  * one 37x23 file per layout that ``chip_smoke.py``'s ``bitmap_decode``
    phase checks (sequential, progressive, grey, CMYK and YCCK JPEG; BMP,
    TGA, PNM, GIF, TIFF and WebP layouts), each under 16 KiB;
  * the JPEG-in-TIFF (photometric RGB and YCbCr, strips and tiles) and
    YCbCr TIFF layouts (LZW, Deflate, PackBits; subsampling 1x1, 2x1 and
    2x2; ReferenceBlackWhite and YCbCrCoefficients), written through the
    libtiff that PIL bundles (``libtiff_write``, ctypes), as PIL's
    ``save`` asks for none of strips of a given height, tiles, YCbCr
    subsampling or YCbCr samples given as they are;
  * slice 19's TIFF corners (LZMA and Zstandard through libtiff, JPEG in
    planes and CMYK, tiled YCbCr; word-aligned CCITT RLE and ThunderScan
    coded by ``testing/bitmap_stages``) and PSD files of every mode PIL
    opens (``bitmap_stages.psd_file``; PIL has no PSD writer), with
    ``picture64.psd`` and ``picture64.zstd.tif``; the files PIL refuses
    (SGILog, WebP and 8-bit ThunderScan TIFFs, an unknown compression,
    PSD depths and modes PIL lacks) in ``../bitmaps_refused`` with
    ``pil_errors.json``, PIL's exception class and where it raised;
  * ``pil_rgb.npz``: PIL's ``Image.open(f).convert('RGB')`` bytes of
    every file, keyed by file name;
  * in ``../webp_large``, a 512x512 lossless and a 512x512 lossy WebP and
    ``pil_rgb_sha256.json``, the SHA-256 digest of PIL's RGB bytes of
    each (the decoders at a texture's size);
  * the rest of PIL's raster formats (``_rest_files``: Sun raster, BLP,
    FTEX, FITS, SPIDER, IM, IMT, MSP, FLI/FLC, XBM, XPM, GBR, McIDAS,
    PIXAR, XV thumbnails, DCX, IPTC; those PIL cannot write by
    ``testing/raster_files``), with ``picture64.ras`` and ``picture64.im``;
    the files of those formats PIL refuses and one of each format PIL
    opens and cannot load (BUFR, GRIB, HDF5, MPEG, EPS, WMF) in
    ``../bitmaps_refused``;
  * in ``../bitmaps_large``, with ``--large`` alone, the files at
    textures' sizes (``testing/bitmap_stages.picture``): baseline and
    progressive 4:2:0 JPEG and lossy and lossless WebP at 2,048x2,048,
    baseline JPEG and lossy WebP at 4,096x4,096, a baseline JPEG at
    512x512 (the small end of the decode-speed table); at 2,048x2,048 an
    LZW TIFF with predictor 2 (the picture posterised to steps of 8: the
    JPEG's own pixels take 4.5 MB in LZW), a 256-colour GIF of the
    baseline JPEG's pixels, a JPEG-in-TIFF in YCbCr 4:2:0 and a Zstandard
    TIFF with predictor 2 of the LZW TIFF's picture; and their
    ``pil_rgb_sha256.json``. No PNG is committed: a large one is written
    at run time by numpy (``testing/bitmap_stages.png_filtered``), as is
    an LZW TIFF of the JPEG's pixels (``testing/bitmap_stages.tiff_lzw``).

    python scripts/port_make_bitmaps.py --large

Its seeded entries (DDS of random BCn blocks; a 2,048x2,048 RLE Sun
raster, a 2,048x2,048 FLC of BRUN, LC and SS2 chunks and a Photo CD file,
``raster_files.large_raster``) are not committed: the digests name their
seeds. ``--rest`` writes only the rest of PIL's raster formats, the
refused files and ``pil_rgb.npz``; ``--colour-tables`` prints the Photo
CD and YCbCr tables that ``utils/pcd.py`` and ``utils/ycbcr.py`` hold,
recovered from PIL's output.

    python scripts/port_make_bitmaps.py --rest
    python scripts/port_make_bitmaps.py --colour-tables
"""
from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import glob
import hashlib
import io
import json
import os
import struct

import numpy as np
from PIL import Image

from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages, raster_files
from mitsuba_nlvrl_tpu_torch.testing.bitmap_stages import picture

H, W = 23, 37


def _picture64() -> Image.Image:
    """Stripes and noise, quantized to 256 colours (a P image)."""
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    base = 0.5 + 0.5 * np.sin(2 * np.pi * np.stack(
        [3 * xx + yy, 2 * yy - xx, 4 * (xx + yy)], -1))
    img = np.clip(0.8 * base + 0.2 * rng.uniform(size=(64, 64, 3)), 0, 1)
    return Image.fromarray((img * 255).astype(np.uint8)).quantize(256)


def _layout_picture() -> np.ndarray:
    """Gradients with a third of the pixels noise (37 x 23 RGB)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([(xx * 7) % 256, (yy * 11) % 256,
                     ((xx + yy) * 5) % 256], -1)
    noise = rng.integers(0, 256, (H, W, 3))
    return np.where(rng.uniform(size=(H, W, 1)) < 0.3, noise,
                    base).astype(np.uint8)


def _ycck(src: str, dst: str) -> None:
    """A CMYK JPEG relabelled YCCK (its Adobe transform set to 2)."""
    with open(src, 'rb') as f:
        data = bytearray(f.read())
    i = data.find(b'Adobe')
    data[i + 11] = 2
    with open(dst, 'wb') as f:
        f.write(data)


# --- WebP layouts through libwebp's encoder API (ctypes) -------------------
_CONFIG_FIELDS = (
    'lossless', 'quality', 'method', 'image_hint', 'target_size',
    'target_PSNR', 'segments', 'sns_strength', 'filter_strength',
    'filter_sharpness', 'filter_type', 'autofilter', 'alpha_compression',
    'alpha_filtering', 'alpha_quality', 'pass', 'show_compressed',
    'preprocessing', 'partitions', 'partition_limit', 'emulate_jpeg_size',
    'thread_level', 'low_memory', 'near_lossless', 'exact',
    'use_delta_palette', 'use_sharp_yuv', 'qmin', 'qmax')
_ENCODER_ABI = 0x020F                   # WEBP_ENCODER_ABI_VERSION of 1.2


class _Config(ctypes.Structure):
    """libwebp's ``WebPConfig``."""
    _fields_ = [(n, ctypes.c_float if n in ('quality', 'target_PSNR')
                 else ctypes.c_int) for n in _CONFIG_FIELDS] + [
        ('pad', ctypes.c_uint32 * 8)]


class _Picture(ctypes.Structure):
    """libwebp's ``WebPPicture`` (64-bit layout)."""
    _fields_ = [
        ('use_argb', ctypes.c_int), ('colorspace', ctypes.c_int),
        ('width', ctypes.c_int), ('height', ctypes.c_int),
        ('y', ctypes.c_void_p), ('u', ctypes.c_void_p),
        ('v', ctypes.c_void_p), ('y_stride', ctypes.c_int),
        ('uv_stride', ctypes.c_int), ('a', ctypes.c_void_p),
        ('a_stride', ctypes.c_int), ('pad1', ctypes.c_uint32 * 2),
        ('argb', ctypes.c_void_p), ('argb_stride', ctypes.c_int),
        ('pad2', ctypes.c_uint32 * 3), ('writer', ctypes.c_void_p),
        ('custom_ptr', ctypes.c_void_p), ('extra_info_type', ctypes.c_int),
        ('extra_info', ctypes.c_void_p), ('stats', ctypes.c_void_p),
        ('error_code', ctypes.c_int), ('progress_hook', ctypes.c_void_p),
        ('user_data', ctypes.c_void_p), ('pad3', ctypes.c_uint32 * 3),
        ('pad4', ctypes.c_void_p), ('pad5', ctypes.c_void_p),
        ('pad6', ctypes.c_uint32 * 8), ('memory_', ctypes.c_void_p),
        ('memory_argb_', ctypes.c_void_p), ('pad7', ctypes.c_void_p * 2)]


class _Writer(ctypes.Structure):
    """libwebp's ``WebPMemoryWriter``."""
    _fields_ = [('mem', ctypes.POINTER(ctypes.c_uint8)),
                ('size', ctypes.c_size_t), ('max_size', ctypes.c_size_t),
                ('pad', ctypes.c_uint32)]


def _libwebp_encode(rgba: np.ndarray, **settings) -> bytes:
    """A WebP file of an (H, W, 4) image through ``WebPEncode`` with the
    given ``WebPConfig`` settings (the default preset at quality 75)."""
    lib = ctypes.CDLL(ctypes.util.find_library('webp'))
    ref = ctypes.byref
    for fn in ('WebPConfigInitInternal', 'WebPValidateConfig',
               'WebPPictureInitInternal', 'WebPPictureImportRGBA',
               'WebPEncode'):
        getattr(lib, fn).restype = ctypes.c_int
    lib.WebPConfigInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int]
    lib.WebPPictureImportRGBA.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int]
    cfg = _Config()
    if not lib.WebPConfigInitInternal(ref(cfg), 0, 75.0, _ENCODER_ABI):
        raise RuntimeError("libwebp: WebPConfigInit failed")
    for k, v in settings.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ref(cfg)):
        raise RuntimeError(f"libwebp: invalid config {settings}")
    pic = _Picture()
    if not lib.WebPPictureInitInternal(ref(pic), _ENCODER_ABI):
        raise RuntimeError("libwebp: WebPPictureInit failed")
    h, w = rgba.shape[:2]
    pic.width, pic.height, pic.use_argb = w, h, cfg.lossless
    buf = np.ascontiguousarray(rgba, np.uint8)
    writer = _Writer()
    lib.WebPMemoryWriterInit(ref(writer))
    try:
        if not lib.WebPPictureImportRGBA(ref(pic), buf.ctypes.data, 4 * w):
            raise RuntimeError("libwebp: WebPPictureImportRGBA failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
        pic.custom_ptr = ctypes.cast(ref(writer), ctypes.c_void_p)
        if not lib.WebPEncode(ref(cfg), ref(pic)):
            raise RuntimeError(f"libwebp: WebPEncode error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ref(pic))
        lib.WebPMemoryWriterClear(ref(writer))


def _riff(chunks) -> bytes:
    """A WebP file of (tag, payload) chunks, each padded to even size."""
    body = b'WEBP' + b''.join(
        tag + struct.pack('<I', len(p)) + p + b'\0' * (len(p) & 1)
        for tag, p in chunks)
    return b'RIFF' + struct.pack('<I', len(body)) + body


def _webp_chunks(data: bytes) -> list:
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos + 4:pos + 8], 'little')
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _alph_variants(data: bytes, stem: str) -> dict:
    """Copies of a lossy RGBA file with its ALPH chunk's filter bits set
    to each of none, horizontal, vertical and gradient (each a valid
    stream that unfilters to another alpha plane)."""
    out = {}
    for f, name in enumerate(('none', 'horizontal', 'vertical',
                              'gradient')):
        chunks = [(t, bytes([p[0] & ~0x0C | f << 2]) + p[1:])
                  if t == b'ALPH' else (t, p) for t, p in _webp_chunks(data)]
        out[f'{stem}_{name}.webp'] = _riff(chunks)
    return out


def _webp_layouts(rgb: np.ndarray, pic: Image.Image) -> dict:
    """The WebP fixtures: file name -> bytes."""
    h, w = rgb.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = ((xx * 9 + yy * 5) % 256).astype(np.uint8)
    alpha[::3, ::4] = 0
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    opaque = np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)
    colour = Image.fromarray(rgb)

    def pil(im, **kw):
        b = io.BytesIO()
        im.save(b, 'WEBP', **kw)
        return b.getvalue()
    out = {
        'picture64.webp': pil(pic.convert('RGB'), lossless=True),
        'webp_lossless_m0.webp': pil(colour, lossless=True, method=0),
        'webp_lossless_m6_rgba.webp': pil(Image.fromarray(rgba, 'RGBA'),
                                          lossless=True, method=6,
                                          quality=100),
        'webp_grey_lossless.webp': pil(colour.convert('L'), lossless=True),
        'webp_lossy_q10.webp': pil(colour, quality=10),
        'webp_lossy_q50.webp': pil(colour, quality=50, method=6),
        'webp_lossy_q95.webp': pil(colour, quality=95, method=0),
        'webp_1x1_lossy.webp': pil(colour.crop((5, 5, 6, 6)), quality=80),
        'webp_vp8_simple_filter.webp': _libwebp_encode(
            opaque, filter_type=0, filter_strength=60),
        'webp_vp8_4_partitions.webp': _libwebp_encode(
            opaque, partitions=2, method=2),
        'webp_vp8_1_segment.webp': _libwebp_encode(opaque, segments=1),
        'webp_vp8_sharpness7.webp': _libwebp_encode(
            opaque, filter_sharpness=7, filter_strength=80),
        'webp_vp8_filter_off.webp': _libwebp_encode(
            opaque, filter_strength=0),
    }
    for n in (2, 4, 16, 200):
        out[f'webp_palette_{n}.webp'] = pil(colour.quantize(n),
                                            lossless=True)
    for comp in (0, 1):
        out.update(_alph_variants(_libwebp_encode(
            rgba, quality=60, alpha_compression=comp, alpha_filtering=0),
            f'webp_alph_{("raw", "lossless")[comp]}'))
    frames = [Image.fromarray(rgba, 'RGBA'),
              Image.fromarray(np.roll(rgba, 7, axis=1), 'RGBA')]
    b = io.BytesIO()
    frames[0].save(b, 'WEBP', save_all=True, append_images=frames[1:],
                   quality=70, duration=100)
    out['webp_animation_2_frames.webp'] = b.getvalue()
    return out


def _webp_large(out: str) -> None:
    """A 512x512 lossless and lossy WebP of one picture (smooth colour
    waves under sharp-edged discs and stripes, the top quarter lightly
    noisy), and the SHA-256 digest of PIL's RGB bytes of each."""
    rng = np.random.default_rng(512)
    yy, xx = np.mgrid[0:512, 0:512] / 512.0
    img = 235 * (0.5 + 0.5 * np.sin(2 * np.pi * np.stack(
        [3 * xx + yy, 2 * yy - xx, 4 * (xx + yy) * (1 + 0.5 * xx)], -1)))
    for _ in range(40):
        cy, cx, r = rng.uniform(0, 1, 3)
        r = 0.02 + 0.08 * r
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    stripes = ((xx * 64).astype(int) % 2 == 0) & (yy > 0.75)
    img[stripes] *= 0.5
    img += rng.integers(0, 2, (512, 512, 3)) * (yy[..., None] < 0.25)
    im = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    os.makedirs(out, exist_ok=True)
    digests, total = {}, 0
    for name, kw in (('lossless_512.webp', {'lossless': True}),
                     ('lossy_512.webp', {'quality': 90})):
        path = os.path.join(out, name)
        im.save(path, 'WEBP', **kw)
        total += os.path.getsize(path)
        rgb = np.asarray(Image.open(path).convert('RGB'))
        digests[name] = {'sha256': hashlib.sha256(rgb.tobytes()).hexdigest(),
                         'shape': list(rgb.shape)}
    assert total <= 256 * 1024, total
    with open(os.path.join(out, 'pil_rgb_sha256.json'), 'w') as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write('\n')


# --- TIFF layouts through PIL's bundled libtiff (ctypes) --------------------
_libtiff = None


def _libtiff_lib() -> ctypes.CDLL:
    global _libtiff
    if _libtiff is None:
        site = os.path.dirname(os.path.dirname(Image.__file__))
        libs = os.path.join(site, 'pillow.libs')
        found = glob.glob(os.path.join(libs, 'libtiff*.so*')) or \
            [ctypes.util.find_library('tiff')]
        lib = ctypes.CDLL(found[0])
        lib.TIFFOpen.restype = ctypes.c_void_p
        lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.TIFFClose.argtypes = [ctypes.c_void_p]
        for name in ('TIFFWriteEncodedStrip', 'TIFFWriteEncodedTile'):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
                           ctypes.c_ssize_t]
            fn.restype = ctypes.c_ssize_t
        _libtiff = lib
    return _libtiff


def _ycbcr_units(ycc: np.ndarray, hs: int, vs: int) -> bytes:
    """A block of full-resolution YCbCr samples (h, w, 3) as TIFF's data
    units: hs x vs luma samples, then the block's mean Cb and Cr (edge
    samples repeated into the blocks that pass the edge)."""
    h, w = ycc.shape[:2]
    rows = np.minimum(np.arange(-(-h // vs) * vs), h - 1)
    cols = np.minimum(np.arange(-(-w // hs) * hs), w - 1)
    full = ycc[rows][:, cols].astype(np.float64)
    bh, bw = full.shape[0] // vs, full.shape[1] // hs
    blocks = full.reshape(bh, vs, bw, hs, 3).transpose(0, 2, 1, 3, 4)
    luma = blocks[..., 0].reshape(bh, bw, vs * hs)
    chroma = np.round(blocks[..., 1:].mean(axis=(2, 3)))
    return np.concatenate([luma, chroma], -1).astype(np.uint8).tobytes()


def _pack_rows(block: np.ndarray, bits: int) -> bytes:
    """(h, w, C) samples as libtiff takes them: 8-bit bytes, 16- and
    32-bit samples in native order, or rows of 1- or 12-bit samples
    packed MSB first, each row from a byte boundary."""
    if bits == 8:
        return block.astype(np.uint8).tobytes()
    if bits in (16, 32):
        return np.ascontiguousarray(block).tobytes()
    h = block.shape[0]
    flat = block.reshape(h, -1).astype(np.uint16)
    b = (flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1
    return np.packbits(b.reshape(h, -1).astype(np.uint8), axis=1).tobytes()


def libtiff_write(path: str, pixels: np.ndarray, photometric: int,
                  compression: int, strip: int = None, tile=None,
                  subsampling=None, tags=(), jpeg_quality: int = 90,
                  bits: int = 8, order: str = 'II', planar: int = 1) -> None:
    """A TIFF of (H, W, C) ``pixels`` written by libtiff: strips of
    ``strip`` rows (all rows by default) or ``tile`` (w, h) tiles, ``bits``
    a sample (8; 1 or 12 packed MSB first), in byte ``order`` 'II' or
    'MM'. Compression 7 (JPEG) takes RGB or grey pixels: libjpeg converts
    them to YCbCr for photometric 6 (JPEGCOLORMODE_RGB) at ``subsampling``.
    Otherwise photometric 6 takes full-resolution YCbCr, packed here into
    data units. ``tags``: (tag, value, ...) set as they are (a list value
    is a float array); libtiff codes CCITT data (compression 2-4, 1-bit
    samples: 1 black) with the ``T4Options`` and ``FillOrder`` given
    there. ``planar`` 2 writes each sample in planes of its own (its
    strips or tiles after the previous plane's)."""
    lib = _libtiff_lib()
    H, W, C = pixels.shape
    t = lib.TIFFOpen(path.encode(), b'w' if order == 'II' else b'wb')
    assert t, path

    def put(tag, *vals):
        args = [(ctypes.c_float * len(v))(*v) if isinstance(v, list)
                else ctypes.c_uint32(v) for v in vals]
        if tag == 338:                  # ExtraSamples: a count, an array
            args = [ctypes.c_uint32(len(vals)),
                    (ctypes.c_uint16 * len(vals))(*vals)]
        assert lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(tag),
                                *args) == 1, (tag, vals)
    for tag, *vals in ((256, W), (257, H), (258, bits), (277, C),
                       (259, compression), (262, photometric),
                       (284, planar)):
        put(tag, *vals)
    hs, vs = subsampling or (1, 1)
    if photometric == 6:
        put(530, hs, vs)
    if compression == 7:
        put(65537, jpeg_quality)
        if photometric == 6:
            put(65538, 1)                       # JPEGCOLORMODE_RGB
    for tag, *vals in tags:
        put(tag, *vals)
    raw = compression != 7 and photometric == 6 and C == 3 and planar == 1
    tw, th = tile or (W, strip or H)
    if tile:
        put(322, tw)
        put(323, th)
    else:
        put(278, th)
    k = 0
    for plane in ([slice(None)] if planar == 1 else
                  [slice(c, c + 1) for c in range(C)]):
        for y in range(0, H, th):
            for x in range(0, W, tw):
                h = th if tile else min(th, H - y)
                part = pixels[y:y + h, x:x + tw, plane]
                block = np.zeros((h, tw, part.shape[2]), pixels.dtype)
                block[:part.shape[0], :part.shape[1]] = part
                if tile:                        # repeat the edge samples
                    block[part.shape[0]:] = block[part.shape[0] - 1]
                    block[:, part.shape[1]:] = block[:, part.shape[1] - 1:
                                                     part.shape[1]]
                data = _ycbcr_units(block, hs, vs) if raw else \
                    _pack_rows(block, bits)
                write = lib.TIFFWriteEncodedTile if tile else \
                    lib.TIFFWriteEncodedStrip
                assert write(t, k, data, len(data)) >= 0, (path, k)
                k += 1
    lib.TIFFClose(t)


def _tiff_layouts(rgb: np.ndarray, out: str) -> list:
    """The 37x23 JPEG-in-TIFF and YCbCr TIFF layouts; their names."""
    ycc = np.asarray(Image.fromarray(rgb).convert('YCbCr'))
    grey = rgb[..., 1:2]
    made = {
        'tiff_jpeg_rgb_strips.tif': (rgb, 2, 7, {'strip': 16}),
        'tiff_jpeg_rgb_tiles.tif': (rgb, 2, 7, {'tile': (16, 16)}),
        'tiff_jpeg_grey.tif': (grey, 1, 7, {'strip': 8}),
        'tiff_jpeg_ycbcr420_strips.tif': (rgb, 6, 7, {
            'strip': 16, 'subsampling': (2, 2)}),
        'tiff_jpeg_ycbcr420_tiles.tif': (rgb, 6, 7, {
            'tile': (16, 16), 'subsampling': (2, 2)}),
        'tiff_jpeg_ycbcr422_strips.tif': (rgb, 6, 7, {
            'strip': 8, 'subsampling': (2, 1)}),
        'tiff_ycbcr11_lzw_pred2.tif': (ycc, 6, 5, {
            'strip': 8, 'subsampling': (1, 1), 'tags': ((317, 2),)}),
        'tiff_ycbcr21_packbits.tif': (ycc, 6, 32773, {
            'strip': 8, 'subsampling': (2, 1)}),
        'tiff_ycbcr22_deflate_tiles.tif': (ycc, 6, 8, {
            'tile': (16, 16), 'subsampling': (2, 2)}),
        'tiff_ycbcr22_lzw_blackwhite.tif': (ycc, 6, 5, {
            'strip': 6, 'subsampling': (2, 2), 'tags': (
                (532, [16.0, 235.0, 128.0, 240.0, 128.0, 240.0]),
                (529, [0.2126, 0.7152, 0.0722]))}),
    }
    for name, (px, photo, comp, kw) in made.items():
        libtiff_write(os.path.join(out, name), px, photo, comp, **kw)
    return list(made)


def tiff_by_hand(tags: dict, blobs=(), shift: int = 0) -> bytes:
    """A little-endian classic TIFF of one IFD: ``tags`` {tag: (type,
    values)} (type 2 takes one bytes value; a value ``('blob', i)`` is
    the offset of ``blobs[i]``, which follow the IFD, each from an even
    offset, or an odd one after ``shift`` 1)."""
    fmt = {1: 'B', 2: 's', 3: 'H', 4: 'I'}
    pos = 8 + 2 + 12 * len(tags) + 4
    body, where = bytearray(b'\0' * shift), []
    for b in blobs:
        where.append(pos + len(body))
        body += b + b'\0' * (len(b) & 1)
    extra, entries = bytearray(), []
    for tag in sorted(tags):
        typ, vals = tags[tag]
        vals = [where[v[1]] if isinstance(v, tuple) else v for v in vals]
        data = vals[0] if typ == 2 else b''.join(
            struct.pack('<' + fmt[typ], v) for v in vals)
        count = len(data) if typ == 2 else len(vals)
        if len(data) <= 4:
            entries.append(struct.pack('<HHI', tag, typ, count)
                           + data.ljust(4, b'\0'))
        else:
            entries.append(struct.pack('<HHII', tag, typ, count,
                                       pos + len(body) + len(extra)))
            extra += data + b'\0' * (len(data) & 1)
    return b'II*\0' + struct.pack('<IH', 8, len(tags)) + b''.join(entries) \
        + b'\0' * 4 + bytes(body) + bytes(extra)


def _jpeg_segments(jp: bytes):
    """A baseline JPEG's tables and its scan split at restart markers:
    ({table id: 64 bytes}, {class << 4 | id: counts and symbols}, the
    components' quantisation table ids, the scan's pieces)."""
    pos, q, dht, tq = 2, {}, {}, []
    while True:
        marker, n = jp[pos + 1], struct.unpack('>H', jp[pos + 2:pos + 4])[0]
        body = jp[pos + 4:pos + 2 + n]
        pos += 2 + n
        if marker == 0xDB:
            for i in range(0, len(body), 65):
                q[body[i] & 15] = body[i + 1:i + 65]
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                m = sum(body[i + 1:i + 17])
                dht[body[i]] = body[i + 1:i + 17 + m]
                i += 17 + m
        elif marker == 0xC0:
            tq = [body[8 + 3 * k] for k in range(body[5])]
        elif marker == 0xDA:
            break
    scan, pieces, cur, i = jp[pos:-2], [], bytearray(), 0
    while i < len(scan):
        if scan[i] == 0xFF and i + 1 < len(scan) and \
                0xD0 <= scan[i + 1] <= 0xD7:
            pieces.append(bytes(cur))
            cur = bytearray()
            i += 2
            continue
        cur.append(scan[i])
        i += 1
    return q, dht, tq, pieces + [bytes(cur)]


def _ojpeg_files(rgb: np.ndarray) -> dict:
    """Old-style JPEG TIFFs (compression 6), written by hand: one whose
    ``JPEGInterchangeFormat`` points at a whole 4:2:0 JPEG PIL wrote, one
    whose strip holds such a stream, and two in strips of entropy-coded
    data with ``JPEGProc`` tables (4:2:0 in 16-row strips, 4:4:4 in
    8-row strips), each strip a restart interval of PIL's JPEG."""
    H, W = rgb.shape[:2]
    base = {256: (3, [W]), 257: (3, [H]), 258: (3, [8, 8, 8]),
            259: (3, [6]), 262: (3, [6]), 277: (3, [3])}
    out = {}
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, 'JPEG', quality=85, subsampling=2)
    jp = buf.getvalue()
    out['tiff_ojpeg_interchange.tif'] = tiff_by_hand({
        **base, 273: (4, [('blob', 0)]), 278: (3, [H]),
        279: (4, [len(jp)]), 513: (4, [('blob', 0)]), 514: (4, [len(jp)]),
        530: (3, [2, 2])}, [jp])
    out['tiff_ojpeg_stream_strip.tif'] = tiff_by_hand({
        **base, 273: (4, [('blob', 0)]), 278: (3, [H]),
        279: (4, [len(jp)])}, [jp])
    for name, sub, (hs, vs), rps in (
            ('tiff_ojpeg_tables_420.tif', 2, (2, 2), 16),
            ('tiff_ojpeg_tables_444.tif', 0, (1, 1), 8)):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, 'JPEG', quality=85, subsampling=sub,
                                  restart_marker_rows=rps // (8 * vs))
        q, dht, tq, strips = _jpeg_segments(buf.getvalue())
        n = len(strips)
        assert n == -(-H // rps), (name, n)
        blobs = strips + [q[tq[k]] for k in range(3)] + \
            [dht[min(k, 1)] for k in range(3)] + \
            [dht[0x10 | min(k, 1)] for k in range(3)]
        out[name] = tiff_by_hand({
            **base, 273: (4, [('blob', i) for i in range(n)]),
            278: (3, [rps]), 279: (4, [len(x) for x in strips]),
            512: (3, [1]), 515: (3, [rps // (8 * vs) * -(-W // (8 * hs))]),
            519: (4, [('blob', n + k) for k in range(3)]),
            520: (4, [('blob', n + 3 + k) for k in range(3)]),
            521: (4, [('blob', n + 6 + k) for k in range(3)]),
            530: (3, [hs, vs])}, blobs)
    return out


def _bilevel(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 1) 0/1 samples (1 black) of an RGB picture: its green
    channel thresholded, with a row of solid black, one of solid white
    and one of noise among them."""
    b = (rgb[..., 1:2] < 128).astype(np.uint8)
    b[3] = 1
    b[4] = 0
    b[9, :, 0] = np.random.default_rng(7).integers(0, 2, b.shape[1])
    return b


def _libtiff_planar(path: str, pixels: np.ndarray, photometric: int,
                    compression: int) -> None:
    """A TIFF of (H, W, 3) 8-bit samples in three planes (planar
    configuration 2), one strip a plane, 1x1 YCbCr subsampling."""
    lib = _libtiff_lib()
    H, W, C = pixels.shape
    t = lib.TIFFOpen(path.encode(), b'w')
    for tag, *vals in ((256, W), (257, H), (258, 8), (277, C),
                       (259, compression), (262, photometric), (284, 2),
                       (278, H), (530, 1, 1)):
        assert lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(tag),
                                *[ctypes.c_uint32(v) for v in vals]) == 1
    for k in range(C):
        data = np.ascontiguousarray(pixels[..., k]).tobytes()
        assert lib.TIFFWriteEncodedStrip(t, k, data, len(data)) >= 0
    lib.TIFFClose(t)


def _tiff_rest(rgb: np.ndarray, out: str) -> list:
    """Slice 17's TIFF layouts: orientations 2-8 (strips, tiles,
    JPEG-in-TIFF, YCbCr, G4), CCITT (RLE; G3 1-D and 2-D, with and
    without fill bits, the uncompressed-mode bit; G4; fill order 2,
    tiles, photometric 1), old-style JPEG, CIELab, 12-bit grey,
    one-sample and planar YCbCr, and YCbCr with predictor 2 above 1x1;
    their names."""
    colour = Image.fromarray(rgb)
    ycc = np.asarray(colour.convert('YCbCr'))
    bits = _bilevel(rgb)
    grey12 = (rgb[..., :1].astype(np.uint16) * 16 + rgb[..., 2:3] // 16)
    grey12[0, :6, 0] = (0, 1, 255, 256, 4094, 4095)
    writes = {f'tiff_orient{o}_lzw.tif': (colour, {
        'compression': 'tiff_lzw', 'tiffinfo': {274: o}})
        for o in range(2, 9)}
    writes.update({
        'tiff_orient5_jpeg.tif': (colour, {'compression': 'jpeg',
                                           'tiffinfo': {274: 5}}),
        'tiff_orient8_g4.tif': (colour.convert('1'), {
            'compression': 'group4', 'tiffinfo': {274: 8}}),
        'tiff_pil_ccitt.tif': (colour.convert('1'), {
            'compression': 'tiff_ccitt'}),
        'tiff_pil_group3.tif': (colour.convert('1'), {'compression':
                                                      'group3'}),
        'tiff_pil_group4.tif': (colour.convert('1'), {'compression':
                                                      'group4'}),
        'tiff_lab.tif': (colour.convert('LAB'), {}),
        'tiff_lab_lzw.tif': (colour.convert('LAB'), {
            'compression': 'tiff_lzw'}),
    })
    for name, (im, kw) in writes.items():
        im.save(os.path.join(out, name), **kw)
    made = {
        'tiff_orient6_tiles.tif': (rgb, 2, 8, {'tile': (16, 16),
                                               'tags': ((274, 6),)}),
        'tiff_orient7_ycbcr22.tif': (ycc, 6, 5, {
            'strip': 8, 'subsampling': (2, 2), 'tags': ((274, 7),)}),
        'tiff_ccitt_rle.tif': (bits, 0, 2, {'strip': 8, 'bits': 1}),
        'tiff_g3_1d.tif': (bits, 0, 3, {'strip': 8, 'bits': 1}),
        'tiff_g3_2d.tif': (bits, 0, 3, {'strip': 8, 'bits': 1,
                                        'tags': ((292, 1),)}),
        'tiff_g3_1d_fill.tif': (bits, 0, 3, {'strip': 16, 'bits': 1,
                                             'tags': ((292, 4),)}),
        'tiff_g3_2d_fill.tif': (bits, 0, 3, {'bits': 1,
                                             'tags': ((292, 5),)}),
        'tiff_g3_uncompressed_bit.tif': (bits, 0, 3, {
            'strip': 8, 'bits': 1, 'tags': ((292, 3),)}),
        'tiff_g3_2d_fillorder2.tif': (bits, 0, 3, {
            'strip': 8, 'bits': 1, 'tags': ((292, 1), (266, 2))}),
        'tiff_g4_fillorder2.tif': (bits, 0, 4, {'bits': 1,
                                                'tags': ((266, 2),)}),
        'tiff_g4_tiles.tif': (bits, 0, 4, {'tile': (16, 16), 'bits': 1}),
        'tiff_g4_min_is_black.tif': (bits, 1, 4, {'strip': 8, 'bits': 1}),
        'tiff_g3_2d_tiles_min_is_black.tif': (bits, 1, 3, {
            'tile': (32, 16), 'bits': 1, 'tags': ((292, 1),)}),
        'tiff_lab_mm_lzw.tif': (np.asarray(colour.convert('LAB')) ^
                                np.uint8([0, 128, 128]), 8, 5, {
            'strip': 8, 'order': 'MM'}),
        'tiff_grey12_raw.tif': (grey12, 1, 1, {'strip': 8, 'bits': 12}),
        'tiff_grey12_lzw.tif': (grey12, 1, 5, {'strip': 8, 'bits': 12}),
        'tiff_grey12_deflate.tif': (grey12, 1, 8, {'bits': 12}),
        'tiff_ycbcr_one_sample.tif': (ycc[..., :1], 6, 1, {
            'strip': 8, 'subsampling': (1, 1)}),
        'tiff_ycbcr22_lzw_pred2.tif': (ycc, 6, 5, {
            'strip': 8, 'subsampling': (2, 2), 'tags': ((317, 2),)}),
        'tiff_ycbcr21_lzw_pred2.tif': (ycc, 6, 5, {
            'strip': 8, 'subsampling': (2, 1), 'tags': ((317, 2),)}),
        'tiff_ycbcr44_deflate_pred2.tif': (ycc, 6, 8, {
            'strip': 8, 'subsampling': (4, 4), 'tags': ((317, 2),)}),
        'tiff_ycbcr22_deflate_pred2_tiles.tif': (ycc, 6, 8, {
            'tile': (16, 16), 'subsampling': (2, 2), 'tags': ((317, 2),)}),
    }
    for name, (px, photo, comp, kw) in made.items():
        libtiff_write(os.path.join(out, name), px, photo, comp, **kw)
    planar = ('tiff_ycbcr_planar_raw.tif', 'tiff_ycbcr_planar_lzw.tif')
    for name, comp in zip(planar, (1, 5)):
        _libtiff_planar(os.path.join(out, name), ycc, 6, comp)
    ojpeg = _ojpeg_files(rgb)
    for name, data in ojpeg.items():
        with open(os.path.join(out, name), 'wb') as f:
            f.write(data)
    return [*writes, *made, *planar, *ojpeg]


def _hand_tiff(bits: int, photometric: int, comp: int, strips: list,
               rows: int, w: int, h: int, shift: int = 0) -> bytes:
    """A one-sample TIFF of coded ``strips`` (``rows`` rows each), written
    by hand (``tiff_by_hand``)."""
    n = len(strips)
    return tiff_by_hand({
        256: (3, [w]), 257: (3, [h]), 258: (3, [bits]), 259: (3, [comp]),
        262: (3, [photometric]), 277: (3, [1]),
        273: (4, [('blob', i) for i in range(n)]), 278: (3, [rows]),
        279: (4, [len(x) for x in strips])}, strips, shift)


def _thunder_picture(rgb: np.ndarray) -> np.ndarray:
    """(H, W) 4-bit pixels of the picture's green channel, with a flat
    band and a flat half row, so that runs code them."""
    g4 = (rgb[..., 1] >> 4).astype(np.uint8)
    g4[5:8] = 7
    g4[10, :20] = 3
    return g4


# TIFF codecs of PIL's COMPRESSION_INFO that it refuses, and PSD files it
# refuses: written into ../bitmaps_refused with the exception class PIL
# raises and whether Image.open or the load raised it (pil_errors.json)
def _refused_files(rgb: np.ndarray) -> dict:
    H, W = rgb.shape[:2]
    ch = np.moveaxis(rgb, -1, 0)
    junk = bytes(np.random.default_rng(19).integers(0, 256, 600,
                                                    dtype=np.uint8))
    g4 = _thunder_picture(rgb)

    def one(bits, photo, comp, spp=1):
        return tiff_by_hand({
            256: (3, [W]), 257: (3, [H]), 258: (3, [bits] * spp),
            259: (3, [comp]), 262: (3, [photo]), 277: (3, [spp]),
            273: (4, [('blob', 0)]), 278: (3, [H]), 279: (4, [len(junk)])},
            [junk])
    rle = bitmap_stages.psd_file(ch, 3, compression=1)
    grey = bitmap_stages.psd_file(ch[:1], 1)
    return {
        'tiff_webp.tif': one(8, 2, 50001, 3),
        'tiff_sgilog_logl.tif': one(16, 32844, 34676),
        'tiff_sgilog_logluv.tif': one(8, 32845, 34677, 3),
        'tiff_sgilog_minisblack.tif': one(16, 1, 34676),
        'tiff_thunderscan_8bit.tif': _hand_tiff(
            8, 1, 32809, [bitmap_stages.thunderscan(g4, 1)], H, W, H),
        'tiff_compression_9.tif': one(8, 1, 9),
        'psd_rgb16.psd': bitmap_stages.psd_file(ch, 3, bits=16),
        'psd_grey16_rle.psd': bitmap_stages.psd_file(ch[:1], 1, bits=16,
                                                     compression=1),
        'psd_rgb_two_channels.psd': bitmap_stages.psd_file(ch[:2], 3),
        'psd_cmyk_three_channels.psd': bitmap_stages.psd_file(ch, 4),
        'psd_zip.psd': bitmap_stages.psd_file(ch, 3, compression=2),
        'psd_psb.psd': bitmap_stages.psd_file(ch, 3, version=2),
        'psd_mode5.psd': bitmap_stages.psd_file(ch, 5),
        'psd_rgb_rle_truncated.psd': rle[:-40],
        'psd_grey_raw_truncated.psd': grey[:-40],
    }


def _slice19_files(rgb: np.ndarray, pic: Image.Image, out: str) -> list:
    """Slice 19's TIFF layouts (LZMA and Zstandard at several levels and
    predictors, in strips and tiles, both byte orders; JPEG in planes and
    in CMYK, with alpha and min-is-white; uncompressed tiled YCbCr;
    word-aligned CCITT RLE and ThunderScan, coded here) and PSD files
    (every mode of PIL's MODES, raw and RLE, with resources and a layer
    section), the picture as a Zstandard TIFF and a PSD, and the refused
    files into ../bitmaps_refused; the names written into ``out``."""
    H, W = rgb.shape[:2]
    ycc = np.asarray(Image.fromarray(rgb).convert('YCbCr'))
    cmyk = np.concatenate([rgb, rgb[..., :1]], -1)
    rgba = np.concatenate([rgb, rgb[..., 2:]], -1)
    u16 = rgb.astype(np.uint16) * 257 + 3
    f32 = rgb[..., :1].astype(np.float32) * 1.5 - 7.0
    made = {
        'tiff_zstd_rgb.tif': (rgb, 2, 50000, {'strip': 8}),
        'tiff_zstd_level19_pred2.tif': (rgb, 2, 50000, {
            'strip': 16, 'tags': ((317, 2), (65564, 19))}),
        'tiff_zstd_level1_pred2_tiles_mm.tif': (rgb, 2, 50000, {
            'tile': (16, 16), 'order': 'MM', 'tags': ((317, 2),
                                                      (65564, 1))}),
        'tiff_zstd_rgb16_pred2_mm.tif': (u16, 2, 50000, {
            'strip': 8, 'bits': 16, 'order': 'MM', 'tags': ((317, 2),)}),
        'tiff_zstd_float_pred3.tif': (f32, 1, 50000, {
            'strip': 8, 'bits': 32, 'tags': ((317, 3), (339, 3))}),
        'tiff_zstd_cmyk.tif': (cmyk, 5, 50000, {'tags': ((65564, 22),)}),
        'tiff_lzma_rgb.tif': (rgb, 2, 34925, {'strip': 8}),
        'tiff_lzma_preset9_pred2_tiles.tif': (rgb, 2, 34925, {
            'tile': (16, 16), 'tags': ((317, 2), (65562, 9))}),
        'tiff_lzma_rgb16_pred2_mm.tif': (u16, 2, 34925, {
            'strip': 8, 'bits': 16, 'order': 'MM', 'tags': ((317, 2),)}),
        'tiff_lzma_float_pred3_mm.tif': (f32, 1, 34925, {
            'strip': 8, 'bits': 32, 'order': 'MM',
            'tags': ((317, 3), (339, 3))}),
        'tiff_jpeg_planar_rgb.tif': (rgb, 2, 7, {'strip': 8, 'planar': 2}),
        'tiff_jpeg_planar_rgb_tiles.tif': (rgb, 2, 7, {
            'tile': (16, 16), 'planar': 2}),
        'tiff_jpeg_planar_ycbcr.tif': (ycc, 6, 7, {
            'strip': 8, 'planar': 2, 'subsampling': (1, 1)}),
        'tiff_jpeg_cmyk.tif': (cmyk, 5, 7, {'strip': 8}),
        'tiff_jpeg_cmyk_planar_tiles.tif': (cmyk, 5, 7, {
            'tile': (16, 16), 'planar': 2}),
        'tiff_jpeg_rgba.tif': (rgba, 2, 7, {'strip': 8,
                                            'tags': ((338, 2),)}),
        'tiff_jpeg_la_planar.tif': (rgb[..., :2], 1, 7, {
            'strip': 8, 'planar': 2, 'tags': ((338, 2),)}),
        'tiff_jpeg_min_is_white.tif': (rgb[..., 1:2], 0, 7, {'strip': 8}),
        'tiff_ycbcr22_raw_tiles.tif': (ycc, 6, 1, {
            'tile': (16, 16), 'subsampling': (2, 2)}),
        'tiff_ycbcr11_raw_tiles.tif': (ycc, 6, 1, {
            'tile': (32, 16), 'subsampling': (1, 1)}),
    }
    for name, (px, photo, comp, kw) in made.items():
        libtiff_write(os.path.join(out, name), px, photo, comp, **kw)
    bits = _bilevel(rgb)[..., 0]
    g4 = _thunder_picture(rgb)
    coded = {
        'tiff_rlew.tif': _hand_tiff(1, 0, 32771, [
            bitmap_stages.ccitt_rlew(bits[y:y + 8]) for y in range(0, H, 8)],
            8, W, H),
        'tiff_rlew_odd_offset.tif': _hand_tiff(1, 1, 32771, [
            bitmap_stages.ccitt_rlew(bits, 1)], H, W, H, shift=1),
        'tiff_thunderscan.tif': _hand_tiff(4, 1, 32809, [
            bitmap_stages.thunderscan(g4[y:y + 8], y) for y in
            range(0, H, 8)], 8, W, H),
        'tiff_thunderscan_min_is_white.tif': _hand_tiff(4, 0, 32809, [
            bitmap_stages.thunderscan(g4, 5)], H, W, H),
    }
    ch = np.moveaxis(rgb, -1, 0)
    idx = ch[:1]
    colour = bytes(np.random.default_rng(23).integers(0, 256, 768,
                                                      dtype=np.uint8))
    psd = bitmap_stages.psd_file
    coded.update({
        'psd_bitmap.psd': psd(ch[:1] & 1, 0, bits=1),
        'psd_bitmap_rle.psd': psd(ch[1:2] >> 7, 0, bits=1, compression=1),
        'psd_bitmap_8bit.psd': psd(ch[:1], 0),
        'psd_grey.psd': psd(ch[:1], 1),
        'psd_grey_rle.psd': psd(ch[:1], 1, compression=1),
        'psd_grey_alpha_rle.psd': psd(ch[:2], 1, compression=1),
        'psd_multichannel.psd': psd(ch, 7),
        'psd_duotone.psd': psd(ch[:1], 8, colour=bytes(range(40))),
        'psd_palette.psd': psd(idx, 2, colour=colour),
        'psd_palette_rle.psd': psd(idx, 2, colour=colour, compression=1),
        'psd_palette_no_colour.psd': psd(idx, 2),
        'psd_rgb.psd': psd(ch, 3),
        'psd_rgb_rle.psd': psd(ch, 3, compression=1),
        'psd_rgba_rle.psd': psd(np.concatenate([ch, ch[:1]]), 3,
                                compression=1),
        'psd_rgb_five_channels_rle.psd': psd(np.concatenate([ch, ch[:2]]),
                                             3, compression=1),
        'psd_cmyk.psd': psd(np.concatenate([ch, ch[:1]]), 4),
        'psd_cmyk_alpha_rle.psd': psd(np.concatenate([ch, ch[:2]]), 4,
                                      compression=1),
        'psd_lab.psd': psd(ch, 9),
        'psd_lab_rle.psd': psd(ch, 9, compression=1),
        'psd_layers_resources_rle.psd': psd(
            ch, 3, compression=1, resources=((1005, bytes(16)),
                                             (1039, b'icc'), (1060, b'')),
            layers=bytes(range(64))),
        'picture64.psd': psd(np.moveaxis(np.asarray(pic.convert('RGB')),
                                         -1, 0), 3, compression=1),
    })
    for name, data in coded.items():
        with open(os.path.join(out, name), 'wb') as f:
            f.write(data)
    libtiff_write(os.path.join(out, 'picture64.zstd.tif'),
                  np.asarray(pic.convert('RGB')), 2, 50000,
                  tags=((317, 2),))
    return [*made, *coded, 'picture64.zstd.tif']


def _write_refused(rgb: np.ndarray, out: str) -> None:
    """The files PIL refuses, into ../bitmaps_refused, and
    ``pil_errors.json``: each one's exception class, where PIL raised it
    (``open`` or ``load``) and, for a class of PIL's own, the builtin
    class it derives from (``base``)."""
    import builtins
    refused = os.path.join(os.path.dirname(out), 'bitmaps_refused')
    os.makedirs(refused, exist_ok=True)
    errors = {}
    for name, data in {**_refused_files(rgb),
                       **_rest_refused_files(rgb)}.items():
        path = os.path.join(refused, name)
        with open(path, 'wb') as f:
            f.write(data)
        at = 'open'
        try:
            im = Image.open(path)
            at = 'load'
            im.convert('RGB')
        except Exception as e:          # noqa: BLE001 - the class is kept
            errors[name] = {'error': type(e).__name__, 'at': at}
            if not hasattr(builtins, type(e).__name__):
                errors[name]['base'] = next(
                    c.__name__ for c in type(e).__mro__
                    if getattr(builtins, c.__name__, None) is c)
        assert name in errors, f"PIL opens {name}"
    with open(os.path.join(refused, 'pil_errors.json'), 'w') as f:
        json.dump(errors, f, indent=1, sort_keys=True)
        f.write('\n')


def _sgi_rle(img: np.ndarray, bpc: int) -> bytes:
    """An RLE SGI file of an (H, W, Z) image (``bpc`` 2: 16-bit samples,
    the value times 257): each channel's row as runs of one value and
    copies of up to 127 samples, a zero to end it, rows bottom-up."""
    H, W, Z = img.shape
    vals = img.astype(np.uint16) * (257 if bpc == 2 else 1)

    def word(v):
        return struct.pack('>H', v) if bpc == 2 else bytes([v])
    rows = {}
    for c in range(Z):
        for r in range(H):
            row, out, x = vals[H - 1 - r, :, c], bytearray(), 0
            while x < W:
                run = 1
                while x + run < W and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run > 1:
                    out += word(run) + word(int(row[x]))
                    x += run
                    continue
                end = x + 1
                while end < W and end - x < 127 and row[end] != row[end - 1]:
                    end += 1
                if end < W and row[end] == row[end - 1]:
                    end -= 1
                out += word(0x80 | (end - x)) + b''.join(
                    word(int(v)) for v in row[x:end])
                x = end
            rows[(r, c)] = bytes(out + word(0))
    head = bytearray(512)
    struct.pack_into('>HBBHHHH', head, 0, 474, 1, bpc, 3 if Z > 1 else 2,
                     W, H, Z)
    struct.pack_into('>II', head, 12, 0, 255 * (257 if bpc == 2 else 1))
    order = [(r, c) for c in range(Z) for r in range(H)]
    start, data, offs = 512 + 8 * len(order), bytearray(), []
    for key in order:
        offs.append(start + len(data))
        data += rows[key]
    table = struct.pack(f'>{len(order)}I', *offs) + struct.pack(
        f'>{len(order)}I', *[len(rows[k]) for k in order])
    return bytes(head) + table + bytes(data)


def _pcx_rle(rows: np.ndarray) -> bytes:
    """PCX RLE of (H, N) row bytes: runs of up to 63 within a row, a
    byte of its own where it is below 0xC0."""
    out = bytearray()
    for row in rows:
        x, n = 0, len(row)
        while x < n:
            run = 1
            while x + run < n and run < 63 and row[x + run] == row[x]:
                run += 1
            if run > 1 or row[x] >= 0xC0:
                out += bytes([0xC0 | run, row[x]])
            else:
                out.append(row[x])
            x += run
    return bytes(out)


def _pcx(idx: np.ndarray, planes: int, bits: int, stride: int,
         palette16=None) -> bytes:
    """A version 5 PCX file of (H, W) indices (bits 1: ``planes`` bit
    planes of the indices) or (H, W, planes) bytes (bits 8), each plane
    of a row ``stride`` bytes (the header says so)."""
    H, W = idx.shape[:2]
    rows = np.zeros((H, planes, stride), np.uint8)
    for p in range(planes):
        if bits == 1:
            plane = np.packbits((idx >> p) & 1, axis=1)
        else:
            plane = idx[..., p] if idx.ndim == 3 else idx
        rows[:, p, :plane.shape[1]] = plane
    head = bytearray(128)
    struct.pack_into('<BBBBHHHHHH', head, 0, 10, 5, 1, bits, 0, 0,
                     W - 1, H - 1, 72, 72)
    if palette16 is not None:
        head[16:64] = palette16.astype(np.uint8).tobytes()
    head[65] = planes
    struct.pack_into('<HH', head, 66, stride, 1)
    return bytes(head) + _pcx_rle(rows.reshape(H, -1))


def _raster_files(rgb: np.ndarray, pic: Image.Image, out: str) -> list:
    """Slice 17's DDS, QOI, SGI and PCX layouts and the picture's
    lossless copies in the four formats; their names."""
    H, W = rgb.shape[:2]
    rng = np.random.default_rng(17)
    colour = Image.fromarray(rgb)
    rgba = Image.fromarray(np.concatenate([rgb, rgb[..., 2:]], -1), 'RGBA')
    grey = Image.fromarray(rgb[..., 1])
    la = Image.fromarray(np.stack([rgb[..., 1], rgb[..., 0]], -1), 'LA')
    p64 = pic.convert('RGB')
    writes = {
        'picture64.qoi': (p64, 'QOI', {}),
        'picture64.sgi': (p64, 'SGI', {}),
        'picture64.pcx': (p64, 'PCX', {}),
        'picture64.dds': (p64, 'DDS', {}),
        'qoi_rgb.qoi': (colour, 'QOI', {}),
        'qoi_rgba.qoi': (rgba, 'QOI', {}),
        'sgi_rgb.sgi': (colour, 'SGI', {}),
        'sgi_rgba.sgi': (rgba, 'SGI', {}),
        'sgi_l.sgi': (grey, 'SGI', {}),
        'sgi_rgb16.sgi': (colour, 'SGI', {'bpc': 2}),
        'pcx_rgb.pcx': (colour, 'PCX', {}),
        'pcx_l.pcx': (grey, 'PCX', {}),
        'pcx_palette.pcx': (colour.quantize(64), 'PCX', {}),
        'pcx_1.pcx': (grey.convert('1'), 'PCX', {}),
        'dds_dxt1.dds': (rgba, 'DDS', {'pixel_format': 'DXT1'}),
        'dds_dxt3.dds': (rgba, 'DDS', {'pixel_format': 'DXT3'}),
        'dds_dxt5.dds': (rgba, 'DDS', {'pixel_format': 'DXT5'}),
        'dds_bc5.dds': (colour, 'DDS', {'pixel_format': 'BC5'}),
        'dds_rgb.dds': (colour, 'DDS', {}),
        'dds_rgba.dds': (rgba, 'DDS', {}),
        'dds_l.dds': (grey, 'DDS', {}),
        'dds_la.dds': (la, 'DDS', {}),
    }
    for name, (im, fmt, kw) in writes.items():
        im.save(os.path.join(out, name), fmt, **kw)
    made = {}
    for z, bpc in ((3, 1), (4, 1), (1, 2)):
        img = np.concatenate([rgb, rgb[..., :1]], -1)[..., :z].copy()
        img[2, 5:30] = 77                    # a long run in one row
        made[f'sgi_rle_{z}ch_{8 * bpc}bit.sgi'] = _sgi_rle(img, bpc)
    idx16 = (rgb[..., 0] // 16).astype(np.uint8)
    pal16 = rng.integers(0, 256, (16, 3))
    made['pcx_4bit_planar.pcx'] = _pcx(idx16, 4, 1, 6, pal16)
    made['pcx_2bit_planar.pcx'] = _pcx(idx16 & 3, 2, 1, 5, pal16)
    made['pcx_rgb_odd_stride.pcx'] = _pcx(rgb, 3, 8, W)
    made['pcx_l_padded.pcx'] = _pcx(rgb[..., 2], 1, 8, W + 1) + b'\x0c' + \
        bytes(np.repeat(np.arange(256), 3).astype(np.uint8))
    pal = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    made['dds_p.dds'] = bitmap_stages.dds_file(
        W, H, pal.tobytes() + rng.integers(0, 256, W * H).astype(
            np.uint8).tobytes(), pfflags=0x20, bitcount=8)
    px = rgb.astype(np.uint32)
    w565 = ((px[..., 0] >> 3) << 11) | ((px[..., 1] >> 2) << 5) | \
        (px[..., 2] >> 3)
    made['dds_rgb565.dds'] = bitmap_stages.dds_file(
        W, H, w565.astype('<u2').tobytes(), pfflags=0x40, bitcount=16,
        masks=(0xF800, 0x07E0, 0x001F))
    w4444 = ((px[..., 0] >> 4) << 8) | ((px[..., 1] >> 4) << 4) | \
        (px[..., 2] >> 4) | ((px[..., 0] >> 4) << 12)
    made['dds_argb4444.dds'] = bitmap_stages.dds_file(
        W, H, w4444.astype('<u2').tobytes(), pfflags=0x41, bitcount=16,
        masks=(0x0F00, 0x00F0, 0x000F, 0xF000))
    made['dds_dx10_rgba8.dds'] = bitmap_stages.dds_file(
        W, H, np.asarray(rgba).tobytes(), dxgi=28)
    blocks = -(-W // 4) * -(-H // 4)
    for cc, n in ((b'ATI1', 8), (b'BC4U', 8), (b'ATI2', 16), (b'BC5U', 16),
                  (b'BC5S', 16)):
        made[f'dds_{cc.decode().lower()}.dds'] = bitmap_stages.dds_file(
            W, H, rng.integers(0, 256, blocks * n).astype(
                np.uint8).tobytes(), fourcc=cc)
    for dxgi, tag in ((71, 'bc1'), (74, 'bc2'), (77, 'bc3'), (80, 'bc4'),
                      (84, 'bc5s'), (95, 'bc6h_uf16'), (96, 'bc6h_sf16'),
                      (98, 'bc7')):
        made[f'dds_dx10_{tag}.dds'] = bitmap_stages.bcn_random_dds(
            W, H, dxgi, 100 + dxgi)
    first = rng.integers(0, 256, blocks * 8).astype(np.uint8).tobytes()
    made['dds_dxt1_mipmaps.dds'] = bitmap_stages.dds_file(
        W, H, first + bytes(range(256)) * 2, fourcc=b'DXT1', mipmaps=6)
    for name, data in made.items():
        with open(os.path.join(out, name), 'wb') as f:
            f.write(data)
    return [*writes, *made]

def _j2k(im: Image.Image, **kw) -> bytes:
    """PIL's raw JPEG 2000 codestream of ``im``."""
    b = io.BytesIO()
    im.save(b, 'JPEG2000', no_jp2=True, **kw)
    return b.getvalue()


def _j2k_rewrite(cs: bytes, edit) -> bytes:
    """The codestream with its parts (``bitmap_stages.j2k_segments``)
    passed through ``edit``."""
    return bitmap_stages.j2k_join(edit(bitmap_stages.j2k_segments(cs)))


def _derived(parts):
    """The QCD of an irreversible stream as scalar derived: its LL band's
    step alone."""
    out = []
    for m, body in parts:
        if m == 0xFF5C:
            body = bytes([(body[0] & 0xE0) | 1]) + body[1:3]
        out.append((m, body))
    return out


def _wrong_cod(body: bytes) -> bytes:
    """A COD whose code-blocks are 32 x 32 (xcb, ycb of 3)."""
    return body[:6] + bytes([3, 3]) + body[8:]


def _wrong_qcd(body: bytes) -> bytes:
    """A QCD with one guard bit more."""
    return bytes([body[0] + 0x20]) + body[1:]


def _coc_qcc(parts):
    """The main header's COD and QCD made wrong, and a COC and QCC for
    each component carrying the right ones: decodes only where a COC or
    QCC outranks the COD or QCD."""
    out = []
    for m, body in parts:
        if m == 0xFF52:
            out.append((m, _wrong_cod(body)))
            for c in range(3):
                out.append((0xFF53, bytes([c, body[0] & 1]) + body[5:]))
        elif m == 0xFF5C:
            out.append((m, _wrong_qcd(body)))
            for c in range(3):
                out.append((0xFF5D, bytes([c]) + body))
        else:
            out.append((m, body))
    return out


def _tile_cod_qcd(parts):
    """The main header's COD and QCD made wrong (and a wrong COC for
    component 1), the right COD and QCD in the first part of each tile:
    a tile's COD outranks the main header's COD and COC."""
    cod = [b for m, b in parts if m == 0xFF52][0]
    qcd = [b for m, b in parts if m == 0xFF5C][0]
    out = []
    for m, body in parts:
        if m == 0xFF52:
            out += [(m, _wrong_cod(body)),
                    (0xFF53, bytes([1, body[0] & 1]) + _wrong_cod(body)[5:])]
        elif m == 0xFF5C:
            out.append((m, _wrong_qcd(body)))
        elif m == 0xFF93:
            out += [(0xFF52, cod), (0xFF5C, qcd), (m, body)]
        else:
            out.append((m, body))
    return out


def _tile_parts(cs: bytes) -> bytes:
    """A tiled two-layer LRCP stream with each tile cut into two parts at
    its second layer's first packet, every tile's first part before any
    second part, the second parts in reverse tile order, the last one's
    Psot 0 (it runs to EOC); TLM, PLM and CRG markers in the main
    header."""
    from mitsuba_nlvrl_tpu_torch.utils import j2k
    siz, params, tiles = j2k.parse(cs)
    parts = bitmap_stages.j2k_segments(cs)
    head = [p for p in parts if p[0] not in (0xFF90, 0xFF93, 0, 0xFFD9)]
    cuts = {}
    for t, (tp, data) in tiles.items():
        tcs = [j2k._tilecomp(siz, t, c, tp.cod_c[c], tp.qcd[c])
               for c in range(len(siz['comps']))]
        pos = 0
        for lay, r, c, k in j2k._progression(0, tp.cod['layers'], tcs):
            if lay == 1 and t not in cuts:
                cuts[t] = pos
            pos = j2k._packet(data, pos, tcs[c]['res'][r], k, lay,
                              tp.cod_c[c]['style'], tp.cod['sop'],
                              tp.cod['eph'])
    order = [(t, 0) for t in sorted(tiles)] + \
        [(t, 1) for t in sorted(tiles, reverse=True)]
    body, tlm = [], b''
    for n, (t, half) in enumerate(order):
        data = tiles[t][1]
        piece = data[:cuts[t]] if half == 0 else data[cuts[t]:]
        last = n == len(order) - 1
        body += [(0xFF90, struct.pack('>HIBB', t, 0 if last else 1, half,
                                      2)),
                 (0xFF93, b''), (0, piece)]
        tlm += struct.pack('>HI', t, 14 + len(piece))
    head = head[:2] + [(0xFF63, bytes(4 * len(siz['comps'])))] + head[2:]
    head.append((0xFF55, bytes([0, 0x60]) + tlm))
    head.append((0xFF57, bytes([0, 0])))
    return bitmap_stages.j2k_join(head + body + [(0xFFD9, b'')])


# opj_cparameters_t of openjpeg 2.5 on a 64-bit host: the byte offset of
# each field set here (``_openjpeg_params`` checks the defaults that
# ``opj_set_default_encoder_parameters`` writes at some of them)
_OPJ = dict(tile_size_on=0, cp_tx0=4, cp_ty0=8, cp_tdx=12, cp_tdy=16,
            cp_disto_alloc=20, csty=48, prog_order=52, poc=56, numpocs=4792,
            tcp_numlayers=4796, tcp_rates=4800, numresolution=5600,
            cblockw_init=5604, cblockh_init=5608, mode=5612,
            irreversible=5616, roi_compno=5620, roi_shift=5624,
            res_spec=5628, prcw_init=5632, prch_init=5764,
            image_offset_x0=18188, image_offset_y0=18192,
            subsampling_dx=18196, subsampling_dy=18200, tp_on=18696,
            tp_flag=18697, tcp_mct=18698)
_OPJ_POC_SIZE = 148                      # sizeof(opj_poc_t)


_openjpeg = None


def _openjpeg_lib() -> ctypes.CDLL:
    """The libopenjp2 that PIL bundles, its encoder's functions typed."""
    global _openjpeg
    if _openjpeg is not None:
        return _openjpeg
    path = glob.glob(os.path.join(os.path.dirname(Image.__file__), '..',
                                  'pillow.libs', 'libopenjp2*.so*'))[0]
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    for name, res, args in (
            ('opj_image_create', p, [ctypes.c_uint32, p, ctypes.c_int]),
            ('opj_create_compress', p, [ctypes.c_int]),
            ('opj_setup_encoder', ctypes.c_int, [p, p, p]),
            ('opj_stream_create_default_file_stream', p,
             [ctypes.c_char_p, ctypes.c_int]),
            ('opj_start_compress', ctypes.c_int, [p, p, p]),
            ('opj_encode', ctypes.c_int, [p, p]),
            ('opj_end_compress', ctypes.c_int, [p, p]),
            ('opj_stream_destroy', None, [p]),
            ('opj_destroy_codec', None, [p]),
            ('opj_image_destroy', None, [p]),
            ('opj_set_default_encoder_parameters', None, [p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _openjpeg = lib
    return lib


def openjpeg_write(path: str, pixels: np.ndarray, prec=8, sgnd=False,
                   space: int = 1, **params) -> None:
    """A raw JPEG 2000 codestream of ``pixels`` ((H, W, C) integers),
    written by PIL's bundled libopenjp2 through ctypes with the encoder
    settings PIL's ``save`` hides: ``prec`` one precision or one a
    component, ``space`` openjpeg's colour space (1 sRGB, 2 grey), and
    in ``params`` fields of ``_OPJ`` (``mode``: the code-block style;
    ``csty``: 2 SOP, 4 EPH; ``roi_compno`` and ``roi_shift``; ``tp_on``
    and ``tp_flag``: tile parts) or ``rates`` (a layer each, lossless
    0), ``pocs`` ((first resolution, first component, layers,
    resolutions, components, order) each) and ``precincts`` ((width,
    height) exponents' sizes from the highest resolution down)."""
    lib = _openjpeg_lib()
    H, W, C = pixels.shape
    buf = ctypes.create_string_buffer(1 << 15)
    lib.opj_set_default_encoder_parameters(buf)
    want = {'numresolution': 6, 'cblockw_init': 64, 'cblockh_init': 64,
            'roi_compno': -1, 'subsampling_dx': 1, 'subsampling_dy': 1}
    for name, v in want.items():
        assert struct.unpack_from('<i', buf, _OPJ[name])[0] == v, name

    def put(name, v, fmt='<i', at=0):
        struct.pack_into(fmt, buf, _OPJ[name] + at, v)
    put('numresolution', 5)
    rates = params.pop('rates', [0.0])
    put('tcp_numlayers', len(rates))
    put('cp_disto_alloc', 1)
    for i, r in enumerate(rates):
        put('tcp_rates', r, '<f', 4 * i)
    for i, poc in enumerate(params.pop('pocs', ())):
        at = _OPJ['poc'] + _OPJ_POC_SIZE * i
        struct.pack_into('<6I', buf, at, *poc[:5], 0)
        struct.pack_into('<i', buf, at + 32, poc[5])
        struct.pack_into('<I', buf, at + 48, 1)          # tile 1 (0)
        put('numpocs', i + 1)
    prc = params.pop('precincts', ())
    if prc:
        params['csty'] = params.get('csty', 0) | 1
        put('res_spec', len(prc))
        for i, (pw, ph) in enumerate(prc):
            put('prcw_init', pw, at=4 * i)
            put('prch_init', ph, at=4 * i)
    for name, v in params.items():
        put(name, v, '<b' if name in ('tp_on', 'tp_flag', 'tcp_mct') else
            '<i')

    class Comp(ctypes.Structure):
        _fields_ = [(n, ctypes.c_uint32) for n in
                    ('dx', 'dy', 'w', 'h', 'x0', 'y0', 'prec', 'bpp', 'sgnd')]
    precs = prec if isinstance(prec, (list, tuple)) else [prec] * C
    comps = (Comp * C)(*[Comp(1, 1, W, H, 0, 0, precs[c], precs[c],
                              int(sgnd)) for c in range(C)])
    image = lib.opj_image_create(C, comps, space)
    # opj_image_t: x0, y0, x1, y1, numcomps, color_space, then comps; each
    # opj_image_comp_t 64 bytes, its data pointer at 48
    struct.pack_into('<IIII', (ctypes.c_char * 16).from_address(image), 0,
                     0, 0, W, H)
    first = ctypes.c_void_p.from_address(image + 24).value
    for c in range(C):
        data = ctypes.c_void_p.from_address(first + 64 * c + 48).value
        plane = np.ascontiguousarray(pixels[..., c], np.int32)
        ctypes.memmove(data, plane.ctypes.data, plane.nbytes)
    codec = lib.opj_create_compress(0)                  # OPJ_CODEC_J2K
    ok = lib.opj_setup_encoder(codec, buf, image)
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
    ok = ok and lib.opj_start_compress(codec, image, stream) and \
        lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream)
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(image)
    assert ok, f"openjpeg could not write {path}"


def _openjpeg_files(rgb: np.ndarray, out: str) -> list:
    """Slice 18's codestreams that only openjpeg's own settings write:
    each code-block style alone and all six, SOP and EPH markers, tile
    parts by resolution, RGN, POC, and components of other precisions
    (QCC); their names."""
    rgb = rgb.astype(np.int64)
    writes = {f'j2k_style_{tag}.j2k': (rgb, {'mode': bit}) for tag, bit in (
        ('bypass', 1), ('reset', 2), ('termall', 4), ('vcausal', 8),
        ('pterm', 16), ('segsym', 32), ('all', 63))}
    writes.update({
        'j2k_style_all_irreversible.j2k': (rgb, {'mode': 63,
                                                 'irreversible': 1}),
        'j2k_style_bypass_layers.j2k': (rgb, {'mode': 1, 'rates': [40, 10]}),
        'j2k_sop_eph.j2k': (rgb, {'csty': 6, 'rates': [40, 10]}),
        'j2k_tile_parts_by_resolution.j2k': (rgb, {
            'tp_on': 1, 'tp_flag': ord('R'), 'tile_size_on': 1,
            'cp_tdx': 16, 'cp_tdy': 16}),
        'j2k_rgn.j2k': (rgb, {'roi_compno': 0, 'roi_shift': 5}),
        'j2k_rgn_irreversible.j2k': (rgb, {'roi_compno': 2, 'roi_shift': 9,
                                           'irreversible': 1}),
        'j2k_poc.j2k': (rgb, {'pocs': [(0, 0, 1, 3, 3, 1),
                                       (3, 0, 1, 5, 3, 4)]}),
        'j2k_poc_layers_precincts.j2k': (rgb, {
            'pocs': [(0, 0, 2, 2, 2, 0), (0, 2, 2, 5, 3, 2),
                     (2, 0, 2, 5, 2, 3)],
            'rates': [30, 8], 'precincts': [(4, 4)] * 5}),
    })
    for name, (px, kw) in writes.items():
        openjpeg_write(os.path.join(out, name), px, **kw)
    shifted = np.stack([rgb[..., 0], rgb[..., 1] * 16 + rgb[..., 2] % 16,
                        rgb[..., 2] // 16], -1)
    made = {'j2k_precisions.j2k': (shifted, {'prec': [8, 12, 4]}),
            'j2k_l12.j2k': (shifted[..., 1:2], {'prec': 12, 'space': 2}),
            'j2k_l4_irreversible.j2k': (shifted[..., 2:], {
                'prec': 4, 'space': 2, 'irreversible': 1}),
            'j2k_la_signed.j2k': (rgb[..., :2] - 128, {
                'sgnd': True, 'space': 2, 'prec': 8})}
    for name, (px, kw) in made.items():
        openjpeg_write(os.path.join(out, name), px, **kw)
    return [*writes, *made]


def _jpeg2000_files(rgb: np.ndarray, pic: Image.Image, out: str) -> list:
    """Slice 18's JPEG 2000 layouts: every option PIL's writer has, in
    each mode it writes, and the files written here around PIL's
    codestreams (palettes, channel definitions, colour spaces, derived
    quantisation, COC and QCC, tile-part headers, tile parts in any
    order); their names."""
    H, W = rgb.shape[:2]
    a = rgb.astype(np.uint16)
    modes = {
        'l': Image.fromarray(rgb[..., 1]),
        'la': Image.fromarray(np.stack([rgb[..., 1], rgb[..., 0]], -1),
                              'LA'),
        'rgb': Image.fromarray(rgb),
        'rgba': Image.fromarray(np.concatenate([rgb, rgb[..., 2:]], -1),
                                'RGBA'),
        'i16': Image.fromarray(((a[..., 0] << 8) | a[..., 1]).astype('<u2')),
        'cmyk': Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1),
                                'CMYK'),
    }
    writes = {'picture64.jp2': (pic.convert('RGB'), {})}
    for tag, im in modes.items():
        writes[f'jp2_{tag}.jp2'] = (im, {})
        writes[f'jp2_{tag}_irreversible.jp2'] = (im, {'irreversible': True})
        writes[f'j2k_{tag}.j2k'] = (im, {'no_jp2': True})
    colour = modes['rgb']
    for name, kw in {
            'jp2_layers_rates.jp2': {'quality_mode': 'rates',
                                     'quality_layers': [40, 20, 10]},
            'jp2_layers_db_irreversible.jp2': {
                'quality_mode': 'dB', 'quality_layers': [30, 40, 50],
                'irreversible': True},
            'jp2_tiles.jp2': {'tile_size': (16, 8)},
            'jp2_tiles_irreversible_mct.jp2': {
                'tile_size': (16, 8), 'irreversible': True, 'mct': 1},
            'jp2_offset.jp2': {'offset': (3, 5), 'tile_offset': (2, 4),
                               'tile_size': (40, 28)},
            'jp2_offset_tiles.jp2': {'offset': (3, 5), 'tile_offset': (1, 2),
                                     'tile_size': (8, 8)},
            'jp2_resolutions_1.jp2': {'num_resolutions': 1},
            'jp2_resolutions_3_irreversible.jp2': {'num_resolutions': 3,
                                                   'irreversible': True},
            'jp2_codeblock_4x4.jp2': {'codeblock_size': (4, 4)},
            'jp2_codeblock_16x8_irreversible.jp2': {
                'codeblock_size': (16, 8), 'irreversible': True},
            'jp2_precinct_16x8.jp2': {'precinct_size': (16, 8),
                                      'codeblock_size': (4, 4),
                                      'num_resolutions': 3},
            'jp2_precinct_offset_tiles.jp2': {
                'precinct_size': (4, 4), 'num_resolutions': 2,
                'offset': (3, 5), 'tile_offset': (1, 2), 'tile_size': (9, 11)},
            'jp2_rlcp.jp2': {'progression': 'RLCP', 'quality_mode': 'rates',
                             'quality_layers': [40, 20]},
            'jp2_rpcl.jp2': {'progression': 'RPCL', 'precinct_size': (16, 16),
                             'codeblock_size': (4, 4)},
            'jp2_pcrl.jp2': {'progression': 'PCRL', 'precinct_size': (16, 16),
                             'codeblock_size': (4, 4)},
            'jp2_cprl.jp2': {'progression': 'CPRL', 'precinct_size': (16, 16),
                             'codeblock_size': (4, 4)},
            'jp2_rpcl_offset_tiles.jp2': {
                'progression': 'RPCL', 'precinct_size': (8, 8),
                'num_resolutions': 3, 'offset': (3, 5),
                'tile_offset': (1, 2), 'tile_size': (13, 9)},
            'jp2_pcrl_offset_layers.jp2': {
                'progression': 'PCRL', 'precinct_size': (16, 16),
                'codeblock_size': (4, 4), 'offset': (3, 5),
                'tile_offset': (1, 2), 'tile_size': (16, 16),
                'quality_mode': 'rates', 'quality_layers': [30, 10]},
            'jp2_cprl_offset_tiles.jp2': {
                'progression': 'CPRL', 'precinct_size': (16, 16),
                'codeblock_size': (4, 4), 'offset': (5, 1),
                'tile_offset': (3, 0), 'tile_size': (20, 20)},
            'jp2_mct.jp2': {'mct': 1},
            'jp2_mct_irreversible.jp2': {'mct': 1, 'irreversible': True},
            'jp2_signed.jp2': {'signed': True},
            'jp2_signed_irreversible.jp2': {'signed': True,
                                            'irreversible': True},
            'j2k_plt.j2k': {'no_jp2': True, 'plt': True},
            'jp2_comment.jp2': {'comment': 'a texture'}}.items():
        writes[name] = (colour, kw)
    writes['jp2_i16_signed.jp2'] = (modes['i16'], {'signed': True})
    writes['jp2_l_signed_irreversible.jp2'] = (modes['l'], {
        'signed': True, 'irreversible': True})
    for name, (im, kw) in writes.items():
        im.save(os.path.join(out, name), 'JPEG2000', **kw)
    made = {}
    box, jp2 = bitmap_stages.jp2_box, bitmap_stages.jp2_file
    idx = (rgb[..., 0] % 12).astype(np.uint8)
    pal = np.random.default_rng(18).integers(0, 256, (12, 3), dtype=np.uint8)
    pal[7] = pal[2]                      # a repeat: PIL keeps the first
    pclr = box(b'pclr', struct.pack('>HB', 12, 3) + bytes([7, 7, 7]) +
               pal.tobytes())
    cmap = box(b'cmap', bytes([0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 2]))
    made['jp2_pclr.jp2'] = jp2(_j2k(Image.fromarray(idx)), 1, 7, W, H, 16,
                               pclr + cmap)
    made['jp2_pclr_alpha.jp2'] = jp2(_j2k(Image.fromarray(
        np.stack([idx, rgb[..., 2]], -1), 'LA')), 2, 7, W, H, 16,
        pclr + box(b'cmap', bytes([0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 2, 0, 1,
                                   0, 0])))
    cdef = box(b'cdef', struct.pack('>H9H', 3, 0, 0, 3, 1, 0, 2, 2, 0, 1))
    made['jp2_cdef.jp2'] = jp2(_j2k(colour), 3, 7, W, H, 16, cdef)
    made['jp2_colr_unknown.jp2'] = jp2(_j2k(colour), 3, 7, W, H, 20)
    made['j2k_derived.j2k'] = _j2k_rewrite(_j2k(colour, irreversible=True),
                                           _derived)
    made['j2k_coc_qcc.j2k'] = _j2k_rewrite(_j2k(colour), _coc_qcc)
    made['j2k_coc_qcc_irreversible.j2k'] = _j2k_rewrite(
        _j2k(colour, irreversible=True, mct=1), _coc_qcc)
    made['j2k_tile_cod_qcd.j2k'] = _j2k_rewrite(
        _j2k(colour, tile_size=(16, 16)), _tile_cod_qcd)
    made['j2k_tile_parts.j2k'] = _tile_parts(_j2k(
        colour, tile_size=(16, 8), quality_mode='rates',
        quality_layers=[40, 10]))
    for name, data in made.items():
        with open(os.path.join(out, name), 'wb') as f:
            f.write(data)
    return [*writes, *made]


def _icon_files(rgb: np.ndarray, pic: Image.Image, out: str) -> list:
    """Slice 18's ICO, CUR and ICNS files: PIL's own ICO (PNG and BMP
    icons), ICO and CUR files of DIB icons at each depth with their AND
    masks, ICNS files of JPEG 2000 icons and of the legacy RLE icons with
    their masks; their names."""
    H, W = rgb.shape[:2]
    rng = np.random.default_rng(180)
    rgba = Image.fromarray(np.concatenate([rgb, rgb[..., 2:]], -1), 'RGBA')
    writes = {
        'picture64.ico': (pic.convert('RGB'), {'sizes': [(64, 64)]}),
        'ico_png_rgba.ico': (rgba, {'sizes': [(16, 16), (37, 23)]}),
        'ico_bmp_pil.ico': (rgba, {'sizes': [(16, 16), (37, 23)],
                                   'bitmap_format': 'bmp'}),
    }
    for name, (im, kw) in writes.items():
        im.save(os.path.join(out, name), 'ICO', **kw)
    mask = ((np.add.outer(np.arange(H), np.arange(W)) // 5) % 2).astype(
        np.uint8)
    entries = {}
    for bits in (1, 4, 8):
        n = 1 << bits
        idx = (rgb[..., 0].astype(int) * n // 256).astype(np.uint8)
        pal = rng.integers(0, 256, (n, 3))
        entries[bits] = (W, H, n & 255, bits,
                         bitmap_stages.dib(idx, bits, pal, mask))
    entries[24] = (W, H, 0, 24, bitmap_stages.dib(rgb, 24, mask=mask))
    rgba32 = np.concatenate([rgb, (rgb[..., 1:2] // 2) + 64], -1)
    entries[32] = (W, H, 0, 32, bitmap_stages.dib(rgba32, 32, mask=mask))
    made = {}
    for bits, e in entries.items():
        made[f'ico_bmp_{bits}.ico'] = bitmap_stages.icon_file([e])
        made[f'cur_{bits}.cur'] = bitmap_stages.icon_file([e], cursor=True)
    # a 32-bit DIB that the directory calls 0 bits: its alpha from the
    # AND mask
    made['ico_bmp_32_bpp0.ico'] = bitmap_stages.icon_file(
        [entries[32][:3] + (0,) + entries[32][4:]])
    small = rgb[:16, :16]
    tile = (small[..., 1] // 16).astype(np.uint8)
    pal = rng.integers(0, 256, (16, 3))
    # PIL opens the largest, of the equal ones the shallowest
    made['ico_sorted.ico'] = bitmap_stages.icon_file([
        (16, 16, 0, 8, bitmap_stages.dib(tile, 8, pal, mask[:16, :16])),
        (24, 8, 0, 24, bitmap_stages.dib(rgb[:8, :24], 24,
                                         mask=mask[:8, :24])),
        (16, 16, 16, 4, bitmap_stages.dib(tile, 4, pal, mask[:16, :16]))])
    # the first cursor, replaced by each later one larger in both sizes
    made['cur_largest.cur'] = bitmap_stages.icon_file([
        (16, 16, 0, 24, bitmap_stages.dib(small, 24, mask=mask[:16, :16])),
        (W, H, 0, 24, entries[24][4]),
        (16, 20, 0, 24, bitmap_stages.dib(rgb[:20, :16], 24,
                                          mask=mask[:20, :16]))],
        cursor=True)
    # ICNS: a JP2 icon of the 64x64 picture, a raw codestream, and the
    # legacy 24-bit icons, run-length coded or raw, with and without masks
    b = io.BytesIO()
    pic.convert('RGB').save(b, 'JPEG2000')
    made['icns_jp2.icns'] = bitmap_stages.icns_file([(b'icp6', b.getvalue())])
    made['icns_j2k_l.icns'] = bitmap_stages.icns_file(
        [(b'icp5', _j2k(Image.fromarray(rgb[..., 1]).resize((32, 32))))])

    def icon(n, k=0):
        yy, xx = np.mgrid[0:n, 0:n]
        return np.stack([(xx // 4 * 40 + k) % 256, (yy // 4 * 30) % 256,
                         ((xx + yy) // 8 * 50) % 256], -1).astype(np.uint8)

    def rle(img):
        return b''.join(bitmap_stages.icns_rle(img[..., c]) for c in range(3))

    def alpha(n):
        return ((np.add.outer(np.arange(n), np.arange(n)) * 7) % 256).astype(
            np.uint8).tobytes()
    made['icns_is32.icns'] = bitmap_stages.icns_file(
        [(b'is32', rle(icon(16))), (b's8mk', alpha(16))])
    made['icns_il32_raw.icns'] = bitmap_stages.icns_file(
        [(b'il32', icon(32, 9).tobytes()), (b'l8mk', alpha(32)),
         (b'is32', rle(icon(16)))])
    made['icns_ih32.icns'] = bitmap_stages.icns_file(
        [(b'ih32', rle(icon(48, 3)))])
    made['icns_it32.icns'] = bitmap_stages.icns_file(
        [(b'it32', bytes(4) + rle(icon(128, 5))), (b'ih32', rle(icon(48)))])
    for name, data in made.items():
        with open(os.path.join(out, name), 'wb') as f:
            f.write(data)
    return [*writes, *made]


def _rest_files(rgb: np.ndarray, pic: Image.Image, out: str) -> list:
    """The rest of PIL's raster formats (``testing/raster_files`` writes
    those PIL cannot): Sun raster at every depth, raw and RLE, with a
    colour map; BLP1 and BLP2 palettes (PIL's and at alpha depths 0, 1, 4
    and 8), BLP1 JPEG and BLP2 DXT1, DXT3 and DXT5; FTEX; FITS at every
    BITPIX and GZIP_1; SPIDER in both byte orders (PIL writes its host's)
    and a stack; IM of
    every mode PIL writes and the planar, 2- and 4-bit, LUT and bit-packed
    types it reads; IMT; MSP versions 1 and 2; FLI and FLC chunks; XBM;
    XPM; GBR; McIDAS; PIXAR; an XV thumbnail; DCX; IPTC; and the picture
    as a 24-bit RLE Sun raster and an RGB IM file. Their names."""
    R = raster_files
    rng = np.random.default_rng(20)
    H, W = rgb.shape[:2]
    grey = rgb[..., 1]
    idx = (rgb[..., 0] // 4).astype(np.uint8)            # 64 levels
    bits = (grey >= 128).astype(np.uint8)
    colours = rng.integers(0, 256, (256, 3))
    rgba = np.concatenate([rgb, rgb[..., 2:]], -1)
    f32 = rgb[..., 0].astype(np.float32) * 1.5 - 60.0
    f32[0, :4] = (254.6, 0.6, np.nan, -3.0)
    p64 = np.asarray(pic.convert('RGB'))
    made = {
        'sun_1.ras': R.sun_file(bits, 1),
        'sun_1_rle.ras': R.sun_file(bits, 1, 2),
        'sun_4.ras': R.sun_file(idx & 15, 4),
        'sun_4_palette_rle.ras': R.sun_file(idx & 15, 4, 2,
                                            colours=colours[:16]),
        'sun_8.ras': R.sun_file(grey, 8),
        'sun_8_rle.ras': R.sun_file(grey // 16 * 16, 8, 2),
        'sun_8_palette.ras': R.sun_file(idx, 8, 1, colours=colours[:64]),
        'sun_24_bgr.ras': R.sun_file(rgb, 24),
        'sun_24_rgb_type3.ras': R.sun_file(rgb, 24, 3),
        'sun_32_rle.ras': R.sun_file(rgba, 32, 2),
        'sun_32_rgb_type3.ras': R.sun_file(rgba, 32, 3),
        'picture64.ras': R.sun_file(p64, 24, 2),
        'ftex_dxt1.ftc': R.ftex_file(W, H, 0, rng.integers(
            0, 256, -(-W // 4) * -(-H // 4) * 8, dtype=np.uint8).tobytes()),
        'ftex_rgb.ftu': R.ftex_file(W, H, 1, rgb.tobytes()),
        'fits_8.fits': R.fits_file(grey, 8),
        'fits_16.fits': R.fits_file(grey.astype(np.int64) * 3 - 100, 16),
        'fits_32.fits': R.fits_file(grey.astype(np.int64) * 5 - 300, 32),
        'fits_f32.fits': R.fits_file(f32, -32),
        'fits_f64.fits': R.fits_file(f32.astype(np.float64), -64),
        'fits_gzip_8.fits': R.fits_file(grey, 8, gzip_tile=True),
        'fits_gzip_16.fits': R.fits_file(grey.astype(np.int64) * 2, 16,
                                         gzip_tile=True),
        'imt.imt': R.imt_file(grey),
        'msp_v2.msp': R.msp_file(bits),
        'xpm_palette.xpm': R.xpm_file(idx, [
            '#%02x%02x%02x' % tuple(c) for c in colours[:64]]),
        'xpm_rgb.xpm': R.xpm_file(
            (rgb[..., 0].astype(np.int64) * 300) // 256, [
                '#%06x' % v for v in rng.integers(0, 1 << 24, 300)],
            pixels_comment=False),
        'gbr_v1.gbr': R.gbr_file(grey, 1),
        'gbr_v2_grey.gbr': R.gbr_file(grey, 2),
        'gbr_v2_rgba.gbr': R.gbr_file(rgba, 2),
        'mcidas_8.area': R.mcidas_file(grey, 1),
        'mcidas_16.area': R.mcidas_file(grey.astype(np.int64) * 3, 2,
                                        prefix=4),
        'mcidas_32.area': R.mcidas_file(grey.astype(np.int64) * 7 - 500, 4,
                                        prefix=8, bands=2),
        'pixar.pxr': R.pixar_file(rgb),
        'xvthumb.xv': R.xvthumb_file(idx * 4),
        'iptc_grey.iim': R.iptc_file(grey.tobytes(), W, H),
        'iptc_rgb_band.iim': R.iptc_file(grey.tobytes(), W, H, 3, 1,
                                         band=2),
    }
    jpeg = io.BytesIO()
    Image.fromarray(grey).save(jpeg, 'JPEG', quality=90)
    made['iptc_jpeg.iim'] = R.iptc_file(jpeg.getvalue(), W, H,
                                        compression=5)
    # FLI/FLC: a 256-colour (FLC) and a 64-level (FLI) palette, each chunk
    a, b = idx.copy(), idx.copy()
    b[2:8, 4:30] = 63
    b[15, :] = 7
    c = b.copy()
    c[10:13, 2:36] = 40
    c[20, 36] = 5
    F, C = R.fli_frame, R.fli_chunk
    made.update({
        'fli_brun_colour64.fli': R.fli_file(W, H, [F([
            R.fli_colour(colours[:64] >> 2 << 2, 2), R.fli_brun(a)])],
            0xAF11),
        'flc_lc_ss2.flc': R.fli_file(W, H, [F([
            R.fli_colour(colours), R.fli_brun(a), R.fli_lc(a, b),
            R.fli_ss2(b, c)])]),
        'flc_copy_black_pstamp.flc': R.fli_file(W - 1, H, [F([
            C(18, bytes(40)), R.fli_colour(colours[:100], skip=30),
            C(13, b''), C(16, c[:, :W - 1].tobytes())])]),
        'flc_ss2_even_width.flc': R.fli_file(W - 1, H, [F([
            R.fli_colour(colours), R.fli_brun(a[:, :W - 1]),
            R.fli_ss2(a[:, :W - 1], c[:, :W - 1])])]),
    })
    # IM types PIL reads but does not write
    lut = colours.T.astype(np.uint8).tobytes()
    ramp = np.tile(np.arange(255, -1, -1, dtype=np.uint8), 3).tobytes()
    planar = np.ascontiguousarray(np.moveaxis(rgb[::-1], -1, 0))
    packed12 = np.zeros((H, (W * 12 + 7) // 8), np.uint8)
    for y in range(H):                 # 12-bit samples, LSB first, rows up
        acc = 0
        for x in range(W):
            acc |= (int(grey[H - 1 - y, x]) * 16 + (x & 15)) << (12 * x)
        packed12[y] = np.frombuffer(acc.to_bytes(packed12.shape[1],
                                                 'little'), np.uint8)
    made.update({
        'im_rgb3_planar.im': R.im_file('RGB3', W, H, planar.tobytes()),
        'im_b2.im': R.im_file('B2', W, H, np.packbits(
            np.unpackbits(idx[::-1, :, None] & 3, axis=2)[..., 6:].reshape(
                H, -1), axis=1).tobytes()),
        # a colour LUT makes PIL read a B4 image a byte a pixel
        'im_b4_lut.im': R.im_file('B4', W, H, idx[::-1].tobytes(), lut=lut),
        'im_grey_lut_palette.im': R.im_file('Greyscale', W, H,
                                            idx[::-1].tobytes(), lut=lut),
        'im_grey_lut_ramp.im': R.im_file('Greyscale', W, H,
                                         grey[::-1].tobytes(), lut=ramp),
        'im_la_lut.im': R.im_file('LA', W, H, np.concatenate(
            [idx[::-1], grey[::-1]], 1).tobytes(), lut=lut),
        'im_f8s.im': R.im_file('L 8S', W, H, rgb[::-1, :, 0].tobytes()),
        'im_f16.im': R.im_file('L 16S', W, H, (grey[::-1].astype('<i2') *
                                                3 - 200).tobytes()),
        'im_l12_bits.im': R.im_file('L*12', W, H, packed12.tobytes()),
        'im_ycc.im': R.im_file('YCC', W, H, np.moveaxis(np.asarray(
            Image.fromarray(rgb).convert('YCbCr'))[::-1], -1, 1).tobytes()),
        'im_comments.im': R.im_file('RGB', W, H, np.moveaxis(
            rgb[::-1], -1, 1).tobytes(), extra=[
            b'Comment: made by numpy', b'Name: layout', b'Comment: two',
            b'File size (no of images): 1', b'Scale (x,y): 1*1']),
        'dcx_rgb.dcx': None, 'dcx_palette.dcx': None,
    })
    pcx_rgb, pcx_pal = io.BytesIO(), io.BytesIO()
    Image.fromarray(rgb).save(pcx_rgb, 'PCX')
    Image.fromarray(rgb).quantize(64).save(pcx_pal, 'PCX')
    made['dcx_rgb.dcx'] = R.dcx_file([pcx_rgb.getvalue(),
                                      pcx_pal.getvalue()])
    made['dcx_palette.dcx'] = R.dcx_file([pcx_pal.getvalue()])
    palette = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    for depth in (0, 1, 4, 8):
        made[f'blp2_palette_alpha{depth}.blp'] = R.blp_file(
            2, W, H, idx.tobytes(), alpha=depth, palette=palette)
        made[f'blp1_palette_alpha{depth}.blp'] = R.blp_file(
            1, W, H, idx.tobytes(), alpha=depth, palette=palette, encoding=5)
    for ae, size, name in ((0, 8, 'dxt1'), (1, 16, 'dxt3'), (7, 16, 'dxt5')):
        for depth in ((0, 1) if ae == 0 else (8,)):
            made[f'blp2_{name}_alpha{depth}.blp'] = R.blp_file(
                2, W, H, rng.integers(0, 256, -(-W // 4) * -(-H // 4) * size,
                                      dtype=np.uint8).tobytes(),
                encoding=2, alpha=depth, alpha_encoding=ae)
    jpeg = io.BytesIO()
    Image.fromarray(rgb).save(jpeg, 'JPEG', quality=90)
    sos = jpeg.getvalue().find(b'\xff\xda')
    for depth in (0, 8):
        made[f'blp1_jpeg_alpha{depth}.blp'] = R.blp_file(
            1, W, H, jpeg.getvalue()[sos:], compression=0, alpha=depth,
            jpeg_header=jpeg.getvalue()[:sos])
    for name, data in made.items():
        with open(os.path.join(out, name), 'wb') as f:
            f.write(data)
    colour = Image.fromarray(rgb)
    writes = {
        'blp1_pil.blp': (colour.quantize(60), 'BLP', {'blp_version': 'BLP1'}),
        'blp2_pil.blp': (colour.quantize(60), 'BLP', {}),
        'blp2_pil_rgba.blp': (Image.fromarray(rgba, 'RGBA').quantize(60),
                              'BLP', {}),
        'spider.spi': (Image.fromarray(f32), 'SPIDER', {}),
        'msp_v1.msp': (Image.fromarray(bits.astype(bool)), 'MSP', {}),
        'xbm.xbm': (Image.fromarray(bits.astype(bool)), 'XBM', {}),
        'xbm_hotspot.xbm': (Image.fromarray(bits.astype(bool)), 'XBM',
                            {'hotspot': (3, 4)}),
        'picture64.im': (pic.convert('RGB'), 'IM', {}),
    }
    for mode in ('1', 'L', 'LA', 'P', 'PA', 'I', 'F', 'RGB', 'RGBA', 'RGBX',
                 'CMYK', 'YCbCr', 'I;16', 'I;16B', 'I;16L'):
        im = colour.quantize(50) if mode in ('P', 'PA') else None
        if mode == 'PA':
            im = im.convert('PA')
        if im is None:
            raw = rng.integers(0, 256, W * H * 8, dtype=np.uint8).tobytes()
            im = Image.frombytes(mode, (W, H), raw)
        tag = mode.lower().replace(';', '')
        writes[f'im_pil_{tag}.im'] = (im, 'IM', {})
    for name, (im, fmt, kw) in writes.items():
        im.save(os.path.join(out, name), fmt, **kw)
    # SPIDER big-endian and a two-image stack, from PIL's (native order)
    with open(os.path.join(out, 'spider.spi'), 'rb') as f:
        spi = f.read()
    hdr = int(struct.unpack('<27f', spi[:108])[21])
    t = list(struct.unpack(f'<{hdr // 4}f', spi[:hdr]))
    body = np.frombuffer(spi, '<f4', offset=hdr)
    with open(os.path.join(out, 'spider_be.spi'), 'wb') as f:
        f.write(struct.pack(f'>{len(t)}f', *t) + body.astype('>f4').tobytes())
    t[23], t[25] = 2.0, 2.0                    # istack, maxim
    img = list(t)
    img[23], img[26] = 0.0, 1.0                # each image's own header
    with open(os.path.join(out, 'spider_stack.spi'), 'wb') as f:
        f.write(struct.pack(f'<{len(t)}f', *t) +
                struct.pack(f'<{len(img)}f', *img) + body.tobytes() +
                struct.pack(f'<{len(img)}f', *img) +
                (body[::-1] * 0.5).astype('<f4').tobytes())
    return [*made, *writes, 'spider_be.spi', 'spider_stack.spi']


# the files of the rest of PIL's raster formats PIL refuses, and the six it
# opens and cannot load
def _rest_refused_files(rgb: np.ndarray) -> dict:
    R = raster_files
    H, W = rgb.shape[:2]
    grey = rgb[..., 1]
    bits = (grey >= 128).astype(np.uint8)
    sun8 = R.sun_file(grey, 8, 2)
    rows = R.msp_rows(bits)
    rows[3] = rows[3][:-1]
    fli = R.fli_file(W, H, [R.fli_frame([R.fli_brun(grey)])])
    xbm = io.BytesIO()
    Image.fromarray(bits.astype(bool)).save(xbm, 'XBM')
    xpm = R.xpm_file(grey // 64, ['#000000', '#555555', '#aaaaaa',
                                  '#ffffff'])
    return {
        **{f'stub.{fmt.lower()}': R.stub_file(fmt) for fmt in (
            'BUFR', 'GRIB', 'HDF5', 'MPEG', 'EPS', 'WMF')},
        'sun_depth16.ras': sun8[:12] + struct.pack('>I', 16) + sun8[16:],
        'sun_type7.ras': sun8[:20] + struct.pack('>I', 7) + sun8[24:],
        'sun_rle_truncated.ras': sun8[:-20],
        'sun_rgb_colour_map.ras': R.sun_file(rgb, 24, 1,
                                             colours=rgb[0, :10]),
        'blp2_encoding3.blp': R.blp_file(2, W, H, bytes(1000), encoding=3),
        'blp2_alpha_encoding3.blp': R.blp_file(
            2, W, H, bytes(1000), encoding=2, alpha_encoding=3),
        'blp2_palette_truncated.blp': R.blp_file(
            2, W, H, grey.tobytes())[:-30],
        'ftex_two_formats.ftc': R.ftex_file(W, H, 1, rgb.tobytes(),
                                            formats=2),
        'ftex_format3.ftc': R.ftex_file(W, H, 3, rgb.tobytes()),
        'fits_gzip_float.fits': R.fits_file(grey.astype(np.float32), -32,
                                            gzip_tile=True),
        'fits_truncated.fits': R.fits_file(grey, 8)[:2880 + 400],
        'im_rlb.im': R.im_file('RLB', W, H, rgb.tobytes()),
        'im_truncated.im': R.im_file('Greyscale', W, H, grey.tobytes()[:99]),
        'imt_no_form_feed.imt': R.imt_file(grey).replace(b'\x0c', b'\n'),
        'msp_v2_short_row.msp': R.msp_file(bits, rows),
        'msp_bad_checksum.msp': R.msp_file(bits)[:24] + b'\1\0' +
        R.msp_file(bits)[26:],
        'flc_prefix_chunk.flc': R.fli_file(W, H, [
            R.fli_frame([], 0xF100), R.fli_frame([R.fli_brun(grey)])]),
        'flc_unknown_chunk.flc': R.fli_file(W, H, [R.fli_frame([
            R.fli_chunk(99, bytes(10))])]),
        'flc_truncated.flc': fli[:-50],
        'xbm_truncated.xbm': xbm.getvalue()[:-40],
        'xpm_colour_name.xpm': xpm.replace(b'#000000', b'black'),
        'xpm_none_used.xpm': xpm.replace(b'#000000', b'None'),
        'gbr_truncated.gbr': R.gbr_file(grey, 2)[:-9],
        'mcidas_depth3.area': R.mcidas_file(grey, 1)[:40] +
        struct.pack('>i', 3) + R.mcidas_file(grey, 1)[44:],
        'pixar_truncated.pxr': R.pixar_file(rgb)[:-9],
        'xvthumb_truncated.xv': R.xvthumb_file(grey)[:-9],
        'dcx_no_pages.dcx': R.dcx_file([]),
        'iptc_compression9.iim': R.iptc_file(grey.tobytes(), W, H,
                                             compression=9),
        'iptc_band5.iim': R.iptc_file(grey.tobytes(), W, H, 4, 1, band=5),
    }


def _lzw_tiff_large(path: str, n: int) -> None:
    """An n x n LZW TIFF, predictor 2, of the picture posterised to steps
    of 8 (``picture``'s waves and discs, no noise)."""
    Image.fromarray(picture(n, n, 0.0) // 8 * 8).save(
        path, compression='tiff_lzw', tiffinfo={317: 2})


def _gif_large(path: str, n: int) -> None:
    """An n x n 256-colour GIF of the n x n baseline JPEG's pixels."""
    jpg = os.path.join(os.path.dirname(path), f'jpeg_baseline_{n}.jpg')
    Image.open(jpg).convert('RGB').quantize(256).save(path)


def _jpeg_tiff_large(path: str, n: int) -> None:
    """An n x n JPEG-in-TIFF, YCbCr 4:2:0 at quality 85, in strips of 64
    rows, of the picture of the n x n baseline JPEG."""
    libtiff_write(path, picture(n, n, 1), 6, 7, strip=64,
                  subsampling=(2, 2), jpeg_quality=85)


def _icns_large(path: str, n: int) -> None:
    """PIL's own ICNS file: PNG icons up to ``n`` x ``n``, resized by PIL
    from one 64x64 picture of colour blocks (a picture of detail would
    take megabytes at 1,024^2)."""
    blocks = np.kron((np.indices((8, 8)).sum(0) % 3 * 100).astype(np.uint8),
                     np.ones((8, 8), np.uint8))
    Image.fromarray(np.stack([blocks, blocks[::-1], blocks.T], -1)).save(
        path, 'ICNS')
    assert Image.open(path).size == (n, n)


def _g4_tiff_large(path: str, n: int) -> None:
    """An n x n CCITT G4 TIFF of the picture's green channel
    thresholded at 128 (waves and discs; the noise speckles their
    edges)."""
    Image.fromarray(picture(n, n, 1.0)[..., 1] >= 128).save(
        path, compression='group4')


def _zstd_tiff_large(path: str, n: int) -> None:
    """An n x n Zstandard TIFF, predictor 2, in strips of 64 rows, of the
    LZW TIFF's picture (``picture``'s waves and discs posterised to steps
    of 8), written by PIL's libtiff."""
    libtiff_write(path, picture(n, n, 0.0) // 8 * 8, 2, 50000, strip=64,
                  tags=((317, 2),))


# the files at textures' sizes written by a function of (path, side),
# after those of LARGE
LARGE_MADE = {
    'tiff_lzw_2048.tif': (_lzw_tiff_large, 2048),
    'gif_256_2048.gif': (_gif_large, 2048),
    'tiff_jpeg_ycbcr_2048.tif': (_jpeg_tiff_large, 2048),
    'tiff_g4_2048.tif': (_g4_tiff_large, 2048),
    'icns_pil_1024.icns': (_icns_large, 1024),
    'tiff_zstd_2048.tif': (_zstd_tiff_large, 2048),
}
# DDS files of seeded random blocks at a texture's size: not committed,
# their digests are (``bitmap_stages.large_file`` writes them from the
# entry's ``seeded`` record): name -> (DXGI format, side, seed)
LARGE_SEEDED = {
    'dds_bc1_random_2048.dds': (71, 2048, 1),
    'dds_bc7_random_2048.dds': (98, 2048, 7),
}
# files of ``raster_files.large_raster``: name -> (kind, side, seed); not
# committed either
LARGE_RASTER = {
    'sun_rle_2048.ras': ('sun_rle', 2048, 3),
    'flc_brun_lc_ss2_2048.flc': ('flc', 2048, 5),
    'pcd_random.pcd': ('pcd', 768, 9),
}


# the files at textures' sizes: name -> (side, PIL's save arguments, the
# picture's noisy share of rows)
LARGE = {
    'jpeg_baseline_512.jpg': (512, {'quality': 85, 'subsampling': 2}, 1),
    'jpeg_baseline_2048.jpg': (2048, {'quality': 85, 'subsampling': 2}, 1),
    'jpeg_progressive_2048.jpg': (2048, {'quality': 85, 'subsampling': 2,
                                         'progressive': True}, 1),
    'jpeg_baseline_4096.jpg': (4096, {'quality': 85, 'subsampling': 2}, 1),
    'webp_lossy_2048.webp': (2048, {'quality': 80}, 1),
    'webp_lossy_4096.webp': (4096, {'quality': 80}, 1),
    'webp_lossless_2048.webp': (2048, {'lossless': True}, 1 / 32),
    'jp2_irreversible_2048.jp2': (2048, {
        'irreversible': True, 'quality_mode': 'rates',
        'quality_layers': [20]}, 1),
    'jp2_reversible_2048.jp2': (2048, {}, 0),
}


def _bitmaps_large(out: str) -> None:
    """The files of ``LARGE`` and ``LARGE_MADE`` (each written where it
    is missing) and the SHA-256 digests of PIL's RGB bytes of each and of
    the ``LARGE_SEEDED`` files; no file over 1.5 MB, 9 MB together."""
    os.makedirs(out, exist_ok=True)
    digests, total = {}, 0
    for name, (dxgi, n, seed) in LARGE_SEEDED.items():
        rgb = np.asarray(Image.open(io.BytesIO(bitmap_stages.bcn_random_dds(
            n, n, dxgi, seed))).convert('RGB'))
        digests[name] = {'sha256': hashlib.sha256(rgb.tobytes()).hexdigest(),
                         'shape': list(rgb.shape), 'seeded': {
                             'dxgi': dxgi, 'side': n, 'seed': seed}}
    large_raster = raster_files.large_raster
    for name, (kind, n, seed) in LARGE_RASTER.items():
        rgb = np.asarray(Image.open(io.BytesIO(large_raster(
            kind, n, seed))).convert('RGB'))
        digests[name] = {'sha256': hashlib.sha256(rgb.tobytes()).hexdigest(),
                         'shape': list(rgb.shape), 'seeded': {
                             'kind': kind, 'side': n, 'seed': seed}}
    for name in [*LARGE, *LARGE_MADE]:
        path = os.path.join(out, name)
        if os.path.exists(path):
            pass
        elif name in LARGE:
            n, kw, noisy = LARGE[name]
            Image.fromarray(picture(n, n, noisy)).save(path, **kw)
        else:
            make, n = LARGE_MADE[name]
            make(path, n)
        size = os.path.getsize(path)
        assert size <= 1_500_000, (name, size)
        total += size
        rgb = np.asarray(Image.open(path).convert('RGB'))
        digests[name] = {'sha256': hashlib.sha256(rgb.tobytes()).hexdigest(),
                         'shape': list(rgb.shape), 'bytes': size}
        print(f"{name}: {size} bytes")
    assert total <= 9_000_000, total
    with open(os.path.join(out, 'pil_rgb_sha256.json'), 'w') as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write('\n')


# --- the colour tables of PIL's converters ---------------------------------

def _offsets():
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing='ij')

    def conv(y):
        px = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        return np.asarray(Image.fromarray(px, 'YCbCr').convert('RGB')
                          ).astype(np.int64)
    lo, hi = conv(0), conv(255)
    k = np.where(lo > 0, lo, hi - 255)          # Y + k, unclipped at one end
    return k[0, :, 0], k[:, 0, 2], k[..., 1], conv


def _lsq(cols, target, mask, sizes):
    off = np.cumsum([0, *sizes])
    a = np.zeros((int(mask.sum()), off[-1]))
    r = np.arange(len(a))
    for c, o in zip(cols, off):
        a[r, o + c[mask]] = 1
    return np.linalg.lstsq(a, target[mask].astype(float), rcond=None)[0]


def _pcd_tables():
    rng = np.random.default_rng(5)
    ys, cbs, crs, rgbs = [], [], [], []
    for _ in range(4):
        ch = rng.integers(0, 256, (256, 2304), dtype=np.uint8)
        rgbs.append(np.asarray(Image.open(io.BytesIO(
            raster_files.pcd_file(ch))).convert('RGB')).reshape(
            -1, 3).astype(np.int64))
        y = np.empty((512, 768), np.int64)
        y[0::2], y[1::2] = ch[:, :768], ch[:, 768:1536]
        ys.append(y.ravel())
        for dst, part in ((cbs, ch[:, 1536:1920]), (crs, ch[:, 1920:])):
            dst.append(np.repeat(np.repeat(part.astype(np.int64), 2, 1), 2,
                                 0).ravel())
    y, cb, cr, rgb = (np.concatenate(v) for v in (ys, cbs, crs, rgbs))
    n = 300000
    inside = (rgb > 0) & (rgb < 255)
    s = _lsq([y[:n], cr[:n]], rgb[:n, 0], inside[:n, 0], [256, 256])
    lum = np.round(s[:256] - s[0]).astype(np.int64)
    cr_t = np.round(s[256:] + s[0]).astype(np.int64)
    s = _lsq([cb[:n]], rgb[:n, 2] - lum[y[:n]], inside[:n, 2], [256])
    cb_t = np.round(s).astype(np.int64)
    s = _lsq([cr[:n], cb[:n]], rgb[:n, 1] - lum[y[:n]], inside[:n, 1],
             [256, 256])
    gr = np.round(s[:256] - s[137]).astype(np.int64)
    gb = np.round(s[256:] + s[137]).astype(np.int64)
    got = np.stack([lum[y] + cr_t[cr], lum[y] + gr[cr] + gb[cb],
                    lum[y] + cb_t[cb]], -1)
    assert (np.clip(got, 0, 255) == rgb).all()
    return {'L': lum, 'CR': cr_t, 'CB': cb_t, 'GR': gr, 'GB': gb}


def _colour_tables() -> None:
    """Print PIL's Photo CD YCC and YCbCr conversion tables, recovered
    from its output, as ``utils/pcd.py`` and ``utils/ycbcr.py`` hold them.

    Photo CD: PIL's ``pcd`` decoder computes ``R = L[Y] + CR[Cr]``,
    ``G = L[Y] + GR[Cr] + GB[Cb]`` and ``B = L[Y] + CB[Cb]``, each clipped
    to 0..255. Four Photo CD files of seeded random samples (1.5 million
    pixels) are decoded, the unclipped sums solved by least squares
    (``L[0]`` and ``GR[137]`` set to 0: only the sums matter), and the
    integer tables checked against every pixel.

    YCbCr: PIL's ``convert('RGB')`` computes ``R = Y + R_CR[Cr]``,
    ``B = Y + B_CB[Cb]`` and ``G = Y + ((G_CB[Cb] + G_CR[Cr]) >> 6)``,
    each clipped. Every (Cb, Cr) pair is converted at Y = 0 and Y = 255,
    the offsets read where they are not clipped, ``R_CR`` and ``B_CB``
    taken as they are and the difference constraints
    ``64 k <= G_CB[Cb] + G_CR[Cr] <= 64 k + 63`` solved (Bellman-Ford,
    started from the BT.601 coefficients) for the green tables, which
    are checked against every (Y, Cb, Cr) of a few luma levels."""
    for name, t in _pcd_tables().items():
        print(f'{name} = np.array({t.tolist()})')
    r_cr, b_cb, kg, conv = _offsets()
    i = np.arange(256) - 128
    a = np.round(-0.344136 * i * 64).astype(np.int64) + 64
    y = -np.round(-0.714136 * i * 64).astype(np.int64)
    for _ in range(10000):                     # y = -G_CR, a = G_CB
        ny = np.minimum(y, (a[:, None] - 64 * kg).min(0))
        na = np.minimum(a, (ny[None, :] + 64 * kg + 63).min(1))
        if (ny == y).all() and (na == a).all():
            break
        a, y = na, ny
    g_cb, g_cr = a, -y
    for lum in (1, 64, 128, 200, 254):
        want = conv(lum)
        g = lum + ((g_cb[:, None] + g_cr[None, :]) >> 6)
        got = np.stack([np.broadcast_to(lum + r_cr[None, :], g.shape), g,
                        np.broadcast_to(lum + b_cb[:, None], g.shape)], -1)
        assert (np.clip(got, 0, 255) == want).all(), lum
    for name, t in (('R_CR', r_cr), ('B_CB', b_cb), ('G_CB', g_cb),
                    ('G_CR', g_cr)):
        print(f'{name} = np.array({t.tolist()})')



def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', 'tests', 'data',
        'bitmaps'))
    ap.add_argument('--large', action='store_true',
                    help="write only ../bitmaps_large")
    ap.add_argument('--colour-tables', action='store_true',
                    help="print PIL's Photo CD and YCbCr tables")
    ap.add_argument('--rest', action='store_true',
                    help="write only the rest of PIL's raster formats and "
                         "the refused files, then pil_rgb.npz")
    args = ap.parse_args()
    out = os.path.normpath(args.out)
    if args.colour_tables:
        _colour_tables()
        return
    if args.large:
        _bitmaps_large(os.path.join(os.path.dirname(out), 'bitmaps_large'))
        return
    os.makedirs(out, exist_ok=True)
    pic = _picture64()
    rgb = _layout_picture()
    if args.rest:
        _rest_files(rgb, pic, out)
        _write_refused(rgb, out)
        _store_pil_rgb(out)
        return
    grey = Image.fromarray(rgb[..., 1], 'L')
    cmyk = Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1), 'CMYK')
    rgba = Image.fromarray(np.concatenate([rgb, rgb[..., 2:]], -1), 'RGBA')
    colour = Image.fromarray(rgb)
    writes = {
        'picture64.png': (pic, {}),
        'picture64.bmp': (pic, {}),
        'picture64.tga': (pic, {}),
        'picture64.gif': (pic, {}),
        'picture64.ppm': (pic.convert('RGB'), {}),
        'picture64.tif': (pic.convert('RGB'), {'compression': 'tiff_lzw'}),
        'jpeg_420.jpg': (colour, {'quality': 85, 'subsampling': 2}),
        'jpeg_progressive_420.jpg': (colour, {'quality': 85,
                                              'subsampling': 2,
                                              'progressive': True}),
        'jpeg_progressive_grey_restart.jpg': (grey, {
            'quality': 90, 'progressive': True,
            'restart_marker_blocks': 2}),
        'jpeg_cmyk.jpg': (cmyk, {'quality': 90}),
        'bmp_24.bmp': (colour, {}),
        'bmp_8_palette.bmp': (colour.quantize(64), {}),
        'bmp_1.bmp': (grey.convert('1'), {}),
        'bmp_32_rgba.bmp': (rgba, {}),
        'tga_rgb_rle.tga': (colour, {'compression': 'tga_rle'}),
        'tga_rgba_bottom_up.tga': (rgba, {'orientation': -1}),
        'tga_palette.tga': (colour.quantize(100), {}),
        'ppm_rgb.ppm': (colour, {}),
        'pgm_grey.pgm': (grey, {}),
        'pbm_bits.pbm': (grey.convert('1'), {}),
        'gif_interlaced_transparent.gif': (colour.quantize(200), {
            'interlace': True, 'transparency': 3}),
        'tiff_raw_rgb.tif': (colour, {}),
        'tiff_lzw_pred2_rgb.tif': (colour, {'compression': 'tiff_lzw',
                                            'tiffinfo': {317: 2}}),
        'tiff_deflate_cmyk.tif': (cmyk, {'compression': 'tiff_deflate'}),
        'tiff_packbits_grey.tif': (grey, {'compression': 'packbits'}),
        'tiff_deflate_float_pred3.tif': (Image.fromarray(
            rgb[..., 0].astype(np.float32) * 1.25 - 20.0), {
            'compression': 'tiff_deflate', 'tiffinfo': {317: 3}}),
        'tiff_lzw_palette.tif': (colour.quantize(50), {
            'compression': 'tiff_lzw'}),
        'tiff_pil_jpeg_rgb.tif': (colour, {'compression': 'jpeg'}),
        'tiff_pil_jpeg_ycbcr.tif': (colour.convert('YCbCr'), {
            'compression': 'jpeg'}),
        'tiff_pil_lzw_ycbcr.tif': (colour.convert('YCbCr'), {
            'compression': 'tiff_lzw'}),
    }
    for name, (im, kw) in writes.items():
        im.save(os.path.join(out, name), **kw)
    _ycck(os.path.join(out, 'jpeg_cmyk.jpg'),
          os.path.join(out, 'jpeg_ycck.jpg'))
    _tiff_layouts(rgb, out)
    _tiff_rest(rgb, out)
    _raster_files(rgb, pic, out)
    _jpeg2000_files(rgb, pic, out)
    _openjpeg_files(rgb, out)
    _icon_files(rgb, pic, out)
    _slice19_files(rgb, pic, out)
    _rest_files(rgb, pic, out)
    _write_refused(rgb, out)
    for name, data in _webp_layouts(rgb, pic).items():
        with open(os.path.join(out, name), 'wb') as f:
            f.write(data)
    _webp_large(os.path.join(os.path.dirname(out), 'webp_large'))
    _store_pil_rgb(out)


def _store_pil_rgb(out: str) -> None:
    """``pil_rgb.npz``: PIL's RGB bytes of every file in ``out``, each
    under 16 KiB and the lossless copies of the picture equal."""
    ref = {}
    for name in sorted(os.listdir(out)):
        if name.endswith('.npz'):
            continue
        path = os.path.join(out, name)
        size = os.path.getsize(path)
        assert size <= 16 * 1024, (name, size)
        ref[name] = np.asarray(Image.open(path).convert('RGB'))
    first = ref['picture64.png']
    for ext in ('bmp', 'tga', 'gif', 'ppm', 'tif', 'webp', 'qoi', 'sgi',
                'pcx', 'dds', 'jp2', 'ico', 'psd', 'zstd.tif', 'ras', 'im'):
        assert (ref[f'picture64.{ext}'] == first).all(), ext
    np.savez_compressed(os.path.join(out, 'pil_rgb.npz'), **ref)
    total = sum(os.path.getsize(os.path.join(out, n))
                for n in os.listdir(out))
    assert total <= 2048 * 1024, total
    print(f"{len(ref)} files and pil_rgb.npz in {out}: {total} bytes")


if __name__ == '__main__':
    main()
