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
  * ``pil_rgb.npz``: PIL's ``Image.open(f).convert('RGB')`` bytes of
    every file, keyed by file name;
  * in ``../webp_large``, a 512x512 lossless and a 512x512 lossy WebP and
    ``pil_rgb_sha256.json``, the SHA-256 digest of PIL's RGB bytes of
    each (the decoders at a texture's size);
  * in ``../bitmaps_large``, with ``--large`` alone, the files at
    textures' sizes (``testing/bitmap_stages.picture``): baseline and
    progressive 4:2:0 JPEG and lossy and lossless WebP at 2,048x2,048,
    baseline JPEG and lossy WebP at 4,096x4,096, a baseline JPEG at
    512x512 (the small end of the decode-speed table); at 2,048x2,048 an
    LZW TIFF with predictor 2 (the picture posterised to steps of 8: the
    JPEG's own pixels take 4.5 MB in LZW), a 256-colour GIF of the
    baseline JPEG's pixels and a JPEG-in-TIFF in YCbCr 4:2:0; and their
    ``pil_rgb_sha256.json``. No PNG is committed: a large one is written
    at run time by numpy (``testing/bitmap_stages.png_filtered``), as is
    an LZW TIFF of the JPEG's pixels (``testing/bitmap_stages.tiff_lzw``).

    python scripts/port_make_bitmaps.py --large
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


def libtiff_write(path: str, pixels: np.ndarray, photometric: int,
                  compression: int, strip: int = None, tile=None,
                  subsampling=None, tags=(), jpeg_quality: int = 90) -> None:
    """A TIFF of (H, W, C) uint8 ``pixels`` written by libtiff: strips of
    ``strip`` rows (all rows by default) or ``tile`` (w, h) tiles.
    Compression 7 (JPEG) takes RGB or grey pixels: libjpeg converts them to
    YCbCr for photometric 6 (JPEGCOLORMODE_RGB) at ``subsampling``.
    Otherwise photometric 6 takes full-resolution YCbCr, packed here into
    data units. ``tags``: (tag, value, ...) set as they are (a list value
    is a float array)."""
    lib = _libtiff_lib()
    H, W, C = pixels.shape
    t = lib.TIFFOpen(path.encode(), b'w')
    assert t, path

    def put(tag, *vals):
        args = [(ctypes.c_float * len(v))(*v) if isinstance(v, list)
                else ctypes.c_uint32(v) for v in vals]
        assert lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(tag),
                                *args) == 1, (tag, vals)
    for tag, *vals in ((256, W), (257, H), (258, 8), (277, C),
                       (259, compression), (262, photometric), (284, 1)):
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
    raw = compression != 7 and photometric == 6
    tw, th = tile or (W, strip or H)
    if tile:
        put(322, tw)
        put(323, th)
    else:
        put(278, th)
    k = 0
    for y in range(0, H, th):
        for x in range(0, W, tw):
            h = th if tile else min(th, H - y)
            block = np.zeros((h, tw, C), np.uint8)
            part = pixels[y:y + h, x:x + tw]
            block[:part.shape[0], :part.shape[1]] = part
            if tile:                            # repeat the edge samples
                block[part.shape[0]:] = block[part.shape[0] - 1]
                block[:, part.shape[1]:] = block[:, part.shape[1] - 1:
                                                 part.shape[1]]
            data = _ycbcr_units(block, hs, vs) if raw else block.tobytes()
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


# the files at textures' sizes written by a function of (path, side),
# after those of LARGE
LARGE_MADE = {
    'tiff_lzw_2048.tif': (_lzw_tiff_large, 2048),
    'gif_256_2048.gif': (_gif_large, 2048),
    'tiff_jpeg_ycbcr_2048.tif': (_jpeg_tiff_large, 2048),
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
}


def _bitmaps_large(out: str) -> None:
    """The files of ``LARGE`` and the SHA-256 digests of PIL's RGB bytes
    of each; no file over 1.5 MB, 6 MB together."""
    os.makedirs(out, exist_ok=True)
    digests, total = {}, 0
    for name in [*LARGE, *LARGE_MADE]:
        path = os.path.join(out, name)
        if name in LARGE:
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
    assert total <= 6_000_000, total
    with open(os.path.join(out, 'pil_rgb_sha256.json'), 'w') as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write('\n')


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', 'tests', 'data',
        'bitmaps'))
    ap.add_argument('--large', action='store_true',
                    help="write only ../bitmaps_large")
    args = ap.parse_args()
    out = os.path.normpath(args.out)
    if args.large:
        _bitmaps_large(os.path.join(os.path.dirname(out), 'bitmaps_large'))
        return
    os.makedirs(out, exist_ok=True)
    pic = _picture64()
    rgb = _layout_picture()
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
    for name, data in _webp_layouts(rgb, pic).items():
        with open(os.path.join(out, name), 'wb') as f:
            f.write(data)
    _webp_large(os.path.join(os.path.dirname(out), 'webp_large'))
    ref = {}
    for name in sorted(os.listdir(out)):
        if name.endswith('.npz'):
            continue
        path = os.path.join(out, name)
        size = os.path.getsize(path)
        assert size <= 16 * 1024, (name, size)
        ref[name] = np.asarray(Image.open(path).convert('RGB'))
    first = ref['picture64.png']
    for ext in ('bmp', 'tga', 'gif', 'ppm', 'tif', 'webp'):
        assert (ref[f'picture64.{ext}'] == first).all(), ext
    np.savez_compressed(os.path.join(out, 'pil_rgb.npz'), **ref)
    total = sum(os.path.getsize(os.path.join(out, n))
                for n in os.listdir(out))
    assert total <= 384 * 1024, total
    print(f"{len(ref)} files and pil_rgb.npz in {out}: {total} bytes")


if __name__ == '__main__':
    main()
