"""Write the bitmap fixtures of the port's decoders with PIL.

    python scripts/port_make_bitmaps.py [--out tests/data/bitmaps]

Needs PIL, so it runs where PIL is installed (the card's machine has
none, which is why the files are committed). It writes:

  * ``picture64.{png,bmp,tga,ppm,gif,tif}``: one 64x64 picture of at most
    256 colours, written losslessly in six formats (PNG, BMP and TGA
    with its palette, GIF, PPM and LZW TIFF as RGB), so that all six hold
    the same pixels; ``chip_smoke.py``'s ``textured_formats`` phase
    renders ``cbox_textured`` with each as its bitmaps;
  * one 37x23 file per layout that ``chip_smoke.py``'s ``bitmap_decode``
    phase checks (sequential, progressive, grey, CMYK and YCCK JPEG; BMP,
    TGA, PNM, GIF and TIFF layouts), each under 16 KiB;
  * ``pil_rgb.npz``: PIL's ``Image.open(f).convert('RGB')`` bytes of
    every file, keyed by file name.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', 'tests', 'data',
        'bitmaps'))
    out = os.path.normpath(ap.parse_args().out)
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
    }
    for name, (im, kw) in writes.items():
        im.save(os.path.join(out, name), **kw)
    _ycck(os.path.join(out, 'jpeg_cmyk.jpg'),
          os.path.join(out, 'jpeg_ycck.jpg'))
    ref = {}
    for name in sorted(os.listdir(out)):
        if name.endswith('.npz'):
            continue
        path = os.path.join(out, name)
        size = os.path.getsize(path)
        assert size <= 16 * 1024, (name, size)
        ref[name] = np.asarray(Image.open(path).convert('RGB'))
    first = ref['picture64.png']
    for ext in ('bmp', 'tga', 'gif', 'ppm', 'tif'):
        assert (ref[f'picture64.{ext}'] == first).all(), ext
    np.savez_compressed(os.path.join(out, 'pil_rgb.npz'), **ref)
    total = sum(os.path.getsize(os.path.join(out, n))
                for n in os.listdir(out))
    assert total <= 256 * 1024, total
    print(f"{len(ref)} files and pil_rgb.npz in {out}: {total} bytes")


if __name__ == '__main__':
    main()
