"""Bitmap decode time at textures' sizes: the port's native decoders, their
plain twins and PIL, on one host.

    python3 scripts/port_bitmap_speed.py [--reps 3] [--no-plain]

Decodes every file of ``tests/data/webp_large`` (WebP at 512 x 512) and
``tests/data/bitmaps_large`` (JPEG at 512 x 512, JPEG and WebP at 2,048 x
2,048 and 4,096 x 4,096, LZW TIFF, GIF, JPEG-in-TIFF and G4 TIFF at 2,048
x 2,048, and two DDS files of seeded random BC1 and BC7 blocks at 2,048 x
2,048, written here) and three PNG files written here by numpy with
every row Paeth-filtered (512, 2,048 and 4,096 square; their pixels are
known) through ``texture.read_rgb8``: the native stages (median of
``--reps``), the plain stages (``testing/bitmap_stages.plain``, once, the
2,048 x 2,048 files only) and PIL's ``Image.open(f).convert('RGB')``
(median of ``--reps``). Plain and PIL are skipped on a host without
PIL. Every decode is checked against PIL's digest or the known pixels.
Prints the host's CPU model and count, then one JSON line a file:
milliseconds and milliseconds per megapixel of each, and plain over
native.

With ``--stages`` (on a host without PIL: JPEG 2000's rows of the
committed 2,048 x 2,048 pair alone) it also prints one line a stage for
the stages moved into host C++ in slice 16, each timed on the arguments
it takes while a 512 x 512 file decodes (native median of ``--reps``,
plain once): TIFF LZW (predictor 2, the picture posterised to steps of
8, written by PIL), GIF LZW (256 colours), WebP's alpha gradient filter
(a seeded plane) and a lossless JPEG scan (predictor 1, three
components); then the time inside TIFF's PackBits stage, still Python, of
a 2,048 x 2,048 PackBits TIFF, and the time inside the numpy stages of
the lossless WebP decoder (prefix-code reading, subtract-green, colour
indexing) and the rest of the decode of two 4,096 x 4,096 lossless WebP
files, one full-colour and one of 256 colours, written by PIL, and of
subtract-green on a seeded 4,096 x 4,096 image; then slice 17's stages:
CCITT G4 and BC7 and BC6H blocks at 512 x 512, and the QOI, SGI RLE and
PCX RLE loops at 2,048 x 2,048 (``slice17_rows``); then slice 18's JPEG
2000 stages (``slice18_rows``): tier 1, the inverse 5/3 or 9/7 and the
colour transform with level shift, each on the calls a reversible and an
irreversible JP2 of the picture hand it at 512 x 512 and 2,048 x 2,048
(native median of ``--reps``, plain once; the plain tier 1, a Python loop
a symbol, at 512 x 512 only), beside the whole decode's native and PIL
milliseconds and the rest of it (headers and tier 2, in Python).

Then slice 19's Zstandard stage (``slice19_rows``) on the calls a
Zstandard TIFF hands it at 512 x 512 and 2,048 x 2,048 (native median of
``--reps``, plain once), beside the whole decode's native and PIL
milliseconds.

The JPEG 2000 files are decoded through the plain stages by ``--stages``
alone: their plain tier 1 takes minutes at 2,048 x 2,048.

With ``--slice20`` (alone: no other file or stage; no PIL needed) it
prints one line a stage of slice 20 (``slice20_rows``): the Sun raster
RLE, the MSP row RLE, the FLI frame's chunks and BLP's DXT5 blocks, each
on the calls that a seeded 2,048 x 2,048 file of ``testing/raster_files``
hands it (written here: the Sun raster and the FLC of ``bitmaps_large``'s
seeded entries, an MSP version 2 file of the picture thresholded, a BLP2
DXT5 file of random blocks): native median of ``--reps``, plain once,
beside the whole decode's native milliseconds.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from mitsuba_nlvrl_tpu_torch import native, texture  # noqa: E402
from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages  # noqa: E402

try:
    from PIL import Image
except ImportError:           # a host without PIL: native timings only
    Image = None

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'tests', 'data')


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn, reps: int):
    """(median milliseconds, last result) of ``reps`` calls."""
    ms, out = [], None
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms), out


def files(workdir: str) -> list:
    """(path, check) of each file: check(rgb) holds when the decode is
    PIL's."""
    out = []
    for folder in ('webp_large', 'bitmaps_large'):
        with open(os.path.join(DATA, folder, 'pil_rgb_sha256.json')) as f:
            digests = json.load(f)
        for name, d in sorted(digests.items()):
            path = bitmap_stages.large_file(os.path.join(DATA, folder), name,
                                            d, workdir)
            out.append((path, lambda rgb, d=d: (
                hashlib.sha256(rgb.tobytes()).hexdigest() == d['sha256'])))
    for n in (512, 2048, 4096):
        img = bitmap_stages.picture(n, n)
        path = os.path.join(workdir, f'png_paeth_{n}.png')
        with open(path, 'wb') as f:
            f.write(bitmap_stages.png_filtered(img, filters=(4,)))
        out.append((path, lambda rgb, img=img: np.array_equal(rgb, img)))
    return out


@contextlib.contextmanager
def clocked(module, names):
    """Sum the milliseconds spent in ``module``'s functions ``names``
    while the block runs, into the dict it yields."""
    spent = dict.fromkeys(names, 0.0)
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += (time.perf_counter() - t) * 1e3
        return run
    try:
        for n, fn in saved.items():
            setattr(module, n, wrap(n, fn))
        yield spent
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def captured(module, stage: str, path: str) -> list:
    """The arguments of each call of ``module.stage`` while ``path``
    decodes."""
    calls, real = [], getattr(module, stage)

    def record(*args):
        calls.append(copy.deepcopy(args))
        return real(*args)
    setattr(module, stage, record)
    try:
        texture.read_rgb8(path)
    finally:
        setattr(module, stage, real)
    return calls


def stage_rows(workdir: str, reps: int) -> None:
    """The slice 16 stages at 512^2, PackBits at 2,048^2, and the numpy
    stages of the lossless WebP decoder at 4,096^2 (see the module's
    docstring)."""
    from mitsuba_nlvrl_tpu_torch.utils import gif, jpeg, tiff, vp8l, webp
    pic = bitmap_stages.picture(512, 512)
    files = {'tiff': os.path.join(workdir, 'lzw_512.tif'),
             'gif': os.path.join(workdir, 'gif_512.gif'),
             'jpeg': os.path.join(workdir, 'lossless_512.jpg')}
    Image.fromarray(pic // 8 * 8).save(files['tiff'],
                                       compression='tiff_lzw',
                                       tiffinfo={317: 2})
    Image.fromarray(pic).quantize(256).save(files['gif'])
    with open(files['jpeg'], 'wb') as f:
        f.write(bitmap_stages.jpeg_lossless(pic, 1))
    alpha = np.random.default_rng(512).integers(0, 256, (512, 512),
                                                np.uint8)
    for name, module, stage, calls in (
            ('tiff_lzw', tiff, '_lzw', captured(tiff, '_lzw',
                                                files['tiff'])),
            ('gif_lzw', gif, '_lzw', captured(gif, '_lzw', files['gif'])),
            ('alpha_gradient', webp, '_unfilter_gradient', [(alpha,)]),
            ('jpeg_lossless', jpeg, '_decode_lossless', captured(
                jpeg, '_decode_lossless', files['jpeg']))):
        def run(fn):
            for args in calls:
                fn(*copy.deepcopy(args))
        native_ms, _ = timed(lambda: run(getattr(module, stage)), reps)
        plain_ms, _ = timed(lambda: run(getattr(module, stage + '_plain')),
                            1)
        emit({'stage': name, 'side': 512, 'calls': len(calls),
              'native_ms': native_ms, 'plain_ms': plain_ms,
              'plain_over_native': plain_ms / native_ms})
    path = os.path.join(workdir, 'packbits_2048.tif')
    Image.fromarray(bitmap_stages.picture(2048, 2048)).save(
        path, compression='packbits')
    with clocked(tiff, ['_packbits']) as spent:
        ms, _ = timed(lambda: texture.read_rgb8(path), 1)
    emit({'stage': 'tiff_packbits', 'side': 2048, 'decode_ms': ms,
          'packbits_ms': spent['_packbits']})
    big = bitmap_stages.picture(4096, 4096, 1 / 32)
    for kind, img in (('full_colour', Image.fromarray(big)),
                      ('256_colours', Image.fromarray(big).quantize(256))):
        path = os.path.join(workdir, f'lossless_4096_{kind}.webp')
        img.save(path, 'WEBP', lossless=True)
        numpy_stages = ['_read_code', '_add_green', '_unindex']
        native_stages = ['_pixels', '_unpredict', '_uncross']
        with clocked(vp8l, numpy_stages + native_stages) as spent:
            ms, _ = timed(lambda: texture.read_rgb8(path), 1)
        emit({'stage': 'webp_lossless_numpy_stages', 'side': 4096,
              'file': kind, 'bytes': os.path.getsize(path),
              'decode_ms': ms, **{f'{n[1:]}_ms': spent[n]
                                  for n in numpy_stages + native_stages},
              'rest_ms': ms - sum(spent.values())})
    # subtract-green alone, as libwebp may leave it out of a file
    argb = np.random.default_rng(4096).integers(0, 2 ** 32, (4096, 4096),
                                                np.uint32)
    ms, _ = timed(lambda: vp8l._add_green(argb), reps)
    emit({'stage': 'webp_subtract_green', 'side': 4096, 'ms': ms})
    slice17_rows(workdir, reps)
    slice18_rows(workdir, reps)


def slice17_rows(workdir: str, reps: int) -> None:
    """Slice 17's stages, each on the arguments its decode hands it:
    CCITT G4 of a 512^2 bilevel picture and BC7 and BC6H blocks of a
    512^2 surface (native median of ``reps``, plain once), and the QOI,
    SGI RLE and PCX RLE loops at 2,048^2 (their plain twins, Python loops,
    once), the loops that the 1 s rule at 2,048^2 moved into the
    library."""
    from mitsuba_nlvrl_tpu_torch.utils import ccitt, dds, pcx, qoi, sgi
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from port_make_bitmaps import _sgi_rle
    pic = bitmap_stages.picture(512, 512)
    g4 = os.path.join(workdir, 'g4_512.tif')
    Image.fromarray(pic[..., 1] >= 128).save(g4, compression='group4')
    bc = {}
    for name, dxgi in (('bc7', 98), ('bc6h', 95)):
        bc[name] = os.path.join(workdir, f'{name}_512.dds')
        with open(bc[name], 'wb') as f:
            f.write(bitmap_stages.bcn_random_dds(512, 512, dxgi, 512))
    big = bitmap_stages.picture(2048, 2048)
    for fmt, kw in (('QOI', {}), ('PCX', {})):
        Image.fromarray(big).save(os.path.join(workdir, f'big.{fmt}'), fmt,
                                  **kw)
    with open(os.path.join(workdir, 'big.sgi'), 'wb') as f:
        f.write(_sgi_rle(big, 1))
    rows = [('ccitt_g4', 512, ccitt, 'decode', g4),
            ('bcn_bc7', 512, dds, '_bcn', bc['bc7']),
            ('bcn_bc6h', 512, dds, '_bcn', bc['bc6h']),
            ('qoi', 2048, qoi, '_qoi', os.path.join(workdir, 'big.QOI')),
            ('sgi_rle', 2048, sgi, '_sgi_rle',
             os.path.join(workdir, 'big.sgi')),
            ('pcx_rle', 2048, pcx, '_pcx_rle',
             os.path.join(workdir, 'big.PCX'))]
    for name, side, module, stage, path in rows:
        calls = captured(module, stage, path)

        def run(fn):
            for args in calls:
                fn(*copy.deepcopy(args))
        native_ms, _ = timed(lambda: run(getattr(module, stage)), reps)
        plain_ms, _ = timed(lambda: run(getattr(module, stage + '_plain')),
                            1)
        emit({'stage': name, 'side': side, 'calls': len(calls),
              'native_ms': native_ms, 'plain_ms': plain_ms,
              'plain_over_native': plain_ms / native_ms})


def slice18_rows(workdir: str, reps: int) -> None:
    """JPEG 2000's stages on the calls that a reversible (5/3, one
    lossless layer) and an irreversible (9/7, one layer at rate 20) JP2
    of the picture hand them, at 512^2 and 2,048^2 (the 2,048^2 pair is
    the committed ``bitmaps_large`` pair): native median of ``reps``,
    plain once (tier 1's plain twin at 512^2 only), and the whole decode,
    native and PIL, median of ``reps``. On a host without PIL: the
    2,048^2 pair alone, without PIL's time."""
    from mitsuba_nlvrl_tpu_torch.utils import j2k
    pairs = {2048: {'reversible': os.path.join(
        DATA, 'bitmaps_large', 'jp2_reversible_2048.jp2'),
        'irreversible': os.path.join(DATA, 'bitmaps_large',
                                     'jp2_irreversible_2048.jp2')}}
    for kind, kw, noisy in () if Image is None else (('reversible', {}, 0),
                            ('irreversible', {'irreversible': True,
                                              'quality_mode': 'rates',
                                              'quality_layers': [20]}, 1)):
        path = os.path.join(workdir, f'{kind}_512.jp2')
        Image.fromarray(bitmap_stages.picture(512, 512, noisy)).save(
            path, 'JPEG2000', **kw)
        pairs.setdefault(512, {})[kind] = path
    for side in sorted(pairs):
        for kind, path in pairs[side].items():
            whole_ms, _ = timed(lambda: texture.read_rgb8(path), reps)
            pil_ms = None if Image is None else timed(lambda: np.asarray(
                Image.open(path).convert('RGB')), reps)[0]
            wavelet = '_idwt53' if kind == 'reversible' else '_idwt97'
            stage_ms = 0.0
            for stage in ('_t1', wavelet, '_finish'):
                calls = captured(j2k, stage, path)

                def run(fn):
                    for args in calls:
                        fn(*copy.deepcopy(args))
                native_ms, _ = timed(lambda: run(getattr(j2k, stage)), reps)
                stage_ms += native_ms
                rec = {'stage': f'j2k{stage}', 'side': side, 'kind': kind,
                       'calls': len(calls), 'native_ms': native_ms}
                if stage != '_t1' or side <= 512:
                    plain_ms, _ = timed(lambda: run(getattr(
                        j2k, stage + '_plain')), 1)
                    rec.update(plain_ms=plain_ms,
                               plain_over_native=plain_ms / native_ms)
                emit(rec)
            emit({'stage': 'j2k_whole_decode', 'side': side, 'kind': kind,
                  'file': os.path.basename(path),
                  'bytes': os.path.getsize(path), 'native_ms': whole_ms,
                  'stages_ms': stage_ms, 'rest_ms': whole_ms - stage_ms,
                  'pil_ms': pil_ms, 'native_over_pil':
                  pil_ms and whole_ms / pil_ms})


def slice19_rows(workdir: str, reps: int) -> None:
    """The Zstandard stage on the calls a Zstandard TIFF (predictor 2, in
    strips of 64 rows, the picture posterised to steps of 8) hands it at
    512^2 (written here by PIL's libtiff) and 2,048^2 (the committed
    ``bitmaps_large`` file): native median of ``reps``, plain once, and
    the whole decode, native and PIL, median of ``reps``. On a host
    without PIL: the 2,048^2 file alone, without PIL's time."""
    from mitsuba_nlvrl_tpu_torch.utils import zstd
    files = {2048: os.path.join(DATA, 'bitmaps_large', 'tiff_zstd_2048.tif')}
    if Image is not None:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from port_make_bitmaps import libtiff_write
        files[512] = os.path.join(workdir, 'zstd_512.tif')
        libtiff_write(files[512], bitmap_stages.picture(512, 512, 0.0) // 8
                      * 8, 2, 50000, strip=64, tags=((317, 2),))
    for side, path in sorted(files.items()):
        whole_ms, _ = timed(lambda: texture.read_rgb8(path), reps)
        pil_ms = None if Image is None else timed(lambda: np.asarray(
            Image.open(path).convert('RGB')), reps)[0]
        calls = captured(zstd, 'decompress', path)

        def run(fn):
            for args in calls:
                fn(*args)
        native_ms, _ = timed(lambda: run(zstd.decompress), reps)
        plain_ms, _ = timed(lambda: run(zstd.decompress_plain), 1)
        emit({'stage': 'zstd_decompress', 'side': side, 'calls': len(calls),
              'bytes_in': sum(len(a[0]) for a in calls),
              'bytes_out': sum(a[1] for a in calls),
              'native_ms': native_ms, 'plain_ms': plain_ms,
              'plain_over_native': plain_ms / native_ms,
              'whole_decode_native_ms': whole_ms, 'whole_decode_pil_ms':
              pil_ms, 'native_over_pil': pil_ms and whole_ms / pil_ms})


def slice20_rows(workdir: str, reps: int) -> None:
    """Slice 20's stages at 2,048^2 (see the module's docstring)."""
    from mitsuba_nlvrl_tpu_torch.testing import raster_files
    from mitsuba_nlvrl_tpu_torch.utils import dds, fli, msp, sun
    with open(os.path.join(DATA, 'bitmaps_large',
                           'pil_rgb_sha256.json')) as f:
        digests = json.load(f)
    paths = {name: bitmap_stages.large_file(
        os.path.join(DATA, 'bitmaps_large'), name, digests[name], workdir)
        for name in ('sun_rle_2048.ras', 'flc_brun_lc_ss2_2048.flc')}
    pic = bitmap_stages.picture(2048, 2048, 0.0)
    paths['msp_v2_2048.msp'] = os.path.join(workdir, 'msp_v2_2048.msp')
    with open(paths['msp_v2_2048.msp'], 'wb') as f:
        f.write(raster_files.msp_file((pic[..., 1] >= 128).astype(np.uint8)))
    paths['blp2_dxt5_2048.blp'] = os.path.join(workdir, 'blp2_dxt5_2048.blp')
    with open(paths['blp2_dxt5_2048.blp'], 'wb') as f:
        f.write(raster_files.blp_file(
            2, 2048, 2048, np.random.default_rng(20).integers(
                0, 256, 512 * 512 * 16, dtype=np.uint8).tobytes(),
            encoding=2, alpha=8, alpha_encoding=7))
    rows = [('sun_rle', sun, '_sun_rle', 'sun_rle_2048.ras'),
            ('msp_rle', msp, '_msp_rle', 'msp_v2_2048.msp'),
            ('fli_frame', fli, '_fli_frame', 'flc_brun_lc_ss2_2048.flc'),
            ('bcn_blp_dxt5', dds, '_bcn', 'blp2_dxt5_2048.blp')]
    for name, module, stage, file in rows:
        path = paths[file]
        whole_ms, _ = timed(lambda: texture.read_rgb8(path), reps)
        calls = captured(module, stage, path)

        def run(fn):
            for args in calls:
                fn(*args)
        native_ms, _ = timed(lambda: run(getattr(module, stage)), reps)
        plain_ms, _ = timed(lambda: run(getattr(module, stage + '_plain')),
                            1)
        emit({'stage': name, 'side': 2048, 'file': file,
              'calls': len(calls), 'bytes_in': sum(len(a[0]) for a in calls),
              'native_ms': native_ms, 'plain_ms': plain_ms,
              'plain_over_native': plain_ms / native_ms,
              'whole_decode_native_ms': whole_ms})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--no-plain', action='store_true',
                    help="skip the plain stages (minutes at 2,048^2)")
    ap.add_argument('--stages', action='store_true',
                    help="also time slice 16's to 19's stages "
                    "(slice 16's and 17's need PIL)")
    ap.add_argument('--slice20', action='store_true',
                    help="time slice 20's stages alone")
    args = ap.parse_args()
    emit({'host_cpu': native._cpu_model(), 'cpus': os.cpu_count(),
          'pil': Image is not None,
          'library': native.build(native.BITMAP_SOURCES, 'bitmap',
                                  'the bitmap decoders')})
    if args.slice20:
        with tempfile.TemporaryDirectory() as workdir:
            slice20_rows(workdir, args.reps)
        return
    texture.read_rgb8(os.path.join(DATA, 'bitmaps', 'picture64.png'))
    with tempfile.TemporaryDirectory() as workdir:
        for path, check in files(workdir):
            ms, rgb = timed(lambda: texture.read_rgb8(path), args.reps)
            if not check(rgb):
                raise SystemExit(f"{path}: the native decode is not PIL's")
            mpix = rgb.shape[0] * rgb.shape[1] / 1e6
            rec = {'file': os.path.basename(path), 'mpix': mpix,
                   'native_ms': ms, 'native_ms_per_mpix': ms / mpix}
            if Image is not None:
                pil_ms, ref = timed(lambda: np.asarray(
                    Image.open(path).convert('RGB')), args.reps)
                if not check(ref):
                    raise SystemExit(f"{path}: PIL's decode differs")
                rec.update(pil_ms=pil_ms, pil_ms_per_mpix=pil_ms / mpix,
                           native_over_pil=ms / pil_ms)
                if not args.no_plain and rgb.shape[0] <= 2048 and \
                        not path.endswith('.jp2'):
                    with bitmap_stages.plain():
                        plain_ms, out = timed(
                            lambda: texture.read_rgb8(path), 1)
                    if not check(out):
                        raise SystemExit(f"{path}: the plain decode differs")
                    rec.update(plain_ms=plain_ms,
                               plain_ms_per_mpix=plain_ms / mpix,
                               plain_over_native=plain_ms / ms)
            emit(rec)
        if args.stages and Image is not None:
            stage_rows(workdir, args.reps)
        elif args.stages:          # the card's host: JPEG 2000, Zstandard
            slice18_rows(workdir, args.reps)
        if args.stages:
            slice19_rows(workdir, args.reps)


if __name__ == '__main__':
    main()
