"""Decode seeded corruptions of bitmap fixtures through the port's native
decoder stages and through their plain twins, in a process of its own:
a decoder that crashed would end this process, not a test worker.

    python tests/torch_bitmap_corrupt_worker.py GROUP WORKDIR [CASES [LIB]]

GROUP is a key of ``GROUPS`` or ``STAGE_GROUPS``. Each of its CASES cases
(40) is one of the group's fixtures cut short (even cases) or with one to
three bytes flipped (odd cases), seeded. A stage group cuts or flips the
input of one native stage instead (an LZW stream, a lossless JPEG scan, an
alpha plane's rows), as the decode of its fixtures hands it over, and
calls the stage and its plain twin on it. A PNG's cut or flips are made
in its image data inside the zlib stream, which is compressed again: cut
or flipped in the file, nearly every case would stop at zlib's checksum,
before the row filters. The decoders are loaded without the port's renderer (no torch),
so the process starts in a fraction of a second. Prints one JSON list:
[case, native outcome, plain outcome] for each case, an outcome being
the exception's type name or a digest of what the decode returned.
LIB loads another build of the native sources in place of the one built
at first use, such as one compiled with ``-fsanitize=address,undefined``
(run then with the sanitizers' runtimes in ``LD_PRELOAD``).
"""
import copy
import hashlib
import json
import os
import struct
import sys
import types
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, 'tests', 'data', 'bitmaps')
CASES = 40
# group -> (decoder: utils module and function, fixtures)
GROUPS = {
    'png': (('io', 'read_png'), ('picture64.png', 'filters.png')),
    'jpeg': (('jpeg', 'read_jpeg_mode'), (
        'jpeg_420.jpg', 'jpeg_progressive_420.jpg',
        'jpeg_progressive_grey_restart.jpg', 'jpeg_cmyk.jpg')),
    'webp_lossless': (('webp', 'read_webp'), (
        'webp_lossless_m0.webp', 'webp_lossless_m6_rgba.webp',
        'webp_palette_16.webp', 'picture64.webp')),
    'webp_lossy': (('webp', 'read_webp'), (
        'webp_lossy_q50.webp', 'webp_vp8_4_partitions.webp',
        'webp_vp8_simple_filter.webp', 'webp_alph_lossless_gradient.webp')),
}


# group -> (utils module, stage, decoder of the fixtures, fixtures: file
# names, or (psv, restart rows, point transform, channels) of a lossless
# JPEG written here)
STAGE_GROUPS = {
    'tiff_lzw': ('tiff', '_lzw', 'read_tiff', (
        'picture64.tif', 'tiff_lzw_pred2_rgb.tif', 'tiff_lzw_palette.tif',
        'tiff_ycbcr22_lzw_blackwhite.tif')),
    'gif_lzw': ('gif', '_lzw', 'read_gif', (
        'picture64.gif', 'gif_interlaced_transparent.gif')),
    'alpha_gradient': ('webp', '_unfilter_gradient', 'read_webp', (
        'webp_alph_lossless_gradient.webp', 'webp_alph_raw_gradient.webp')),
    'jpeg_lossless': ('jpeg', '_decode_lossless', 'read_jpeg_mode', (
        (1, 2, 0, 1), (4, 0, 0, 3), (7, 3, 1, 3), (5, 0, 0, 1))),
    'ccitt': ('ccitt', 'decode', 'tiff.read_tiff', (
        'tiff_g3_2d.tif', 'tiff_g4_tiles.tif', 'tiff_ccitt_rle.tif',
        'tiff_g3_1d_fill.tif')),
    'bcn': ('dds', '_bcn', 'read_dds', (
        'dds_dx10_bc7.dds', 'dds_dx10_bc6h_sf16.dds', 'dds_dxt5.dds',
        'dds_bc5s.dds')),
    'qoi': ('qoi', '_qoi', 'read_qoi', ('qoi_rgb.qoi', 'qoi_rgba.qoi')),
    'sgi_rle': ('sgi', '_sgi_rle', 'read_sgi', (
        'sgi_rle_3ch_8bit.sgi', 'sgi_rle_1ch_16bit.sgi')),
    'pcx_rle': ('pcx', '_pcx_rle', 'read_pcx', (
        'pcx_rgb.pcx', 'pcx_4bit_planar.pcx')),
    'j2k_t1': ('j2k', '_t1', 'jp2.read_jpeg2000', (
        'jp2_l.jp2', 'j2k_style_all.j2k', 'jp2_tiles.jp2')),
    'j2k_idwt53': ('j2k', '_idwt53', 'jp2.read_jpeg2000', (
        'jp2_rgb.jp2', 'jp2_offset_tiles.jp2')),
    'j2k_idwt97': ('j2k', '_idwt97', 'jp2.read_jpeg2000', (
        'jp2_rgb_irreversible.jp2', 'jp2_tiles_irreversible_mct.jp2')),
    'zstd': ('zstd', 'decompress', 'tiff.read_tiff', (
        'tiff_zstd_level19_pred2.tif', 'tiff_zstd_float_pred3.tif',
        'tiff_zstd_level1_pred2_tiles_mm.tif', 'picture64.zstd.tif')),
    'thunderscan': ('tiff', '_thunderscan', 'read_tiff', (
        'tiff_thunderscan.tif', 'tiff_thunderscan_min_is_white.tif')),
    'ccitt_rlew': ('ccitt', 'decode', 'tiff.read_tiff', (
        'tiff_rlew.tif', 'tiff_rlew_odd_offset.tif')),
    'sun_rle': ('sun', '_sun_rle', 'read_sun', (
        'sun_8_rle.ras', 'sun_32_rle.ras', 'picture64.ras')),
    'msp_rle': ('msp', '_msp_rle', 'read_msp', ('msp_v2.msp',)),
    'fli_frame': ('fli', '_fli_frame', 'read_fli', (
        'flc_lc_ss2.flc', 'fli_brun_colour64.fli',
        'flc_copy_black_pstamp.flc', 'flc_ss2_even_width.flc')),
    'bcn_blp': ('dds', '_bcn', 'blp.read_blp', (
        'blp2_dxt1_alpha1.blp', 'blp2_dxt3_alpha8.blp',
        'blp2_dxt5_alpha8.blp')),
}


def _load_decoders(library):
    """The port's package as a bare namespace, so that importing its
    decoders does not import its renderer; ``library`` (a path, or None)
    stands in for the native build."""
    pkg = types.ModuleType('mitsuba_nlvrl_tpu_torch')
    pkg.__path__ = [os.path.join(ROOT, 'mitsuba_nlvrl_tpu_torch')]
    sys.modules['mitsuba_nlvrl_tpu_torch'] = pkg
    import importlib
    if library:
        native = importlib.import_module('mitsuba_nlvrl_tpu_torch.native')
        native.build = lambda *args, **kwargs: library
    return importlib.import_module, importlib.import_module(
        'mitsuba_nlvrl_tpu_torch.testing.bitmap_stages')


def _outcome(fn, path) -> str:
    try:
        out = fn(path)
    except Exception as e:  # noqa: BLE001 - the outcome is the type
        return type(e).__name__
    return _digest(out)


def _digest(out) -> str:
    h = hashlib.sha256()
    for part in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(part, np.ndarray):
            h.update(f'{part.dtype}{part.shape}'.encode())
            h.update(np.ascontiguousarray(part).tobytes())
        else:
            h.update(repr(part).encode())
    return h.hexdigest()


def _stage_inputs(import_module, stages, group, workdir) -> tuple:
    """The arguments of each call of the group's stage while its fixtures
    decode, the stage and its plain twin."""
    module, stage, decoder, fixtures = STAGE_GROUPS[group]
    mod = import_module(f'mitsuba_nlvrl_tpu_torch.utils.{module}')
    # the decoder may sit in another module than its stage
    dmodule, decoder = decoder.split('.') if '.' in decoder else \
        (module, decoder)
    calls, real = [], getattr(mod, stage)

    def record(*args):
        calls.append(copy.deepcopy(args))
        return real(*args)
    setattr(mod, stage, record)
    try:
        for k, f in enumerate(fixtures):
            if isinstance(f, tuple):
                psv, rows, pt, chans = f
                img = stages.picture(24, k)[:17, :, :chans]
                path = os.path.join(workdir, f'lossless_{k}.jpg')
                with open(path, 'wb') as fh:
                    fh.write(stages.jpeg_lossless(
                        img if chans == 3 else img[..., 0], psv, rows, pt))
            else:
                path = os.path.join(FIXTURES, f)
            getattr(import_module(
                f'mitsuba_nlvrl_tpu_torch.utils.{dmodule}'), decoder)(path)
    finally:
        setattr(mod, stage, real)
    return calls, getattr(mod, stage), getattr(mod, stage + '_plain')


def _corrupt(arg, case: int, rng):
    """An LZW stream, scan, CCITT strip, BCn blocks, RLE (Sun's, MSP's
    rows among them), an FLI frame, Zstandard or ThunderScan data or JPEG
    2000 code-block data cut short or with bytes flipped; an alpha plane's
    or a tile-component's wavelet coefficients' rows cut or their bytes
    flipped."""
    if isinstance(arg, np.ndarray):
        a = arg.copy()
        if case % 2 == 0:
            return a[:int(rng.integers(0, a.shape[0]))]
        b = a.reshape(-1).view(np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, b.size))] ^= np.uint8(rng.integers(1, 256))
        return a
    data = bytearray(arg)
    if case % 2 == 0:
        return bytes(data[:int(rng.integers(0, len(data)))])
    for _ in range(int(rng.integers(1, 4))):
        data[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
    return bytes(data)


def _stage_outcome(fn, args) -> str:
    """The exception's type name, or a digest of the stage's result (of
    the samples it stores in the components, for a lossless scan)."""
    args = copy.deepcopy(args)
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the outcome is the type
        return type(e).__name__
    if out is None:                     # _decode_lossless fills comps
        out = [c.get('samples') for c in args[1]]
    return _digest(out)


def stage_main(group: str, workdir: str, cases: int = CASES,
               library: str = None) -> None:
    import_module, stages = _load_decoders(library)
    calls, native, plain = _stage_inputs(import_module, stages, group,
                                         workdir)
    rng = np.random.default_rng(sum(map(ord, group)))
    results = []
    for case in range(cases):
        args = list(calls[case % len(calls)])
        args[0] = _corrupt(args[0], case, rng)
        results.append([case, _stage_outcome(native, args),
                        _stage_outcome(plain, args)])
    print(json.dumps(results))


def _png_with_data(png: bytes, data: bytes) -> bytes:
    """A PNG file's chunks with its IDAT chunks replaced by one holding
    ``data`` compressed."""
    out, pos, idat = [png[:8]], 8, True
    while pos < len(png):
        n, tag = struct.unpack('>I4s', png[pos:pos + 8])
        if tag != b'IDAT':
            out.append(png[pos:pos + 12 + n])
        elif idat:
            body = zlib.compress(data)
            out.append(struct.pack('>I', len(body)) + b'IDAT' + body +
                       struct.pack('>I', zlib.crc32(b'IDAT' + body)))
            idat = False
        pos += 12 + n
    return b''.join(out)


def _png_data(png: bytes) -> bytes:
    """A PNG file's image data, decompressed."""
    pos, parts = 8, []
    while pos < len(png):
        n, tag = struct.unpack('>I4s', png[pos:pos + 8])
        if tag == b'IDAT':
            parts.append(png[pos + 8:pos + 8 + n])
        pos += 12 + n
    return zlib.decompress(b''.join(parts))


def main(group: str, workdir: str, cases: int = CASES,
         library: str = None) -> None:
    import_module, stages = _load_decoders(library)
    (module, name), fixtures = GROUPS[group]
    fn = getattr(import_module(f'mitsuba_nlvrl_tpu_torch.utils.{module}'),
                 name)
    sources = []
    for f in fixtures:
        if f == 'filters.png':          # every row filter, RGBA
            img = stages.picture(24, 3)
            sources.append(stages.png_filtered(
                np.concatenate([img, img[..., :1]], -1)))
        else:
            with open(os.path.join(FIXTURES, f), 'rb') as fh:
                sources.append(fh.read())
    rng = np.random.default_rng(sum(map(ord, group)))
    results = []
    for case in range(cases):
        source = sources[case % len(sources)]
        data = bytearray(_png_data(source) if group == 'png' else source)
        if case % 2 == 0:
            data = data[:int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(0, len(data)))] ^= int(
                    rng.integers(1, 256))
        if group == 'png':
            data = _png_with_data(source, bytes(data))
        path = os.path.join(workdir, f'{group}_{case}')
        with open(path, 'wb') as fh:
            fh.write(data)
        native = _outcome(fn, path)
        with stages.plain():
            plain = _outcome(fn, path)
        results.append([case, native, plain])
    print(json.dumps(results))


if __name__ == '__main__':
    run = stage_main if sys.argv[1] in STAGE_GROUPS else main
    run(sys.argv[1], sys.argv[2], *(int(a) for a in sys.argv[3:4]),
        *sys.argv[4:5])
