"""The TIFF corners of slice 19 against PIL: LZMA (34925) and Zstandard
(50000) with predictors 1-3 in both byte orders, strips and tiles;
word-aligned CCITT RLE (32771) and ThunderScan (32809); JPEG in planes,
in CMYK, with alpha and min-is-white; uncompressed tiled YCbCr; and the
codecs PIL refuses (SGILog, WebP) or does not know. Each file decodes to
PIL's ``convert('RGB')`` bytes, or raises the exception class PIL raises.
libtiff (``libtiff_write`` of ``scripts/port_make_bitmaps.py``) writes
what it can; ThunderScan and word-aligned RLE are coded here
(``testing/bitmap_stages``). ``utils/zstd.decompress`` is held to the
input of ``zstandard``'s encoder (a test-only package) at many levels
and sizes; the load path of a Zstandard and an LZMA TIFF to the
reference's, which opens them through PIL.
"""
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
import zstandard
from PIL import Image

from mitsuba_nlvrl_tpu import texture as jtex
from mitsuba_nlvrl_tpu_torch import texture as ptex
from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages
from mitsuba_nlvrl_tpu_torch.utils import tiff, zstd

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), 'scripts'))
from port_make_bitmaps import (  # noqa: E402
    _bilevel, _hand_tiff, _layout_picture, _thunder_picture, libtiff_write,
    tiff_by_hand)

torch.set_num_threads(1)   # one intra-op thread a test worker

FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
REFUSED = os.path.join(HERE, 'data', 'bitmaps_refused')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
with open(os.path.join(REFUSED, 'pil_errors.json')) as _f:
    ERRORS = json.load(_f)
H, W = 23, 37
_rng = np.random.default_rng(19)
RGB = _rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
YCC = np.asarray(Image.fromarray(RGB).convert('YCbCr'))
CMYK = np.concatenate([RGB, RGB[..., :1]], -1)


def _pil_or_error(path):
    try:
        return np.asarray(Image.open(path).convert('RGB'))
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e)


def _same_as_pil(path):
    """The port's bytes equal PIL's, or both raise one exception type
    (PIL's UnidentifiedImageError is an OSError); returns PIL's exception
    class or None."""
    want = _pil_or_error(path)
    if isinstance(want, type):
        with pytest.raises(OSError if issubclass(want, OSError) else want):
            ptex.read_rgb8(path)
        return want
    got = ptex.read_rgb8(path)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    return None


CORNERS = [n for n in WANT.files if n.startswith((
    'tiff_zstd', 'tiff_lzma', 'tiff_jpeg_planar', 'tiff_jpeg_cmyk',
    'tiff_jpeg_rgba', 'tiff_jpeg_la', 'tiff_jpeg_min', 'tiff_rlew',
    'tiff_thunderscan', 'tiff_ycbcr22_raw_tiles', 'tiff_ycbcr11_raw_tiles',
    'picture64.zstd'))]
REFUSED_TIFF = sorted(n for n in ERRORS if n.endswith('.tif'))


def test_slice_fixtures_are_listed():
    assert len(CORNERS) == 25, len(CORNERS)
    assert len(REFUSED_TIFF) == 6, REFUSED_TIFF


@pytest.mark.parametrize('name', CORNERS)
def test_fixture_decodes_to_pils_stored_bytes(name):
    """Each committed fixture, through the native stages only, equals
    PIL's stored bytes and what this PIL makes of it now."""
    path = os.path.join(FIXTURES, name)
    with bitmap_stages.forbid_plain():
        got = ptex.read_rgb8(path)
    assert got.tobytes() == WANT[name].tobytes()
    assert np.asarray(Image.open(path).convert('RGB')).tobytes() == \
        WANT[name].tobytes()


@pytest.mark.parametrize('name', REFUSED_TIFF)
def test_refused_tiff_raises_pils_class(name):
    """SGILog (photometric LogL or LogLuv: PIL's table lacks them, so
    ``Image.open`` fails; another photometric: its codec refuses at
    load), WebP (the libtiff PIL bundles has no WebP codec: load), an
    8-bit ThunderScan file (load) and a compression PIL does not know
    (open) raise the class PIL raises, stored and as this PIL raises
    it."""
    path = os.path.join(REFUSED, name)
    want = _same_as_pil(path)
    assert want is not None and want.__name__ == ERRORS[name]['error']
    at = 'open'
    try:
        im = Image.open(path)
        at = 'load'
        im.load()
    except Exception:               # noqa: BLE001 - where PIL raised
        pass
    assert at == ERRORS[name]['at']


def test_no_compression_of_pils_table_is_left_unported():
    """Every compression of PIL's ``COMPRESSION_INFO`` decodes or raises
    as PIL does: none reaches ROADMAP 12.7."""
    from PIL import TiffImagePlugin
    assert sorted(TiffImagePlugin.COMPRESSION_INFO) == \
        sorted(tiff.COMPRESSIONS)
    with open(tiff.__file__) as f:
        assert 'not_in_slice' not in f.read()


# --- LZMA and Zstandard through libtiff -----------------------------------

U16 = RGB.astype(np.uint16) * 257 + 5
F32 = RGB[..., :1].astype(np.float32) * 1.25 - 3.0


@pytest.mark.parametrize('comp', [34925, 50000])
@pytest.mark.parametrize('pred,layout', [
    (1, 'rgb8'), (2, 'rgb8'), (2, 'rgb16'), (2, 'grey8'), (3, 'float'),
    (1, 'cmyk8')])
@pytest.mark.parametrize('order', ['II', 'MM'])
@pytest.mark.parametrize('tile', [None, (16, 16)])
def test_lzma_zstd_with_predictors_as_pil(tmp_path, comp, pred, layout,
                                          order, tile):
    """libtiff runs predictors 2 and 3 on LZMA and Zstandard as on LZW
    and Deflate."""
    px, photo, bits, tags = {
        'rgb8': (RGB, 2, 8, ()), 'rgb16': (U16, 2, 16, ()),
        'grey8': (RGB[..., :1], 1, 8, ()), 'cmyk8': (CMYK, 5, 8, ()),
        'float': (F32, 1, 32, ((339, 3),))}[layout]
    path = str(tmp_path / 'c.tif')
    kw = {'tile': tile} if tile else {'strip': 8}
    libtiff_write(path, px, photo, comp, bits=bits, order=order,
                  tags=((317, pred),) + tags, **kw)
    assert _same_as_pil(path) is None


@pytest.mark.parametrize('level', [-5, 1, 9, 19, 22])
def test_zstd_levels_as_pil(tmp_path, level):
    path = str(tmp_path / 'z.tif')
    libtiff_write(path, RGB, 2, 50000, strip=16,
                  tags=((317, 2), (65564, level)))
    assert _same_as_pil(path) is None


def test_zstd_strip_cut_short_fails_as_pil(tmp_path):
    """A strip whose frame ends before the strip is full: libtiff's
    "not enough data", an OSError in PIL and here."""
    path = str(tmp_path / 'z.tif')
    libtiff_write(path, RGB, 2, 50000)
    data = bytearray(open(path, 'rb').read())
    tags, _ = tiff._ifd(bytes(data))
    off, n = tags[273][0], tags[279][0]
    frame = zstandard.ZstdCompressor().compress(RGB.tobytes()[:-100])
    assert len(frame) <= n
    data[off:off + len(frame)] = frame
    with open(path, 'wb') as f:
        f.write(bytes(data))
    assert _same_as_pil(path) is OSError


# --- utils/zstd against zstandard's encoder --------------------------------

def _payload(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == 'random':
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 'few':
        return rng.integers(0, 12, n, dtype=np.uint8).tobytes()
    if kind == 'walk':
        return np.cumsum(rng.integers(-2, 3, n)).astype(np.uint8).tobytes()
    if kind == 'text':
        words = [bytes(rng.integers(97, 123, rng.integers(2, 9),
                                    dtype=np.uint8)) for _ in range(300)]
        return b' '.join(words[i] for i in rng.integers(
            0, 300, n // 5 + 1))[:n]
    # runs of one byte between short repeats: RLE literals past the
    # first block
    return b''.join(b'x' * int(k) + b'abcdefgh' * int(r) for k, r in zip(
        rng.integers(1, 4, n // 10 + 1), rng.integers(1, 4, n // 10 + 1))
    )[:n]


@pytest.mark.parametrize('level', [-5, -1, 1, 3, 7, 12, 19, 22])
@pytest.mark.parametrize('kind,n', [
    ('random', 0), ('random', 1), ('text', 600), ('few', 240),
    ('walk', 20_000), ('text', 300_000), ('few', 400_000),
    ('runs', 300_000), ('random', 200_000)])
def test_zstd_equals_zstandards_input(level, kind, n):
    """Frames of ``zstandard``'s encoder from empty to several 128 KiB
    blocks (the blocks of a frame sharing their Huffman and FSE tables),
    with and without the content checksum and the content size."""
    data = _payload(kind, n, 1000 * (level + 5) + n)
    for checksum, size in ((True, True), (False, False)):
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum,
            write_content_size=size).compress(data)
        assert zstd.decompress(frame) == data


def test_zstd_of_several_mib_streamed():
    """A 6 MiB input streamed by ``zstandard``'s encoder (no content size,
    blocks at its window) at two levels."""
    data = _payload('walk', 6 << 20, 5)
    for level in (3, 19):
        frame = zstandard.ZstdCompressor(level=level).compressobj()
        blob = frame.compress(data) + frame.flush()
        assert zstd.decompress(blob) == data


def _frame(data: bytes, **kw) -> bytes:
    return zstandard.ZstdCompressor(**kw).compress(data)


def test_zstd_frames_in_a_row_and_skippable_frames():
    a, b = _payload('text', 5000, 1), _payload('few', 3000, 2)
    skip = struct.pack('<II', 0x184D2A53, 5) + b'12345'
    blob = _frame(a) + skip + _frame(b, write_checksum=True) + skip
    for fn in (zstd.decompress, zstd.decompress_plain):
        assert fn(blob) == a + b
        assert fn(blob, frames=1) == a
        assert fn(skip + blob, frames=1) == b''
        assert fn(blob, frames=2) == a
        assert fn(blob, frames=3) == a + b


def test_zstd_limit_stops_at_a_block_boundary():
    """``limit`` stops after the block that reaches it, as libtiff's
    reader stops once its strip is full: a corrupt later block or a
    wrong checksum past the limit goes unseen."""
    data = _payload('text', 400_000, 3)
    frame = bytearray(_frame(data, level=3, write_checksum=True))
    for fn in (zstd.decompress, zstd.decompress_plain):
        got = fn(bytes(frame), 1000)
        assert 1000 <= len(got) <= 128 * 1024 and data.startswith(got)
    frame[-1] ^= 0xFF                       # the checksum
    for fn in (zstd.decompress, zstd.decompress_plain):
        assert data.startswith(fn(bytes(frame), 1000))
        with pytest.raises(OSError):
            fn(bytes(frame))


def _header(fhd: int, *fields) -> bytes:
    return struct.pack('<IB', 0xFD2FB528, fhd) + b''.join(fields)


@pytest.mark.parametrize('case', [
    'dictionary', 'window', 'reserved_bit', 'reserved_block', 'rle_block',
    'raw_block', 'content_size', 'checksum', 'truncated', 'unknown_magic',
    'block_over_window'])
def test_zstd_frame_fields(case):
    """Frames written field by field: a dictionary id or a window over
    2^27 raise ``OSError`` (libzstd was given no dictionary and caps the
    window); raw and RLE blocks decode; a wrong content size or checksum,
    a reserved bit or block type, a truncated frame, an unknown magic
    number and a block larger than the window raise ``OSError``."""
    last_raw = struct.pack('<I', 1 | 5 << 3)[:3] + b'hello'
    frames = {
        'dictionary': _header(0x01, b'\x58', b'\x07') + last_raw,
        'window': _header(0x00, bytes([(28 - 10) << 3])) + last_raw,
        'reserved_bit': _header(0x08, b'\x58') + last_raw,
        'reserved_block': _header(0x00, b'\x58') + bytes([7, 0, 0]),
        'rle_block': _header(0x20, b'\x07') +
        struct.pack('<I', 1 | 1 << 1 | 7 << 3)[:3] + b'z',
        'raw_block': _header(0x20, b'\x05') + last_raw,
        'content_size': _header(0x20, b'\x06') + last_raw,
        'checksum': _header(0x24, b'\x05') + last_raw + b'\0\0\0\0',
        'truncated': _header(0x20, b'\x05') + last_raw[:6],
        'unknown_magic': b'\x00\x01\x02\x03' + last_raw,
        'block_over_window': _header(0x20, b'\x04') + last_raw,
    }
    want = {'rle_block': b'z' * 7, 'raw_block': b'hello'}
    blob = frames[case]
    for fn in (zstd.decompress, zstd.decompress_plain):
        if case in want:
            assert fn(blob) == want[case]
        else:
            with pytest.raises(OSError):
                fn(blob)


def test_xxh64_of_known_inputs():
    assert zstd.xxh64(b'') == 0xEF46DB3751D8E999
    assert zstd.xxh64(b'abc') == 0x44BC2CF5AD770999


# --- JPEG in planes and CMYK, tiled YCbCr ---------------------------------

JPEG_LAYOUTS = {
    'planar_rgb_strips': (RGB, 2, {'strip': 8, 'planar': 2}),
    'planar_rgb_tiles': (RGB, 2, {'tile': (16, 16), 'planar': 2}),
    'planar_grey': (RGB[..., :1], 1, {'strip': 16, 'planar': 2}),
    'planar_ycbcr11': (YCC, 6, {'strip': 8, 'planar': 2,
                                'subsampling': (1, 1)}),
    'planar_ycbcr21_tiles': (YCC, 6, {'tile': (16, 16), 'planar': 2,
                                      'subsampling': (2, 1)}),
    'planar_ycbcr11_blackwhite': (YCC, 6, {
        'strip': 8, 'planar': 2, 'subsampling': (1, 1),
        'tags': ((532, [16.0, 235.0, 128.0, 240.0, 128.0, 240.0]),)}),
    'cmyk_strips': (CMYK, 5, {'strip': 8}),
    'cmyk_tiles': (CMYK, 5, {'tile': (16, 16)}),
    'cmyk_planar': (CMYK, 5, {'strip': 8, 'planar': 2}),
    'rgba': (np.concatenate([RGB, RGB[..., 2:]], -1), 2, {
        'strip': 8, 'tags': ((338, 2),)}),
    'rgba_associated_planar': (np.concatenate([RGB, RGB[..., 2:]], -1), 2,
                               {'strip': 8, 'planar': 2,
                                'tags': ((338, 1),)}),
    'rgb_extra_unspecified': (np.concatenate([RGB, RGB[..., 2:]], -1), 2,
                              {'strip': 8, 'tags': ((338, 0),)}),
    'la': (RGB[..., :2], 1, {'strip': 8, 'tags': ((338, 2),)}),
    'min_is_white': (RGB[..., :1], 0, {'tile': (16, 16)}),
}


@pytest.mark.parametrize('layout', list(JPEG_LAYOUTS))
def test_jpeg_layouts_as_pil(tmp_path, layout):
    """Every 8-bit layout libtiff's JPEG codec writes: PIL's bytes, or its
    exception class where it refuses (subsampled YCbCr in planes)."""
    px, photo, kw = JPEG_LAYOUTS[layout]
    path = str(tmp_path / 'j.tif')
    libtiff_write(path, px, photo, 7, **kw)
    want = _same_as_pil(path)
    assert want is (OSError if layout == 'planar_ycbcr21_tiles' else None)


def test_jpeg_of_16_bit_samples_fails_as_pil(tmp_path):
    """A JPEG-in-TIFF whose tags say 16 bits: PIL opens the layout and
    libtiff's codec refuses it."""
    path = str(tmp_path / 'j.tif')
    libtiff_write(path, RGB, 2, 7, strip=8)
    data = bytearray(open(path, 'rb').read())
    off = struct.unpack_from('<I', data, 4)[0]         # the IFD
    for k in range(struct.unpack_from('<H', data, off)[0]):
        e = off + 2 + 12 * k
        if struct.unpack_from('<H', data, e)[0] == 258:
            at = struct.unpack_from('<I', data, e + 8)[0]
            struct.pack_into('<HHH', data, at, 16, 16, 16)
    with open(path, 'wb') as f:
        f.write(bytes(data))
    assert _same_as_pil(path) is not None


@pytest.mark.parametrize('width,tile,sub', [
    (37, (16, 16), (2, 2)), (37, (32, 16), (1, 1)), (27, (16, 16), (2, 1)),
    (30, (16, 16), (2, 2)), (48, (16, 32), (1, 1)), (37, (16, 48), (4, 2))])
def test_uncompressed_tiled_ycbcr_as_pil(tmp_path, width, tile, sub):
    """PIL's own reader takes each tile as RGBX rows; a tile past the
    right edge steps its rows by 3 * tile width and fails where that is
    shorter than its row (width 30)."""
    path = str(tmp_path / 'y.tif')
    libtiff_write(path, YCC[:, :width], 6, 1, tile=tile, subsampling=sub)
    assert _same_as_pil(path) is (OSError if width == 30 else None)


# --- word-aligned CCITT RLE and ThunderScan, coded here -------------------

def _bits(width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = np.zeros((H, width), np.uint8)
    for y in range(H):
        edges = np.cumsum(rng.geometric(rng.uniform(0.002, 0.6), 80))
        for a, c in zip(edges[::2], edges[1::2]):
            b[y, a:c] = 1
    b[2] = 1
    b[3] = 0
    return b


@pytest.mark.parametrize('width', [1, 8, 37, 300, 2000, 2600])
@pytest.mark.parametrize('rows', [23, 8, 1])
@pytest.mark.parametrize('odd', [0, 1])
def test_rlew_as_pil(tmp_path, width, rows, odd):
    """Rows padded to where libtiff's reader starts the next (its
    accumulator cut to 16 bits, a byte skipped at an odd address), in
    strips at even or odd offsets in the file: PIL's bytes, and the
    pixels coded."""
    bits = _bits(width, width + rows)
    strips = [bitmap_stages.ccitt_rlew(bits[y:y + rows], odd)
              for y in range(0, H, rows)]
    path = str(tmp_path / 'r.tif')
    with open(path, 'wb') as f:
        f.write(_hand_tiff(1, 0, 32771, strips, rows, width, H, odd))
    assert _same_as_pil(path) is None
    assert ptex.read_rgb8(path)[..., 0].tobytes() == \
        ((1 - bits) * 255).astype(np.uint8).tobytes()


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('photometric', [0, 1])
def test_thunderscan_as_pil(tmp_path, seed, photometric):
    """Seeded mixes of runs, 2- and 3-bit deltas and raw pixels, rows of
    even and odd widths, in strips: PIL's bytes (``L;4`` or ``L;4I``) and
    the pixels coded."""
    width = 37 + seed
    rng = np.random.default_rng(seed)
    g4 = np.tile(_thunder_picture(RGB), (1, 2))[:, :width]
    g4[rng.random(g4.shape) < 0.1] = 15
    rows = (23, 8, 5)[seed % 3]
    strips = [bitmap_stages.thunderscan(g4[y:y + rows], seed + y)
              for y in range(0, H, rows)]
    path = str(tmp_path / 't.tif')
    with open(path, 'wb') as f:
        f.write(_hand_tiff(4, photometric, 32809, strips, rows, width, H))
    assert _same_as_pil(path) is None
    want = g4 * 17 if photometric else 255 - g4 * 17
    assert ptex.read_rgb8(path)[..., 0].tobytes() == \
        want.astype(np.uint8).tobytes()


@pytest.mark.parametrize('edit', ['short', 'long', 'run_past_end'])
def test_thunderscan_errors_as_pil(tmp_path, edit):
    """Data that ends inside a row and a run past a row's end: libtiff's
    "not enough" or "too much data", an OSError under PIL and here; one
    extra pixel shifts the rows after it and leaves data over, which
    decodes as under PIL."""
    g4 = _thunder_picture(RGB)
    data = bytearray(bitmap_stages.thunderscan(g4, 1))
    if edit == 'short':
        data = data[:-3]
    elif edit == 'long':
        data = bytes([0xC5]) + data
    else:
        data = bytes([0x3F]) + data
    path = str(tmp_path / 't.tif')
    with open(path, 'wb') as f:
        f.write(_hand_tiff(4, 1, 32809, [bytes(data)], H, W, H))
    assert _same_as_pil(path) is (None if edit == 'long' else OSError)


def test_thunderscan_tiles_and_wide_samples_fail(tmp_path):
    """An 8-bit ThunderScan file and a tiled one fail at load, as libtiff
    refuses them ("ThunderScan tile decoding is not implemented")."""
    data = bitmap_stages.thunderscan(_thunder_picture(RGB), 0)
    path = str(tmp_path / 't8.tif')
    with open(path, 'wb') as f:
        f.write(_hand_tiff(8, 1, 32809, [data], H, W, H))
    assert _same_as_pil(path) is OSError
    g4 = _thunder_picture(RGB)[:16, :16]
    tiles = [bitmap_stages.thunderscan(g4, k) for k in range(3)]
    path = str(tmp_path / 'tiles.tif')
    with open(path, 'wb') as f:
        f.write(tiff_by_hand({
            256: (3, [W]), 257: (3, [16]), 258: (3, [4]),
            259: (3, [32809]), 262: (3, [1]), 277: (3, [1]),
            322: (3, [16]), 323: (3, [16]),
            324: (4, [('blob', i) for i in range(3)]),
            325: (4, [len(t) for t in tiles])}, tiles))
    assert _same_as_pil(path) is OSError


def test_unknown_compression_fails_at_open_as_pil(tmp_path):
    path = str(tmp_path / 'c.tif')
    with open(path, 'wb') as f:
        f.write(tiff_by_hand({
            256: (3, [W]), 257: (3, [H]), 258: (3, [8]), 259: (3, [34712]),
            262: (3, [1]), 273: (4, [('blob', 0)]), 279: (4, [W * H])},
            [bytes(W * H)]))
    assert _same_as_pil(path) is not None


# --- the load path against the reference ----------------------------------

@pytest.mark.parametrize('comp', [34925, 50000])
def test_load_bitmap_of_lzma_and_zstd_matches_reference(tmp_path, comp):
    """``texture.load_bitmap`` (gamma on and off) of an LZMA and a
    Zstandard TIFF with predictor 2 equals the reference's, which opens
    them through PIL, to the byte."""
    path = str(tmp_path / 'c.tif')
    libtiff_write(path, RGB, 2, comp, strip=8, tags=((317, 2),))
    for gamma in (True, False):
        want = jtex.load_bitmap(path, gamma=gamma)
        got = ptex.load_bitmap(path, gamma=gamma)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', ['tiff_rlew.tif', 'tiff_rlew_odd_offset.tif',
                                  'tiff_thunderscan.tif',
                                  'tiff_thunderscan_min_is_white.tif'])
def test_coded_fixtures_hold_their_pictures(name):
    """The committed RLE and ThunderScan fixtures decode to the pictures
    they were coded from (and PIL agrees, above)."""
    rgb = _layout_picture()
    got = ptex.read_rgb8(os.path.join(FIXTURES, name))[..., 0]
    if 'rlew' in name:
        bits = _bilevel(rgb)[..., 0]
        want = bits * 255 if 'odd' in name else (1 - bits) * 255
    else:
        g4 = _thunder_picture(rgb) * 17
        want = 255 - g4 if 'white' in name else g4
    assert got.tobytes() == want.astype(np.uint8).tobytes()
