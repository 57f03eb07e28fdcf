"""The TIFF layouts of slice 17 against PIL: orientations 2-8, CCITT
(compression 2, 3 and 4), old-style JPEG (6), CIELab, 12-bit grey,
one-sample and planar YCbCr and YCbCr with predictor 2 above 1x1. Each
file decodes to PIL's ``convert('RGB')`` bytes, or raises the exception
type PIL raises. PIL writes what it can, the libtiff PIL bundles the rest
(``libtiff_write`` of ``scripts/port_make_bitmaps.py``, extended to 1- and
12-bit samples); old-style JPEG is written by hand around PIL's JPEG
streams. The CIELab conversion is held to PIL on all 2^24 triples; the
load path (``texture.load_bitmap``) of a CCITT TIFF, a BC7 DDS and a QOI
file is held to the reference's, which opens them through PIL.
"""
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba_nlvrl_tpu import texture as jtex
from mitsuba_nlvrl_tpu_torch import texture as ptex
from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages
from mitsuba_nlvrl_tpu_torch.utils.lab import lab_to_rgb

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), 'scripts'))
from port_make_bitmaps import (  # noqa: E402
    _bilevel, _jpeg_segments, libtiff_write, tiff_by_hand)

torch.set_num_threads(1)   # one intra-op thread a test worker

FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
H, W = 23, 37
_rng = np.random.default_rng(17)
RGB = _rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
YCC = np.asarray(Image.fromarray(RGB).convert('YCbCr'))
BITS = _bilevel(RGB)


def _pil_or_error(path):
    try:
        return np.asarray(Image.open(path).convert('RGB'))
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e)


def _same_as_pil(path):
    """The port's bytes equal PIL's, or both raise one exception type."""
    want = _pil_or_error(path)
    if isinstance(want, type):
        # PIL's UnidentifiedImageError is an OSError
        with pytest.raises(OSError if issubclass(want, OSError) else want):
            ptex.read_rgb8(path)
        return want
    got = ptex.read_rgb8(path)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    return None


REST = [n for n in WANT.files if n.startswith((
    'tiff_orient', 'tiff_ccitt', 'tiff_g3', 'tiff_g4', 'tiff_pil_ccitt',
    'tiff_pil_group', 'tiff_lab', 'tiff_grey12', 'tiff_ojpeg',
    'tiff_ycbcr_one', 'tiff_ycbcr_planar', 'tiff_ycbcr22_lzw_pred2',
    'tiff_ycbcr21', 'tiff_ycbcr44', 'tiff_ycbcr22_deflate_pred2'))]


def test_slice_fixtures_are_listed():
    assert len(REST) == 43, len(REST)


@pytest.mark.parametrize('name', REST)
def test_fixture_decodes_to_pils_stored_bytes(name):
    """Each committed fixture of the slice (``port_make_bitmaps.py``),
    through the native stages only, equals PIL's stored bytes and what
    this PIL makes of it now."""
    path = os.path.join(FIXTURES, name)
    with bitmap_stages.forbid_plain():
        got = ptex.read_rgb8(path)
    assert got.tobytes() == WANT[name].tobytes()
    assert np.asarray(Image.open(path).convert('RGB')).tobytes() == \
        WANT[name].tobytes()


# --- orientations: PIL transposes at load ---------------------------------

ORIENT_LAYOUTS = {
    'strips_raw': lambda p, o: Image.fromarray(RGB).save(
        p, tiffinfo={274: o}),
    'tiles_deflate': lambda p, o: libtiff_write(
        p, RGB, 2, 8, tile=(16, 16), tags=((274, o),)),
    'jpeg_ycbcr': lambda p, o: libtiff_write(
        p, RGB, 6, 7, strip=16, subsampling=(2, 2), tags=((274, o),)),
    'ycbcr21_packbits': lambda p, o: libtiff_write(
        p, YCC, 6, 32773, strip=8, subsampling=(2, 1), tags=((274, o),)),
    'g4': lambda p, o: libtiff_write(p, BITS, 0, 4, bits=1,
                                     tags=((274, o),)),
}


@pytest.mark.parametrize('orientation', range(1, 9))
@pytest.mark.parametrize('layout', list(ORIENT_LAYOUTS))
def test_orientation_turns_as_pil(tmp_path, layout, orientation):
    path = str(tmp_path / 'o.tif')
    ORIENT_LAYOUTS[layout](path, orientation)
    assert _same_as_pil(path) is None
    shape = ptex.read_rgb8(path).shape
    assert shape[:2] == ((W, H) if orientation > 4 else (H, W))


# --- CCITT ----------------------------------------------------------------

# name -> (compression, photometric, libtiff_write arguments)
CCITT = {
    'rle': (2, 0, {'strip': 8}),
    'rle_tiles': (2, 0, {'tile': (16, 16)}),
    'g3_1d': (3, 0, {'strip': 5}),
    'g3_2d': (3, 0, {'strip': 8, 'tags': ((292, 1),)}),
    'g3_1d_fill': (3, 0, {'tags': ((292, 4),)}),
    'g3_2d_fill': (3, 1, {'strip': 16, 'tags': ((292, 5),)}),
    'g3_uncompressed_bit': (3, 0, {'tags': ((292, 3),)}),
    'g3_fillorder2': (3, 0, {'strip': 8, 'tags': ((266, 2),)}),
    'g3_2d_tiles': (3, 0, {'tile': (32, 16), 'tags': ((292, 1),)}),
    'g4': (4, 0, {}),
    'g4_strips_min_is_black': (4, 1, {'strip': 7}),
    'g4_fillorder2_tiles': (4, 0, {'tile': (16, 32), 'tags': ((266, 2),)}),
}


@pytest.mark.parametrize('name', list(CCITT))
def test_ccitt_decodes_as_pil(tmp_path, name):
    comp, photo, kw = CCITT[name]
    path = str(tmp_path / f'{name}.tif')
    libtiff_write(path, BITS, photo, comp, bits=1, **kw)
    assert _same_as_pil(path) is None


@pytest.mark.parametrize('width', [1, 7, 8, 200, 1731, 2600])
def test_ccitt_every_run_length_class(tmp_path, width):
    """Widths to 2,600: terminating, make-up and extended make-up codes
    of both colours, in G3 2-D and G4, against PIL."""
    rng = np.random.default_rng(width)
    runs = rng.geometric(rng.uniform(0.001, 0.3, 12).repeat(8)[:, None],
                         (96, 64))
    rows = []
    for r in runs:
        edges = np.cumsum(r)
        row = np.zeros(width, np.uint8)
        for k, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
            if k % 2 and a < width:
                row[a:min(b, width)] = 1
        rows.append(row)
    bits = np.stack(rows[:40])[..., None]
    for comp, tags in ((3, ((292, 1),)), (4, ())):
        path = str(tmp_path / f'w{comp}.tif')
        libtiff_write(path, bits, 0, comp, bits=1, strip=16, tags=tags)
        assert _same_as_pil(path) is None


def test_ccitt_uncompressed_mode_ends_the_row_as_libtiff(tmp_path):
    """A 2-D row that enters uncompressed mode (an extension code, which
    libtiff does not decode) keeps its colour to the row's end, and the
    next T.4 row starts at the next EOL: as PIL gives it."""
    eol = '000000000001'
    rows = [eol + '1' + '101010',                        # 1-D: 16 white
            # 2-D: horizontal (2 white, 3 black), then an extension code
            # (uncompressed mode) and its data
            eol + '0' + '001' + '0111' + '10' + '0000001' + '111' +
            '0101010101',
            eol + '0' + '111']                           # 2-D: V0 V0 V0
    bits = ''.join(rows) + eol * 6
    bits += '0' * (-len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, 'big')
    path = str(tmp_path / 'ext.tif')
    with open(path, 'wb') as f:
        f.write(tiff_by_hand({
            256: (3, [16]), 257: (3, [3]), 258: (3, [1]), 259: (3, [3]),
            262: (3, [0]), 273: (4, [('blob', 0)]), 277: (3, [1]),
            278: (3, [3]), 279: (4, [len(data)]), 292: (4, [3])}, [data]))
    assert _same_as_pil(path) is None


def test_ccitt_of_8_bit_samples_raises_oserror_as_pil(tmp_path):
    path = str(tmp_path / 'g4_8bit.tif')
    Image.fromarray(RGB[..., 0]).save(path)
    with open(path, 'r+b') as f:              # the compression tag says G4
        data = f.read()
        pos = struct.unpack_from('<I', data, 4)[0]
        for k in range(struct.unpack_from('<H', data, pos)[0]):
            e = pos + 2 + 12 * k
            if struct.unpack_from('<H', data, e)[0] == 259:
                f.seek(e + 8)
                f.write(struct.pack('<H', 4))
    assert _same_as_pil(path) is OSError


# --- old-style JPEG -------------------------------------------------------

@pytest.mark.parametrize('sub,rps', [(2, 16), (2, 32), (1, 8), (0, 8),
                                     (0, 24)])
def test_old_jpeg_tables_and_strips_as_pil(tmp_path, sub, rps):
    """Strips of entropy-coded data with ``JPEGProc`` tables, each strip a
    restart interval of a JPEG PIL wrote (4:2:0, 4:2:2, 4:4:4)."""
    import io
    hs, vs = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[sub]
    buf = io.BytesIO()
    kw = {'restart_marker_rows': rps // (8 * vs)} if rps < H else {}
    Image.fromarray(RGB).save(buf, 'JPEG', quality=80, subsampling=sub, **kw)
    q, dht, tq, strips = _jpeg_segments(buf.getvalue())
    n = len(strips)
    blobs = strips + [q[tq[k]] for k in range(3)] + \
        [dht[min(k, 1)] for k in range(3)] + \
        [dht[0x10 | min(k, 1)] for k in range(3)]
    tags = {256: (3, [W]), 257: (3, [H]), 258: (3, [8, 8, 8]),
            259: (3, [6]), 262: (3, [6]), 277: (3, [3]),
            273: (4, [('blob', i) for i in range(n)]), 278: (3, [rps]),
            279: (4, [len(x) for x in strips]), 512: (3, [1]),
            519: (4, [('blob', n + k) for k in range(3)]),
            520: (4, [('blob', n + 3 + k) for k in range(3)]),
            521: (4, [('blob', n + 6 + k) for k in range(3)]),
            530: (3, [hs, vs])}
    if n > 1:
        tags[515] = (3, [rps // (8 * vs) * -(-W // (8 * hs))])
    path = str(tmp_path / 'ojpeg.tif')
    with open(path, 'wb') as f:
        f.write(tiff_by_hand(tags, blobs))
    assert _same_as_pil(path) is None


def test_old_jpeg_without_tables_raises_oserror_as_pil(tmp_path):
    path = str(tmp_path / 'ojpeg_bare.tif')
    with open(path, 'wb') as f:
        f.write(tiff_by_hand({
            256: (3, [W]), 257: (3, [H]), 258: (3, [8, 8, 8]),
            259: (3, [6]), 262: (3, [6]), 277: (3, [3]),
            273: (4, [('blob', 0)]), 278: (3, [H]), 279: (4, [64])},
            [bytes(range(64))]))
    assert _same_as_pil(path) is OSError


# --- CIELab ---------------------------------------------------------------

def test_lab_to_rgb_equals_pil_on_every_triple():
    """PIL's LAB -> RGB (LittleCMS, Lab D50 to sRGB) of a 4,096^2 image
    holding every triple, against ``utils/lab.py`` in 256 slices of L."""
    idx = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([idx >> 16, (idx >> 8) & 255, idx & 255],
                   -1).astype(np.uint8)
    # PIL's LAB raw mode offsets a* and b* by 128 as it unpacks
    im = Image.frombytes('LAB', (4096, 4096),
                         (lab ^ np.uint8([0, 128, 128])).tobytes())
    assert im.getpixel((5, 0)) == (0, 0, 5)
    want = np.asarray(im.convert('RGB')).reshape(256, 65536, 3)
    del im
    lab = lab.reshape(256, 65536, 3)
    bad = sum(int((lab_to_rgb(lab[k]) != want[k]).any(-1).sum())
              for k in range(256))
    assert bad == 0


@pytest.mark.parametrize('comp,order,planar', [(1, 'II', 1), (5, 'II', 1),
                                               (8, 'MM', 1), (1, 'MM', 1)])
def test_cielab_tiff_as_pil(tmp_path, comp, order, planar):
    lab = np.asarray(Image.fromarray(RGB).convert('LAB')) ^ \
        np.uint8([0, 128, 128])                  # signed a* and b*
    path = str(tmp_path / 'lab.tif')
    libtiff_write(path, lab, 8, comp, strip=8, order=order)
    assert _same_as_pil(path) is None


# --- 12-bit grey ----------------------------------------------------------

@pytest.mark.parametrize('comp,width', [(1, W), (1, 1), (1, 2), (5, W),
                                        (8, 16), (32773, W)])
def test_12_bit_grey_as_pil(tmp_path, comp, width):
    """PIL's own unpacker (uncompressed) and its libtiff path give the
    same 12-bit samples as ``I;16``, clipped to 255 by ``convert``."""
    v = _rng.integers(0, 4096, (H, width, 1)).astype(np.uint16)
    v[0, :min(width, 4), 0] = (0, 255, 256, 4095)[:min(width, 4)]
    path = str(tmp_path / 'g12.tif')
    libtiff_write(path, v, 1, comp, strip=7, bits=12)
    assert Image.open(path).mode == 'I;16'
    assert _same_as_pil(path) is None


def test_12_bit_grey_big_endian_fails_as_pil(tmp_path):
    v = _rng.integers(0, 4096, (H, W, 1)).astype(np.uint16)
    path = str(tmp_path / 'g12_mm.tif')
    libtiff_write(path, v, 1, 1, bits=12, order='MM')
    assert issubclass(_same_as_pil(path), OSError)  # no such PIL layout


# --- YCbCr ----------------------------------------------------------------

@pytest.mark.parametrize('comp', [1, 5, 8])
def test_one_sample_ycbcr_as_pil(tmp_path, comp):
    """Uncompressed: PIL's own reader takes it as grey; compressed:
    libtiff's RGBA reader has no routine for one sample (OSError)."""
    path = str(tmp_path / 'y1.tif')
    libtiff_write(path, YCC[..., :1], 6, comp, strip=8, subsampling=(1, 1))
    assert _same_as_pil(path) is (None if comp == 1 else OSError)


@pytest.mark.parametrize('comp,sub', [(1, (1, 1)), (5, (1, 1)), (8, (1, 1)),
                                      (5, (2, 2)), (1, (2, 2))])
def test_planar_ycbcr_as_pil(tmp_path, comp, sub):
    """YCbCr in planes: uncompressed read as they are (full-size planes:
    subsampled ones run off the file's end); compressed converted by
    libtiff at 1x1, refused above."""
    hs, vs = sub
    from port_make_bitmaps import _libtiff_lib
    import ctypes
    lib = _libtiff_lib()
    path = str(tmp_path / 'yp.tif')
    t = lib.TIFFOpen(path.encode(), b'w')
    for tag, *vals in ((256, W), (257, H), (258, 8), (277, 3), (259, comp),
                       (262, 6), (284, 2), (278, H), (530, hs, vs)):
        assert lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(tag),
                                *[ctypes.c_uint32(v) for v in vals]) == 1
    for k in range(3):
        plane = YCC[..., k] if k == 0 else YCC[::vs, ::hs, k]
        data = np.ascontiguousarray(plane).tobytes()
        assert lib.TIFFWriteEncodedStrip(t, k, data, len(data)) >= 0
    lib.TIFFClose(t)
    want = None if sub == (1, 1) else OSError
    assert _same_as_pil(path) is want


@pytest.mark.parametrize('sub', [(1, 2), (2, 1), (2, 2), (4, 1), (4, 2),
                                 (4, 4)])
@pytest.mark.parametrize('comp,rows', [(5, 8), (8, 4), (32946, 23)])
def test_ycbcr_predictor_2_above_1x1_as_pil(tmp_path, sub, comp, rows):
    """libtiff runs its predictor over scanlines of a block row over its
    height, at a stride of 3 bytes; where a scanline holds no whole
    number of strides it fails the strip and PIL converts the data
    undifferenced (2x1 at 37 wide)."""
    path = str(tmp_path / 'yp2.tif')
    libtiff_write(path, YCC, 6, comp, strip=rows, subsampling=sub,
                  tags=((317, 2),))
    assert _same_as_pil(path) is None


@pytest.mark.parametrize('sub', [(1, 1), (2, 2), (4, 1)])
def test_ycbcr_predictor_2_tiles_as_pil(tmp_path, sub):
    path = str(tmp_path / 'yp2t.tif')
    libtiff_write(path, YCC, 6, 8, tile=(16, 16), subsampling=sub,
                  tags=((317, 2),))
    assert _same_as_pil(path) is None


# --- the load path against the reference ----------------------------------

def test_load_bitmap_of_ccitt_bc7_qoi_matches_reference(tmp_path):
    """``texture.load_bitmap`` (gamma on and off) of a G4 TIFF, a BC7 DDS
    of seeded random blocks and a QOI file equals the reference's, which
    opens each through PIL: to the byte (both take PIL's 8-bit RGB to
    float32 the same way)."""
    g4 = str(tmp_path / 'g4.tif')
    libtiff_write(g4, BITS, 0, 4, bits=1, strip=8)
    bc7 = str(tmp_path / 'bc7.dds')
    with open(bc7, 'wb') as f:
        f.write(bitmap_stages.bcn_random_dds(W, H, 98, 5))
    qoi = str(tmp_path / 'rgb.qoi')
    Image.fromarray(RGB).save(qoi, 'QOI')
    for path in (g4, bc7, qoi):
        for gamma in (True, False):
            want = jtex.load_bitmap(path, gamma=gamma)
            got = ptex.load_bitmap(path, gamma=gamma)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
