"""The rest of PIL's raster formats (``utils/sun.py``, ``blp.py``,
``ftex.py``, ``fits.py``, ``spider.py``, ``im.py``, ``imt.py``,
``msp.py``, ``fli.py``, ``xbm.py``, ``xpm.py``, ``gbr.py``,
``mcidas.py``, ``pixar.py``, ``xvthumb.py``, ``pcd.py``, ``dcx.py``,
``iptc.py``) and the six formats PIL opens and cannot load
(``utils/stubs.py``), against PIL and the reference.

The committed fixtures (``scripts/port_make_bitmaps.py``) decode to PIL's
stored bytes and load as the reference loads them, with both gammas; the
decoders return PIL's mode and samples; the refused files raise PIL's
class; ``identify`` names PIL's format for every fixture, old and new
(IM, IMT, IPTC, PCD and SPIDER found as PIL finds them, by opening). Files
written here by ``testing/raster_files`` cover each layout of the
plugins (every Sun depth and type, BLP's encodings, every FLI chunk at
odd and even widths, every IM image type of PIL's ``OPEN``, ...), Photo
CD files (too large to commit) and seeded corruptions of the fixtures,
each held to PIL: its bytes, or its exception class.
"""
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba_nlvrl_tpu import texture as jtex
from mitsuba_nlvrl_tpu_torch import texture as ptex
from mitsuba_nlvrl_tpu_torch.testing import raster_files as R
from mitsuba_nlvrl_tpu_torch.utils import im as pim

torch.set_num_threads(1)   # one intra-op thread a test worker

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
REFUSED = os.path.join(HERE, 'data', 'bitmaps_refused')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
with open(os.path.join(REFUSED, 'pil_errors.json')) as _f:
    ERRORS = json.load(_f)
# file suffix -> PIL's format
SUFFIX = {'.ras': 'SUN', '.blp': 'BLP', '.ftc': 'FTEX', '.ftu': 'FTEX',
          '.fits': 'FITS', '.spi': 'SPIDER', '.im': 'IM', '.imt': 'IMT',
          '.msp': 'MSP', '.fli': 'FLI', '.flc': 'FLI', '.xbm': 'XBM',
          '.xpm': 'XPM', '.gbr': 'GBR', '.area': 'MCIDAS', '.pxr': 'PIXAR',
          '.xv': 'XVThumb', '.dcx': 'DCX', '.iim': 'IPTC'}
STUBS = ('BUFR', 'GRIB', 'HDF5', 'MPEG', 'EPS', 'WMF')
NAMES = sorted(n for n in WANT.files if os.path.splitext(n)[1] in SUFFIX)
REFUSED_REST = sorted(n for n in ERRORS if os.path.splitext(n)[1] in SUFFIX
                      or n.startswith('stub.'))
H, W = 23, 37
_rng = np.random.default_rng(41)
RGB = _rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
RGB[4:9] = RGB[4:5, :1]                         # flat rows: runs
IDX = _rng.integers(0, 256, (H, W), dtype=np.uint8)
IDX[10, 3:33] = 7
BITS = (_rng.random((H, W)) < 0.5).astype(np.uint8)
COLOURS = _rng.integers(0, 256, (256, 3))


def _pil(path):
    """PIL's format and RGB bytes of the file, or its exception class."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            im = Image.open(path)
            return im.format, np.asarray(im.convert('RGB'))
    except Exception as e:          # noqa: BLE001 - the class is compared
        return None, type(e)


def _raises_as(want, path):
    """The port raises PIL's class: the builtin itself, or (a class of
    PIL's own) one of its name, or an OSError for PIL's
    UnidentifiedImageError and DecompressionBombError's kin."""
    try:
        ptex.read_rgb8(path)
    except Exception as e:          # noqa: BLE001 - the class is compared
        got = type(e)
    else:
        raise AssertionError(f"decoded where PIL raises {want.__name__}")
    if issubclass(want, OSError):
        assert issubclass(got, OSError), got
    else:
        assert got is want or got.__name__ == want.__name__, (got, want)


def _same_as_pil(path):
    fmt, want = _pil(path)
    if isinstance(want, type):
        _raises_as(want, path)
        return want
    assert ptex.identify(path) == fmt
    got = ptex.read_rgb8(path)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    return None


def test_fixtures_cover_every_format():
    """Each of the slice's formats has committed fixtures, the picture
    among them as a 24-bit RLE Sun raster and an RGB IM file; the refused
    files hold each stub format and some of every other."""
    formats = {SUFFIX[os.path.splitext(n)[1]] for n in NAMES}
    assert formats == set(SUFFIX.values()), formats
    assert 'picture64.ras' in NAMES and 'picture64.im' in NAMES
    assert len(NAMES) >= 85, len(NAMES)
    assert {f'stub.{f.lower()}' for f in STUBS} <= set(REFUSED_REST)
    assert len(REFUSED_REST) >= 35, len(REFUSED_REST)


@pytest.mark.parametrize('name', NAMES)
def test_fixture_loads_as_reference(name):
    """PIL's format, its stored bytes, and the reference's
    ``load_bitmap`` with gamma on and off, each equal."""
    path = os.path.join(FIXTURES, name)
    assert ptex.identify(path) == Image.open(path).format == \
        SUFFIX[os.path.splitext(name)[1]]
    assert ptex.read_rgb8(path).tobytes() == WANT[name].tobytes()
    for gamma in (True, False):
        got = ptex.load_bitmap(path, gamma=gamma)
        want = jtex.load_bitmap(path, gamma=gamma)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('name', NAMES)
def test_decoder_mode_is_pils(name):
    """The mode PIL opens each file in and the samples it holds (``1`` as
    0 and 255, an RGBX padding byte kept, a palette image's indices)."""
    path = os.path.join(FIXTURES, name)
    mode, px, _ = ptex._decode(path)
    im = Image.open(path)
    assert mode == im.mode
    want = np.asarray(im)
    if mode == '1':
        want = want.astype(np.uint8) * 255
    if px.ndim == 3 and want.ndim == 3 and px.shape[2] > want.shape[2]:
        px = px[..., :want.shape[2]]
    assert px.shape == want.shape
    if mode == 'F':
        assert np.array_equal(px, want, equal_nan=True)
    else:
        assert px.tobytes() == want.astype(px.dtype).tobytes()


@pytest.mark.parametrize('name', REFUSED_REST)
def test_refused_file_raises_pils_class(name):
    path = os.path.join(REFUSED, name)
    fmt, want = _pil(path)
    assert isinstance(want, type) and want.__name__ == ERRORS[name]['error']
    _raises_as(want, path)


@pytest.mark.parametrize('fmt', STUBS)
def test_stub_formats_raise_oserror_in_both(fmt):
    """BUFR, GRIB, HDF5, MPEG, EPS and WMF: PIL opens them and fails at
    load (no handler, no MPEG decoder, no Ghostscript), as the port
    fails; both packages raise ``OSError``."""
    path = os.path.join(REFUSED, f'stub.{fmt.lower()}')
    assert Image.open(path).format == ptex.identify(path) == fmt
    for load in (jtex.load_bitmap, ptex.load_bitmap):
        with pytest.raises(OSError):
            load(path)


def test_avif_still_names_its_roadmap_entry(tmp_path):
    path = str(tmp_path / 'img.avif')
    Image.fromarray(RGB).save(path, 'AVIF')
    assert ptex.identify(path) == 'AVIF'
    with pytest.raises(NotImplementedError, match=r'item 12\.7'):
        ptex.load_bitmap(path)


@pytest.mark.parametrize('name', sorted(WANT.files))
def test_identify_names_pils_format(name):
    """Every fixture, old and new: the factory checks added for IM, IMT,
    IPTC, PCD and SPIDER claim no file of another format."""
    path = os.path.join(FIXTURES, name)
    assert ptex.identify(path) == Image.open(path).format


# --- layouts written here --------------------------------------------------

def _sun(depth, ftype, colours=None):
    px = {1: BITS, 4: IDX & 15, 8: IDX, 24: RGB,
          32: np.concatenate([RGB, IDX[..., None]], -1)}[depth]
    return R.sun_file(px, depth, ftype, colours=colours)


def _blp_dxt(ae, size, alpha, w=W, h=H):
    blocks = np.random.default_rng(ae * 7 + alpha + w).integers(
        0, 256, -(-w // 4) * -(-h // 4) * size, dtype=np.uint8).tobytes()
    return R.blp_file(2, w, h, blocks, encoding=2, alpha=alpha,
                      alpha_encoding=ae)


def _jpeg(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, 'JPEG', quality=90, **kw)
    return b.getvalue()


def _blp_jpeg(img, alpha=0, w=W):
    j = _jpeg(img)
    sos = j.find(b'\xff\xda')
    return R.blp_file(1, w, H, j[sos:], compression=0, alpha=alpha,
                      jpeg_header=j[:sos])


def _fli(width, chunks, magic=0xAF12):
    return R.fli_file(width, H, [R.fli_frame(chunks)], magic)


_B = IDX.copy()
_B[2:8, 4:30] = 200
_B[15, :] = 9
_C = _B.copy()
_C[11:14, 1:36] = 44
_C[20, 36] = 3
_C[21, 35] = 4


def _fli_case(width, kind):
    a, b, c = IDX[:, :width], _B[:, :width], _C[:, :width]
    pal = R.fli_colour(COLOURS)
    return {'brun': [pal, R.fli_brun(a)],
            'brun_runs': [pal, R.fli_brun(a, copies=False)],
            'lc': [pal, R.fli_brun(a), R.fli_lc(a, b)],
            'ss2': [pal, R.fli_brun(a), R.fli_lc(a, b), R.fli_ss2(b, c)],
            'copy': [pal, R.fli_chunk(16, c.tobytes())],
            'black_pstamp': [R.fli_chunk(18, bytes(30)), pal,
                             R.fli_brun(a), R.fli_chunk(13, b'')]}[kind]


LAYOUTS = {
    **{f'sun_{d}_type{t}': (lambda d=d, t=t: _sun(d, t))
       for d in (1, 4, 8, 24, 32) for t in (0, 1, 2, 3, 4, 5)},
    **{f'sun_{d}_type{t}_colour_map': (
        lambda d=d, t=t: _sun(d, t, COLOURS[:16 if d == 4 else 200]))
       for d in (4, 8) for t in (1, 2)},
    'sun_1_colour_map': lambda: _sun(1, 1, COLOURS[:2]),
    'sun_rle_run_across_rows': lambda: R.sun_file(
        IDX, 8, 2, rle_data=b'\x80\xff\x09' * 4 + IDX.tobytes()[1024:]),
    'sun_rle_lone_0x80': lambda: R.sun_file(
        np.full((H, W), 0x80, np.uint8) ^ (BITS << 7), 8, 2),
    'sun_colour_map_1025': lambda: _sun(8, 1)[:28] + struct.pack(
        '>I', 1025) + _sun(8, 1)[32:],
    'sun_type6': lambda: _sun(8, 1)[:20] + struct.pack('>I', 6) +
    _sun(8, 1)[24:],
    **{f'blp{v}_palette_alpha{a}': (
        lambda v=v, a=a: R.blp_file(v, W, H, IDX.tobytes(), alpha=a,
                                    encoding=1 if v == 2 else 4,
                                    palette=COLOURS.astype(
                                        np.uint8).tobytes() * 2))
       for v in (1, 2) for a in (0, 1, 4, 8)},
    **{f'blp2_dxt{ae}_alpha{a}_width{w}': (
        lambda ae=ae, a=a, w=w: _blp_dxt(ae, 8 if ae == 0 else 16, a, w))
       for ae in (0, 1, 7) for a in (0, 8) for w in (W, 32)},
    'blp1_jpeg_grey': lambda: _blp_jpeg(IDX),
    'blp1_jpeg_rgb_alpha': lambda: _blp_jpeg(RGB, 8),
    'blp1_jpeg_wider_than_image': lambda: _blp_jpeg(RGB, 0, W + 8),
    'blp1_jpeg_not_jpeg': lambda: R.blp_file(1, W, H, b'junk' * 40,
                                             compression=0,
                                             jpeg_header=b'none'),
    'blp1_encoding3': lambda: R.blp_file(1, W, H, bytes(1000), encoding=3),
    'blp2_compression0': lambda: R.blp_file(2, W, H, bytes(1000),
                                            compression=0),
    'blp2_dxt_truncated': lambda: _blp_dxt(7, 16, 8)[:-40],
    **{f'fli_{kind}_width{w}': (lambda kind=kind, w=w: _fli(
        w, _fli_case(w, kind)))
       for kind in ('brun', 'brun_runs', 'lc', 'ss2', 'copy',
                    'black_pstamp') for w in (W, W - 1)},
    'fli_colour64': lambda: _fli(W, [R.fli_colour(COLOURS >> 2 << 2, 2),
                                     R.fli_brun(IDX)], 0xAF11),
    'fli_colour64_wraps': lambda: _fli(W, [R.fli_colour(
        np.full((256, 3), 255), 2)[:6] + R.fli_colour(
        np.full((256, 3), 255), 2)[6:].replace(b'\x3f', b'\x7f'),
        R.fli_brun(IDX)]),
    'fli_two_palettes_first_kept': lambda: _fli(W, [
        R.fli_colour(COLOURS), R.fli_colour(COLOURS[::-1]),
        R.fli_brun(IDX)]),
    'fli_brun_short_row': lambda: _fli(W, [R.fli_chunk(
        15, b''.join(b'\x00\x05' + bytes([7]) for _ in range(H)))]),
    'fli_lc_past_rows': lambda: _fli(W, [R.fli_chunk(
        12, struct.pack('<HH', 20, 9) + bytes(3) * 9)]),
    'fli_ss2_skip_past_rows': lambda: _fli(W, [R.fli_chunk(
        7, struct.pack('<HH', 1, 65536 - 40))]),
    'fli_zero_size_chunk': lambda: _fli(W, [struct.pack('<IH', 0, 13)]),
    'fli_copy_short': lambda: _fli(W, [R.fli_chunk(16, bytes(100))]),
    'fli_frame_size_zero': lambda: _fli(W, [R.fli_brun(IDX)])[:128] +
    bytes(4) + _fli(W, [R.fli_brun(IDX)])[132:],
    **{f'im_{k}': (lambda k=k: R.im_file(
        k, W, H, _rng.integers(0, 256, W * H * 8,
                               dtype=np.uint8).tobytes()))
       for k in [k[:-6] for k in pim.OPEN]},
    'im_truncated_mapped': lambda: R.im_file('Greyscale', W, H,
                                             IDX.tobytes()[:200]),
    'im_truncated_rgb': lambda: R.im_file('RGB', W, H, RGB.tobytes()[:200]),
    'im_lut_short': lambda: R.im_file('Greyscale', W, H, b'',
                                      lut=COLOURS.astype(np.uint8)
                                      .tobytes()[:300]),
    'im_no_end_byte': lambda: R.im_file('RGB', W, H, b'', end=b''),
    'im_nul_then_end': lambda: R.im_file('RGB', W, H, b'\0\0\x1a' +
                                         RGB.tobytes(), end=b'\0'),
    'im_float_size': lambda: b'Image type: Greyscale image\r\n' \
    b'Image size (x*y): 3.5*2\r\n\x1a' + bytes(100),
    'im_bad_line': lambda: R.im_file('RGB', W, H, RGB.tobytes(),
                                     extra=[b'no colon here']),
    'im_long_line': lambda: R.im_file('RGB', W, H, RGB.tobytes(),
                                      extra=[b'Name: ' + b'n' * 120]),
    'xpm_two_chars': lambda: R.xpm_file(IDX % 100, [
        '#%02x%02x%02x' % tuple(c) for c in COLOURS[:100]], keys=[
        bytes([65 + i // 10, 97 + i % 10]) for i in range(100)]),
    'xpm_short_hex': lambda: R.xpm_file(IDX % 4, ['#fff', '#000',
                                                  '#f00', '#00f']),
    'xpm_none_unused': lambda: R.xpm_file(IDX % 4, [
        '#111111', '#222222', '#333333', '#444444'], none_key=b'~'),
    'xpm_truncated': lambda: R.xpm_file(IDX % 4, [
        '#111111', '#222222', '#333333', '#444444'])[:-120],
    'xpm_rgb_missing_key': lambda: R.xpm_file(
        (IDX.astype(np.int64) * 300) // 256, [
            '#%06x' % v for v in range(300)]).replace(b'"AB', b'"~~'),
    'xbm_hex_upper_case': lambda: _xbm().replace(b'0x', b'0X').replace(
        b'0X', b'0x', 5).upper().replace(b'#DEFINE', b'#define').replace(
        b'_WIDTH', b'_width').replace(b'_HEIGHT', b'_height').replace(
        b'_BITS', b'_bits').replace(b'0X', b'0x'),
    'xbm_x_in_digits': lambda: _xbm().replace(b'0x0', b'0xx', 4),
    'gbr_v2_short_magic': lambda: R.gbr_file(IDX, 2)[:20] + b'GIMQ' +
    R.gbr_file(IDX, 2)[24:],
    'gbr_v2_header_19': lambda: struct.pack('>I', 24) +
    R.gbr_file(IDX, 2)[4:],
    **{f'mcidas_{b}_prefix{p}_bands{n}': (
        lambda b=b, p=p, n=n: R.mcidas_file(
            IDX.astype(np.int64) * (1 if b == 1 else 97) - (
                0 if b < 4 else 9000), b, prefix=p, bands=n))
       for b in (1, 2, 4) for p, n in ((0, 1), (3, 2))},
    'pixar_other_layout': lambda: R.pixar_file(RGB, (14, 3)),
    'xvthumb_no_comments': lambda: R.xvthumb_file(IDX, ()),
    'xvthumb_one_token': lambda: b'P7 332\n#c\n37\n' + IDX.tobytes(),
    'dcx_rgb': lambda: R.dcx_file([_pcx(RGB), _pcx(IDX)]),
    'dcx_grey_palette_at_end': lambda: R.dcx_file([_pcx(IDX), _pcx(RGB)]),
    'iptc_grey_one_record': lambda: R.iptc_file(IDX.tobytes(), W, H,
                                                parts=1),
    **{f'iptc_{m}_band{b}': (lambda n=n, b=b: R.iptc_file(
        IDX.tobytes(), W, H, n, 1, band=b))
       for m, n in (('rgb', 3), ('cmyk', 4)) for b in (0, 1, 3)},
    'iptc_rgb_no_band': lambda: R.iptc_file(IDX.tobytes(), W, H, 3, 1),
    'iptc_jpeg_grey': lambda: R.iptc_file(_jpeg(IDX), W, H, compression=5),
    'iptc_jpeg_band': lambda: R.iptc_file(_jpeg(IDX), W, H, 3, 1, band=2,
                                          compression=5),
    'iptc_jpeg_rgb_band': lambda: R.iptc_file(_jpeg(RGB), W, H, 3, 1,
                                              band=2, compression=5),
    'iptc_truncated': lambda: R.iptc_file(IDX.tobytes()[:-99], W, H),
    'iptc_two_layers': lambda: R.iptc_file(IDX.tobytes(), W, H, 2, 1),
    'iptc_bad_record_after': lambda: R.iptc_file(IDX.tobytes(), W, H) +
    b'\x1d\x02\x03\x00\x00',
    'ftex_rgb_short': lambda: R.ftex_file(W, H, 1, RGB.tobytes()[:-5]),
    'ftex_size_minus_one': lambda: R.ftex_file(W, H, 1, RGB.tobytes())[
        :32] + struct.pack('<i', -1) + RGB.tobytes(),
    'ftex_size_minus_two': lambda: R.ftex_file(W, H, 1, RGB.tobytes())[
        :32] + struct.pack('<i', -2) + RGB.tobytes(),
    'ftex_zero_width': lambda: R.ftex_file(0, H, 1, RGB.tobytes()),
    **{f'fits_{b}_{"gzip" if g else "raw"}': (lambda b=b, g=g: R.fits_file(
        (IDX.astype(np.float64) * 3.3 - 100) if b < 0 else
        IDX.astype(np.int64) * (1 if b == 8 else 131) - (0 if b == 8 else
                                                         900), b,
        gzip_tile=g))
       for b in (8, 16, 32, -32, -64) for g in (False, True)},
    'fits_one_axis': lambda: R.fits_file(IDX[:1], 8).replace(
        b'NAXIS   =                    2', b'NAXIS   =                    1'),
    'fits_bitpix_12': lambda: R.fits_file(IDX, 8).replace(
        b'BITPIX  =                    8', b'BITPIX  =                   12'),
    'fits_not_simple': lambda: R.fits_file(IDX, 8).replace(
        b'=                    T', b'=                    F', 1),
}


def _xbm():
    b = io.BytesIO()
    Image.fromarray(BITS.astype(bool)).save(b, 'XBM')
    return b.getvalue()


def _pcx(img):
    b = io.BytesIO()
    Image.fromarray(img).save(b, 'PCX')
    return b.getvalue()


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_layout_as_pil(layout, tmp_path):
    path = str(tmp_path / 'f')
    with open(path, 'wb') as f:
        f.write(LAYOUTS[layout]())
    _same_as_pil(path)


@pytest.mark.parametrize('orientation', range(4))
def test_photo_cd_as_pil(orientation, tmp_path):
    """The 768x512 base image of seeded samples, turned as its
    orientation bits say; cut short, ``OSError`` in both."""
    chunks = np.random.default_rng(orientation).integers(0, 256,
                                                         (256, 2304))
    path = str(tmp_path / 'f.pcd')
    with open(path, 'wb') as f:
        f.write(R.pcd_file(chunks, orientation))
    assert ptex.identify(path) == 'PCD'
    assert _same_as_pil(path) is None
    for gamma in (True, False):
        assert ptex.load_bitmap(path, gamma).tobytes() == \
            jtex.load_bitmap(path, gamma).tobytes()
    with open(path, 'r+b') as f:
        f.truncate(96 * 2048 + 500_000)
    assert _same_as_pil(path) is not None


# (fixture, number of corruptions): seeded cuts and byte flips, biased
# to the header, of a fixture of each format
FUZZED = {'sun_8_rle.ras': 30, 'sun_32_rle.ras': 20, 'sun_4.ras': 10,
          'blp2_palette_alpha8.blp': 20, 'blp2_dxt1_alpha1.blp': 20,
          'ftex_dxt1.ftc': 20, 'fits_16.fits': 20, 'fits_gzip_8.fits': 20,
          'spider_be.spi': 20, 'spider_stack.spi': 10,
          'im_pil_rgb.im': 20, 'im_b4_lut.im': 20, 'im_l12_bits.im': 20,
          'imt.imt': 20, 'msp_v1.msp': 10, 'msp_v2.msp': 30,
          'flc_lc_ss2.flc': 40, 'fli_brun_colour64.fli': 20,
          'flc_copy_black_pstamp.flc': 20, 'xbm.xbm': 20,
          'xpm_palette.xpm': 20, 'gbr_v2_rgba.gbr': 20,
          'mcidas_16.area': 20, 'pixar.pxr': 10, 'xvthumb.xv': 10,
          'dcx_rgb.dcx': 20, 'iptc_rgb_band.iim': 20}


def _bombs(path):
    """Whether PIL refuses the file as a decompression bomb (an image
    over twice its pixel limit): the port reads no such size check
    (ROADMAP 12.7, known divergences)."""
    try:
        Image.open(path)
    except Image.DecompressionBombError:
        return True
    except Exception:               # noqa: BLE001 - another failure
        return False
    return False


@pytest.mark.parametrize('name', sorted(FUZZED))
def test_corrupt_fixture_fails_as_pil(name, tmp_path):
    base = open(os.path.join(FIXTURES, name), 'rb').read()
    rng = np.random.default_rng(sum(map(ord, name)))
    seen = {'bytes': 0, 'raised': 0}
    for k in range(FUZZED[name]):
        d = bytearray(base)
        if k % 5 == 0:
            d = d[:int(rng.integers(1, len(d)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                pos = int(rng.integers(0, min(len(d), 300))) if k % 2 else \
                    int(rng.integers(0, len(d)))
                d[pos] = int(rng.integers(0, 256))
        path = str(tmp_path / f'{k}_{name}')
        with open(path, 'wb') as f:
            f.write(bytes(d))
        if _bombs(path):
            continue
        seen['raised' if _same_as_pil(path) else 'bytes'] += 1
    assert seen['bytes'] and seen['raised'], seen


def test_textured_render_equal_for_sun_and_im_copies(tmp_path):
    """``cbox_textured`` (16x16, 1 spp, on the CPU) with the 64x64 picture
    as every bitmap renders the same image in every bit from its PNG, its
    24-bit RLE Sun raster and its RGB IM copies (the card's
    ``textured_formats`` phase at a smaller size)."""
    import mitsuba_nlvrl_tpu_torch as P
    from mitsuba_nlvrl_tpu_torch.scene.xml import load_file
    from mitsuba_nlvrl_tpu_torch.testing.scenes import cbox_textured
    imgs = {}
    for ext in ('png', 'ras', 'im'):
        path = cbox_textured(str(tmp_path / ext), spp=1, res=16,
                             bitmap=os.path.join(FIXTURES,
                                                 f'picture64.{ext}'))
        scene, meta = P.build_scene(load_file(path), device='cpu')
        assert scene.textures.data.shape[1:3] == (64, 64)
        imgs[ext] = P.render(scene, meta, seed=0)
    for ext, img in imgs.items():
        assert torch.equal(img, imgs['png']), ext
