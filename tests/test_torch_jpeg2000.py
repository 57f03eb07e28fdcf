"""The port's JPEG 2000 decoder (``utils/j2k.py`` and ``utils/jp2.py``; tier
1, the inverse wavelets and the colour transforms in
``native/bitmap_j2k.cpp``) against PIL and the reference's ``load_bitmap``.

Every committed JP2 and J2K fixture (PIL's writer in each mode and with
each option it has; codestreams written through openjpeg's own settings:
code-block styles, SOP and EPH, tile parts, RGN, POC, other precisions;
files built here around PIL's codestreams: palettes, channel definitions,
colour spaces, derived quantisation, COC and QCC, tile-part headers, tile
parts out of order) loads equal in bytes to the reference with gamma on
and off, its mode and samples before ``convert`` equal to PIL's, with every
plain twin made to raise. Seeded sweeps of PIL's and openjpeg's options,
cut files and missing tiles behave as PIL does; the features outside the
port raise naming ROADMAP 12.7.
"""
import hashlib
import io
import json
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

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), 'scripts'))
from port_make_bitmaps import openjpeg_write  # noqa: E402

torch.set_num_threads(1)   # one intra-op thread a test worker

FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
LARGE = os.path.join(HERE, 'data', 'bitmaps_large')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
NAMES = sorted(n for n in WANT.files if n.endswith(('.jp2', '.j2k')))
H, W = 23, 37
_rng = np.random.default_rng(2000)
NOISE = _rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
_yy, _xx = np.mgrid[0:H, 0:W]
SMOOTH = np.stack([(_xx * 7) % 256, (_yy * 11) % 256, (_xx * _yy) % 256,
                   (_xx + 3 * _yy) % 256], -1).astype(np.uint8)


def _pil_image(mode, pixels):
    if mode == 'L':
        return Image.fromarray(pixels[..., 0])
    if mode == 'I;16':
        return Image.fromarray((pixels[..., 0].astype(np.uint16) << 8 |
                                pixels[..., 1]).astype('<u2'))
    if mode == 'LA':
        return Image.fromarray(pixels[..., :2], 'LA')
    if mode == 'RGB':
        return Image.fromarray(pixels[..., :3])
    return Image.fromarray(pixels, mode)         # RGBA, CMYK


def _same_as_pil(path):
    """The port's mode and samples equal PIL's and its RGB bytes equal
    PIL's, or both raise one exception type (PIL's OSErrors as OSError).
    Returns PIL's exception type, or None."""
    try:
        im = Image.open(path)
        im.load()
        want = np.asarray(im.convert('RGB'))
    except Exception as e:          # noqa: BLE001 - the type is compared
        exc = OSError if isinstance(e, OSError) else type(e)
        with pytest.raises(exc):
            ptex.read_rgb8(path)
        return type(e)
    mode, px, _ = ptex._decode(path)
    assert mode == im.mode
    assert px.tobytes() == np.asarray(im).tobytes()
    assert ptex.read_rgb8(path).tobytes() == want.tobytes()
    return None


def test_fixtures_are_listed():
    assert len(NAMES) == 74, NAMES


@pytest.mark.parametrize('name', NAMES)
def test_fixture_matches_reference(name):
    """Bytes of the reference's ``load_bitmap`` with gamma on and off;
    mode, samples and palette of PIL's image before ``convert``."""
    path = os.path.join(FIXTURES, name)
    assert ptex.identify(path) == 'JPEG2000'
    with bitmap_stages.forbid_plain():
        for gamma in (True, False):
            got = ptex.load_bitmap(path, gamma=gamma)
            want = jtex.load_bitmap(path, gamma=gamma)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
        mode, px, palette = ptex._decode(path)
    im = Image.open(path)
    im.load()
    assert mode == im.mode
    assert px.tobytes() == np.asarray(im).tobytes()
    if mode in ('P', 'PA'):
        assert palette.tobytes() == bytes(im.palette.palette)
    assert ptex.read_rgb8(path).tobytes() == WANT[name].tobytes()


# PIL's writer options a seeded case draws from (each case draws until
# PIL's writer takes its draw: it refuses some small geometries)
_OPTIONS = (
    {'irreversible': True}, {'mct': 1},
    {'quality_mode': 'rates', 'quality_layers': [40, 20, 10]},
    {'quality_mode': 'dB', 'quality_layers': [25, 35, 45]},
    {'tile_size': (16, 8)}, {'tile_size': (13, 11)},
    {'offset': (3, 5), 'tile_offset': (1, 2), 'tile_size': (9, 7)},
    {'offset': (6, 1), 'tile_offset': (2, 0), 'tile_size': (20, 20)},
    {'num_resolutions': 1}, {'num_resolutions': 2}, {'num_resolutions': 3},
    {'codeblock_size': (4, 4)}, {'codeblock_size': (8, 16)},
    {'codeblock_size': (32, 4)},
    {'precinct_size': (16, 16), 'codeblock_size': (4, 4)},
    {'precinct_size': (8, 8), 'num_resolutions': 3},
    {'progression': 'RLCP'}, {'progression': 'RPCL'},
    {'progression': 'PCRL'}, {'progression': 'CPRL'}, {'signed': True},
    {'plt': True}, {'no_jp2': True}, {'comment': 'seeded'})
_MODES = ('L', 'LA', 'RGB', 'RGBA', 'I;16', 'CMYK')


@pytest.mark.parametrize('case', range(24))
def test_seeded_option_sweep_as_pil(case, tmp_path):
    """Two to four of PIL's options at once, in a seeded mode, on noise
    or gradients: PIL's file decodes as PIL decodes it."""
    rng = np.random.default_rng(case)
    path = str(tmp_path / 'sweep.jp2')
    for _ in range(50):
        kw = {}
        for k in rng.choice(len(_OPTIONS), rng.integers(2, 5),
                            replace=False):
            kw.update(_OPTIONS[k])
        mode = _MODES[rng.integers(len(_MODES))]
        pixels = (NOISE, SMOOTH)[rng.integers(2)]
        try:
            _pil_image(mode, pixels).save(path, 'JPEG2000', **kw)
        except OSError:
            continue
        break
    else:
        raise AssertionError("PIL's writer refused every draw")
    assert _same_as_pil(path) is None, kw


# openjpeg's own settings a seeded case draws from
_OPJ_OPTIONS = (
    {'mode': 1}, {'mode': 2}, {'mode': 4}, {'mode': 8}, {'mode': 16},
    {'mode': 32}, {'mode': 63}, {'csty': 2}, {'csty': 4}, {'csty': 6},
    {'irreversible': 1}, {'tcp_mct': 1}, {'rates': [40, 10]},
    {'rates': [30, 15, 5]}, {'roi_compno': 1, 'roi_shift': 4},
    {'cblockw_init': 16, 'cblockh_init': 8},
    {'tp_on': 1, 'tp_flag': ord('R')},
    {'tile_size_on': 1, 'cp_tdx': 16, 'cp_tdy': 16},
    {'pocs': [(0, 0, 1, 2, 3, 0), (2, 0, 1, 5, 3, 3)]},
    {'precincts': [(8, 8), (8, 8), (4, 4), (4, 4), (4, 4)]})


@pytest.mark.parametrize('case', range(16))
def test_seeded_openjpeg_sweep_as_pil(case, tmp_path):
    """Two to four of openjpeg's own settings at once (code-block styles,
    SOP and EPH, ROI, tile parts, POC, precincts), on noise or gradients:
    the codestream decodes as PIL decodes it."""
    rng = np.random.default_rng(100 + case)
    path = str(tmp_path / 'sweep.j2k')
    for _ in range(50):
        kw = {}
        for k in rng.choice(len(_OPJ_OPTIONS), rng.integers(2, 5),
                            replace=False):
            kw.update(_OPJ_OPTIONS[k])
        pixels = (NOISE, SMOOTH)[rng.integers(2)][..., :3]
        try:
            openjpeg_write(path, pixels.astype(np.int64), **kw)
        except AssertionError:
            continue
        break
    else:
        raise AssertionError("openjpeg refused every draw")
    assert _same_as_pil(path) is None, kw


_CUT_SOURCES = ('jp2_rgb.jp2', 'jp2_rgb_irreversible.jp2',
                'jp2_layers_rates.jp2', 'jp2_tiles.jp2', 'j2k_sop_eph.j2k',
                'j2k_tile_parts.j2k')


@pytest.mark.parametrize('name', _CUT_SOURCES)
def test_cut_file_fails_as_pil(name, tmp_path):
    """Files cut short at seeded places (in the boxes, the headers, the
    packets, just before EOC) fail as PIL's decoder does (openjpeg in
    strict mode: ``OSError``)."""
    with open(os.path.join(FIXTURES, name), 'rb') as f:
        data = f.read()
    rng = np.random.default_rng(len(data))
    cuts = sorted({len(data) - 1, len(data) - 2, 30, 60,
                   *rng.integers(40, len(data), 5).tolist()})
    for cut in cuts:
        path = str(tmp_path / f'cut_{cut}')
        with open(path, 'wb') as f:
            f.write(data[:cut])
        assert _same_as_pil(path) is not None, cut


def test_missing_tile_is_zero_as_pil(tmp_path):
    """A tiled stream with one tile's part left out: PIL leaves that
    tile's samples 0, as the port does."""
    cs = bitmap_stages.j2k_segments(_pil_j2k({'tile_size': (16, 8)}))
    sot = [k for k, (m, _) in enumerate(cs) if m == 0xFF90]
    drop = sot[4]               # the fifth tile's only part: SOT, SOD, data
    parts = cs[:drop] + cs[drop + 3:]
    path = str(tmp_path / 'missing.j2k')
    with open(path, 'wb') as f:
        f.write(bitmap_stages.j2k_join(parts))
    assert _same_as_pil(path) is None
    assert (ptex.read_rgb8(path)[8:16, 16:32] == 0).all()


def _pil_j2k(kw, mode='RGB', pixels=NOISE):
    b = io.BytesIO()
    _pil_image(mode, pixels).save(b, 'JPEG2000', no_jp2=True, **kw)
    return b.getvalue()


def _edit(cs: bytes, marker: int, fn) -> bytes:
    return bitmap_stages.j2k_join([(m, fn(b) if m == marker else b)
                                   for m, b in
                                   bitmap_stages.j2k_segments(cs)])


def _insert_after_siz(cs: bytes, marker: int, body: bytes) -> bytes:
    parts = bitmap_stages.j2k_segments(cs)
    return bitmap_stages.j2k_join(parts[:2] + [(marker, body)] + parts[2:])


_REFUSED = {
    'htj2k_rsiz': lambda: _edit(_pil_j2k({}), 0xFF51,
                                lambda b: struct.pack('>H', 0x4000) + b[2:]),
    'htj2k_cap': lambda: _insert_after_siz(_pil_j2k({}), 0xFF50,
                                           struct.pack('>IH', 1 << 17, 0)),
    'htj2k_style': lambda: _edit(_pil_j2k({}), 0xFF52,
                                 lambda b: b[:8] + bytes([0x40]) + b[9:]),
    'ppm': lambda: _insert_after_siz(_pil_j2k({}), 0xFF60, bytes(5)),
    'ppt': lambda: bitmap_stages.j2k_join(
        [p for m, b in bitmap_stages.j2k_segments(_pil_j2k({}))
         for p in ([(0xFF61, bytes(5))] if m == 0xFF93 else []) + [(m, b)]]),
    'subsampled': lambda: _edit(_pil_j2k({}), 0xFF51,
                                lambda b: b[:38 + 3] + bytes([7, 2, 2])
                                + b[44:]),
    'mct_part2': lambda: _insert_after_siz(_pil_j2k({}), 0xFF74, bytes(8)),
    'syc_colour': lambda: bitmap_stages.jp2_file(_pil_j2k({}), 3, 7, W, H,
                                                 18),
    'mct_mixed_wavelets': lambda: _coc_transform(_pil_j2k({'mct': 1})),
}


def _coc_transform(cs: bytes) -> bytes:
    """The codestream with a COC giving component 1 the other wavelet."""
    parts = bitmap_stages.j2k_segments(cs)
    cod = [b for m, b in parts if m == 0xFF52][0]
    coc = bytes([1, cod[0] & 1]) + cod[5:9] + bytes([1 - cod[9]]) + cod[10:]
    k = [m for m, _ in parts].index(0xFF52)
    return bitmap_stages.j2k_join(parts[:k + 1] + [(0xFF53, coc)] +
                                  parts[k + 1:])


@pytest.mark.parametrize('what', sorted(_REFUSED))
def test_features_outside_the_port_name_their_roadmap_entry(what,
                                                            tmp_path):
    """HTJ2K (the Rsiz bit, a CAP marker, the code-block style bit),
    packed packet headers (PPM, PPT), subsampled components, Part 2's
    multiple component transform and sYCC colour raise naming ROADMAP
    12.7, as does a colour transform over components of both wavelets."""
    path = str(tmp_path / f'{what}.jp2')
    with open(path, 'wb') as f:
        f.write(_REFUSED[what]())
    assert ptex.identify(path) == 'JPEG2000'
    with pytest.raises(NotImplementedError, match=r'item 12\.7'):
        ptex.load_bitmap(path)


@pytest.mark.parametrize('enumcs,nc', [(24, 3), (17, 3), (12, 3), (16, 1),
                                       (20, 3)])
def test_colour_spaces_as_pil(enumcs, nc, tmp_path):
    """A ``colr`` box PIL's unpackers have no entry for (eYCC; grey, CMYK
    or sRGB over a count they do not take) fails as PIL does; one of an
    unknown enumeration decodes as one left unspecified."""
    mode = {1: 'L', 3: 'RGB'}[nc]
    path = str(tmp_path / 'colr.jp2')
    with open(path, 'wb') as f:
        f.write(bitmap_stages.jp2_file(_pil_j2k({}, mode), nc, 7, W, H,
                                       enumcs))
    _same_as_pil(path)


def test_mixed_wavelets_as_pil(tmp_path):
    """A COC giving one component the other wavelet (no colour
    transform): each component decodes by its own, as openjpeg does."""
    path = str(tmp_path / 'mixed.j2k')
    with open(path, 'wb') as f:
        f.write(_coc_transform(_pil_j2k({})))
    assert _same_as_pil(path) is None


@pytest.mark.parametrize('name', ['jp2_irreversible_2048.jp2',
                                  'jp2_reversible_2048.jp2'])
def test_large_pair_matches_pil_digests(name):
    """The 2,048^2 irreversible (9/7, one layer at rate 20) and reversible
    JP2 files that ``chip_smoke.py`` decodes on the card's host."""
    with open(os.path.join(LARGE, 'pil_rgb_sha256.json')) as f:
        want = json.load(f)[name]
    with bitmap_stages.forbid_plain():
        got = ptex.read_rgb8(os.path.join(LARGE, name))
    assert list(got.shape) == want['shape']
    assert hashlib.sha256(got.tobytes()).hexdigest() == want['sha256']


def test_plain_path_decodes_fixtures_as_native(monkeypatch):
    """The plain twins decode a handful of fixtures (every wavelet, the
    colour transforms, code-block styles, ROI) to the same bytes."""
    for name in ('jp2_rgb.jp2', 'jp2_mct_irreversible.jp2',
                 'j2k_style_all.j2k', 'j2k_rgn_irreversible.j2k',
                 'jp2_i16_signed.jp2'):
        path = os.path.join(FIXTURES, name)
        with bitmap_stages.plain():
            got = ptex.read_rgb8(path)
        assert got.tobytes() == WANT[name].tobytes(), name
