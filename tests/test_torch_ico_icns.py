"""The port's ICO, CUR and ICNS readers (``utils/ico.py``,
``utils/icns.py``; their PNG, DIB and JPEG 2000 icons through
``utils/io.decode_png``, ``utils/bmp.decode_dib`` and ``utils/jp2.py``)
against PIL and the reference's ``load_bitmap``.

Every committed fixture (PIL's own ICO with PNG and BMP icons; ICO and CUR
files of DIB icons at 1, 4, 8, 24 and 32 bits with AND masks; ICNS files
of JPEG 2000 icons and of the legacy RLE icons with their masks) loads
equal in bytes to the reference with gamma on and off, its mode and
samples before ``convert`` equal to PIL's. Seeded directories check which
entry PIL opens (ICO: the largest, then the shallowest; CUR: the first,
replaced by any later one larger both ways), seeded pictures each DIB
depth and mask and the ICNS run-length code, and cut or flipped files fail
as PIL does.
"""
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba_nlvrl_tpu import texture as jtex
from mitsuba_nlvrl_tpu_torch import texture as ptex
from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages

torch.set_num_threads(1)   # one intra-op thread a test worker

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
LARGE = os.path.join(HERE, 'data', 'bitmaps_large')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
NAMES = sorted(n for n in WANT.files if n.endswith(('.ico', '.cur',
                                                    '.icns')))
_rng = np.random.default_rng(1800)
NOISE = _rng.integers(0, 256, (48, 48, 4), dtype=np.uint8)


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


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, 'wb') as f:
        f.write(data)
    return path


def test_fixtures_are_listed():
    assert len(NAMES) == 22, NAMES


@pytest.mark.parametrize('name', NAMES)
def test_fixture_matches_reference(name):
    """Bytes of the reference's ``load_bitmap`` with gamma on and off;
    mode and samples of PIL's image before ``convert``."""
    path = os.path.join(FIXTURES, name)
    assert ptex.identify(path) == {'ico': 'ICO', 'cur': 'CUR',
                                   'icns': 'ICNS'}[name.split('.')[-1]]
    with bitmap_stages.forbid_plain():
        for gamma in (True, False):
            got = ptex.load_bitmap(path, gamma=gamma)
            want = jtex.load_bitmap(path, gamma=gamma)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
        mode, px, _ = ptex._decode(path)
    im = Image.open(path)
    im.load()
    assert mode == im.mode
    assert px.tobytes() == np.asarray(im).tobytes()
    assert ptex.read_rgb8(path).tobytes() == WANT[name].tobytes()


def _dib_entry(rng, w, h, bits, png=False):
    """A seeded icon: (width, height, colour count, bits, payload)."""
    pix = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    mask = rng.integers(0, 2, (h, w), dtype=np.uint8)
    if png:
        b = io.BytesIO()
        Image.fromarray(pix, 'RGBA').save(b, 'PNG')
        return (w, h, 0, 32, b.getvalue())
    if bits <= 8:
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        return (w, h, n & 255, bits, bitmap_stages.dib(
            (pix[..., 0].astype(int) % n).astype(np.uint8), bits, pal, mask))
    return (w, h, 0, bits, bitmap_stages.dib(pix[..., :bits // 8], bits,
                                             mask=mask))


@pytest.mark.parametrize('case', range(12))
def test_ico_directory_as_pil(case, tmp_path):
    """Seeded directories of two to five icons (DIB at every depth or
    PNG, sizes of which some tie in area): PIL opens the largest, of the
    equal ones the shallowest, as the port does."""
    rng = np.random.default_rng(case)
    entries = []
    for _ in range(rng.integers(2, 6)):
        w, h = (int(v) for v in rng.choice([8, 12, 16, 24, 32], 2))
        bits = int(rng.choice([1, 4, 8, 24, 32]))
        entries.append(_dib_entry(rng, w, h, bits, png=rng.random() < 0.2))
    path = _write(tmp_path, 'dir.ico', bitmap_stages.icon_file(entries))
    assert _same_as_pil(path) is None


@pytest.mark.parametrize('case', range(8))
def test_cur_choice_as_pil(case, tmp_path):
    """Seeded cursor directories: the first entry, replaced by each later
    one larger in both width and height bytes."""
    rng = np.random.default_rng(50 + case)
    entries = [_dib_entry(rng, int(w), int(h), int(rng.choice([1, 8, 24])))
               for w, h in rng.choice([8, 16, 24, 32], (rng.integers(2, 5),
                                                        2))]
    path = _write(tmp_path, 'dir.cur', bitmap_stages.icon_file(entries,
                                                               cursor=True))
    assert _same_as_pil(path) is None


@pytest.mark.parametrize('bits', [1, 4, 8, 24, 32])
@pytest.mark.parametrize('w,h', [(1, 1), (5, 3), (33, 17)])
@pytest.mark.parametrize('kind', ['ico', 'cur'])
def test_dib_depths_as_pil(bits, w, h, kind, tmp_path):
    """Every DIB depth at widths that do and do not fill a 32-bit row,
    with seeded masks (an icon's alpha: the fourth bytes at 32 bits, the
    AND mask below), and as a cursor's only icon (PIL reads a 32-bit one
    at offset 22 as RGBA)."""
    rng = np.random.default_rng(bits * 100 + w)
    entry = _dib_entry(rng, w, h, bits)
    path = _write(tmp_path, f'one.{kind}', bitmap_stages.icon_file(
        [entry], cursor=kind == 'cur'))
    assert _same_as_pil(path) is None


def _icns_icon(code, n, rng, smooth):
    if smooth:
        yy, xx = np.mgrid[0:n, 0:n]
        img = np.stack([xx // 3 * 17, yy // 5 * 23, (xx + yy) // 7 * 11],
                       -1).astype(np.uint8)
    else:
        img = rng.integers(0, 256, (n, n, 3), dtype=np.uint8)
    data = b''.join(bitmap_stages.icns_rle(img[..., c]) for c in range(3))
    return (bytes(4) if code == b'it32' else b'') + data


@pytest.mark.parametrize('code,n,mask', [
    (b'is32', 16, b's8mk'), (b'il32', 32, b'l8mk'), (b'ih32', 48, b'h8mk'),
    (b'it32', 128, b't8mk'), (b'il32', 32, None)])
@pytest.mark.parametrize('smooth', [True, False])
def test_icns_rle_icons_as_pil(code, n, mask, smooth, tmp_path):
    """The legacy icons' run-length code on noise and on runs, with and
    without their 8-bit masks."""
    rng = np.random.default_rng(n + smooth)
    entries = [(code, _icns_icon(code, n, rng, smooth))]
    if mask:
        entries.append((mask, rng.integers(0, 256, n * n,
                                           dtype=np.uint8).tobytes()))
    path = _write(tmp_path, 'rle.icns', bitmap_stages.icns_file(entries))
    assert _same_as_pil(path) is None


@pytest.mark.parametrize('what', ['png_16', 'jp2_32', 'j2k_la_32',
                                  'jp2_odd_size', 'rle_short', 'mask_only',
                                  'unknown_icon'])
def test_icns_icons_as_pil(what, tmp_path):
    """PNG and JPEG 2000 icons (converted to RGBA) and PIL's failures: an
    icon of a size its slot does not hold (ValueError), a run-length plane
    cut short (SyntaxError), a mask without its icon (KeyError), a
    payload that is neither PNG nor JPEG 2000 (ValueError)."""
    rng = np.random.default_rng(7)
    pic = Image.fromarray(NOISE[:32, :32, :3])
    b = io.BytesIO()
    if what == 'png_16':
        Image.fromarray(NOISE[:16, :16], 'RGBA').save(b, 'PNG')
        entries = [(b'icp4', b.getvalue())]
    elif what == 'jp2_32':
        pic.save(b, 'JPEG2000')
        entries = [(b'icp5', b.getvalue())]
    elif what == 'j2k_la_32':
        Image.fromarray(NOISE[:32, :32, :2], 'LA').save(b, 'JPEG2000',
                                                        no_jp2=True)
        entries = [(b'ic12', b.getvalue())]
    elif what == 'jp2_odd_size':
        Image.fromarray(NOISE[:23, :37, :3]).save(b, 'JPEG2000')
        entries = [(b'icp5', b.getvalue())]
    elif what == 'rle_short':
        entries = [(b'is32', _icns_icon(b'is32', 16, rng, False)[:300])]
    elif what == 'mask_only':
        entries = [(b's8mk', bytes(256))]
    else:
        entries = [(b'icp4', b'GIF89a' + bytes(20))]
    path = _write(tmp_path, f'{what}.icns', bitmap_stages.icns_file(entries))
    assert ptex.identify(path) == 'ICNS'
    _same_as_pil(path)


@pytest.mark.parametrize('name', ['picture64.ico', 'ico_bmp_8.ico',
                                  'ico_bmp_32.ico', 'cur_24.cur',
                                  'icns_is32.icns', 'icns_jp2.icns'])
def test_cut_and_flipped_files_as_pil(name, tmp_path):
    """Seeded cuts and byte flips of fixtures: the port fails as PIL
    does, or decodes what PIL decodes."""
    with open(os.path.join(FIXTURES, name), 'rb') as f:
        data = f.read()
    rng = np.random.default_rng(len(data))
    for k in range(8):
        bad = bytearray(data)
        if k % 2 == 0:
            bad = bad[:int(rng.integers(7, len(data)))]
        else:
            at = int(rng.integers(6, len(data)))
            bad[at] ^= int(rng.integers(1, 256))
        path = _write(tmp_path, f'{k}_{name}', bytes(bad))
        try:
            fmt = ptex.identify(path)
        except OSError:
            continue
        if fmt in ('ICO', 'CUR', 'ICNS'):
            _same_as_pil(path)


def test_pil_icns_at_1024_matches_digest():
    """PIL's own ICNS file (PNG icons up to 1,024^2) that
    ``chip_smoke.py`` decodes on the card's host."""
    name = 'icns_pil_1024.icns'
    with open(os.path.join(LARGE, 'pil_rgb_sha256.json')) as f:
        want = json.load(f)[name]
    with bitmap_stages.forbid_plain():
        got = ptex.read_rgb8(os.path.join(LARGE, name))
    assert list(got.shape) == want['shape']
    assert hashlib.sha256(got.tobytes()).hexdigest() == want['sha256']


def test_cur_with_png_fails_as_pil(tmp_path):
    """PIL reads a cursor's icon as a DIB only: a PNG one fails."""
    b = io.BytesIO()
    Image.fromarray(NOISE[:16, :16], 'RGBA').save(b, 'PNG')
    path = _write(tmp_path, 'png.cur', bitmap_stages.icon_file(
        [(16, 16, 0, 32, b.getvalue())], cursor=True))
    assert _same_as_pil(path) is not None
    assert struct.unpack_from('<H', open(path, 'rb').read(), 2)[0] == 2
