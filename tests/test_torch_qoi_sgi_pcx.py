"""The port's QOI, SGI and PCX readers (``utils/qoi.py``, ``sgi.py``,
``pcx.py``; their loops in ``native/bitmap_raster.cpp``) against PIL's
plugins.

The committed fixtures equal PIL's stored bytes. PIL writes QOI (RGB,
RGBA), verbatim SGI (1, 3 and 4 channels, 8 and 16 bits) and PCX (1-bit,
8-bit grey and palette, 24-bit); the rest is written here: SGI in RLE
(each op of PIL's ``sgi_rle`` decoder, its quirks included: a short row
keeps the row before, a nonzero op at a row's last count ends the image),
PCX in 2 and 4 bit planes, with and without stride padding, and RLE runs
across a row's end, which PIL refuses. Each native loop equals its plain
twin on seeded images and on seeded cuts and flips of its data.
"""
import io
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba_nlvrl_tpu_torch import texture as ptex
from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages
from mitsuba_nlvrl_tpu_torch.utils import pcx, qoi, sgi

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), 'scripts'))
from port_make_bitmaps import _pcx, _sgi_rle  # noqa: E402

torch.set_num_threads(1)   # one intra-op thread a test worker

FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
NAMES = [n for n in WANT.files if n.endswith(('.qoi', '.sgi', '.pcx'))]
H, W = 23, 37
_rng = np.random.default_rng(23)
RGBA = _rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
# a picture with runs and repeats, so that every QOI op and RLE run shows
SMOOTH = (np.mgrid[0:H, 0:W, 0:4].sum(0) // 5 * 9 % 256).astype(np.uint8)


def _same_as_pil(path):
    """The port's bytes equal PIL's, or both raise one exception type
    (PIL's OSErrors as OSError)."""
    try:
        want = np.asarray(Image.open(path).convert('RGB'))
    except Exception as e:          # noqa: BLE001 - the type is compared
        exc = OSError if isinstance(e, OSError) else type(e)
        with pytest.raises(exc):
            ptex.read_rgb8(path)
        return type(e)
    got = ptex.read_rgb8(path)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    return None


def test_fixtures_are_listed():
    assert len(NAMES) == 20, NAMES


@pytest.mark.parametrize('name', NAMES)
def test_fixture_decodes_to_pils_stored_bytes(name):
    path = os.path.join(FIXTURES, name)
    assert ptex.identify(path) == {'qoi': 'QOI', 'sgi': 'SGI',
                                   'pcx': 'PCX'}[name[-3:]]
    with bitmap_stages.forbid_plain():
        got = ptex.read_rgb8(path)
    assert got.tobytes() == WANT[name].tobytes()
    assert np.asarray(Image.open(path).convert('RGB')).tobytes() == \
        WANT[name].tobytes()


# --- QOI --------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['RGB', 'RGBA'])
@pytest.mark.parametrize('picture', ['noise', 'smooth', 'flat'])
@pytest.mark.parametrize('size', [(1, 1), (37, 23), (130, 3)])
def test_qoi_as_pil(tmp_path, mode, picture, size):
    w, h = size
    img = {'noise': _rng.integers(0, 256, (h, w, 4), dtype=np.uint8),
           'smooth': np.resize(SMOOTH, (h, w, 4)),
           'flat': np.full((h, w, 4), 77, np.uint8)}[picture]
    if picture == 'smooth':
        img[..., 3] = 255 - (np.arange(w) // 9 * 60 % 256)
    path = str(tmp_path / 'q.qoi')
    Image.fromarray(img[..., :len(mode)], mode).save(path, 'QOI')
    assert _same_as_pil(path) is None


def _qoi_file(ops: bytes, w: int, h: int, channels: int = 4) -> bytes:
    return b'qoif' + struct.pack('>IIBB', w, h, channels, 0) + ops + \
        bytes(7) + b'\x01'


def test_qoi_index_of_a_run_and_an_unwritten_entry_as_pil(tmp_path):
    """PIL's decoder leaves runs out of the index (the format's reference
    writes every pixel there) and reads an entry never written as
    transparent black."""
    ops = bytes([0xC0 | 2,                  # run of 3 of the start pixel
                 53,                        # its hash: never written here
                 0xFE, 10, 20, 30,          # RGB
                 0x40 | 0b111111,           # DIFF +1 +1 +1
                 0x80 | 40, 0x5A,           # LUMA
                 0xFF, 1, 2, 3, 4,          # RGBA
                 (10 * 3 + 20 * 5 + 30 * 7 + 255 * 11) % 64,  # INDEX
                 7])                        # INDEX of an unwritten entry
    path = str(tmp_path / 'ops.qoi')
    for channels in (3, 4):
        with open(path, 'wb') as f:
            f.write(_qoi_file(ops, 9, 1, channels))
        assert _same_as_pil(path) is None


@pytest.mark.parametrize('cut', [3, 10, 13])
def test_qoi_cut_short_raises_as_pil(tmp_path, cut):
    """A stream that ends inside an RGB or RGBA op (PIL: ValueError) or
    before an op (PIL: IndexError)."""
    ops = bytes([0xFE, 10, 20, 30, 0xFF, 1, 2, 3, 4, 0x80 | 40, 0x5A, 1, 2])
    path = str(tmp_path / 'cut.qoi')
    with open(path, 'wb') as f:
        f.write(b'qoif' + struct.pack('>IIBB', 8, 2, 4, 0) + ops[:cut])
    assert _same_as_pil(path) in (ValueError, IndexError)


# --- SGI --------------------------------------------------------------------

@pytest.mark.parametrize('z', [1, 3, 4])
@pytest.mark.parametrize('bpc', [1, 2])
@pytest.mark.parametrize('picture', ['noise', 'smooth'])
def test_sgi_rle_as_pil(tmp_path, z, bpc, picture):
    img = (RGBA if picture == 'noise' else SMOOTH)[..., :z]
    path = str(tmp_path / 'r.sgi')
    with open(path, 'wb') as f:
        f.write(_sgi_rle(img, bpc))
    assert _same_as_pil(path) is None


@pytest.mark.parametrize('z,bpc', [(1, 1), (3, 1), (4, 1), (1, 2), (3, 2),
                                   (4, 2)])
def test_sgi_verbatim_as_pil(tmp_path, z, bpc):
    mode = {1: 'L', 3: 'RGB', 4: 'RGBA'}[z]
    path = str(tmp_path / 'v.sgi')
    Image.fromarray(RGBA[..., :z].squeeze(), mode).save(path, 'SGI',
                                                        bpc=bpc)
    assert _same_as_pil(path) is None


def _sgi_patch(data: bytes, row_index: int, new_row: bytes) -> bytes:
    """An RLE SGI file with one row's data replaced (appended at the end,
    its offset and length tables entries pointing there)."""
    head, body = bytearray(data[:512]), bytearray(data[512:])
    n = struct.unpack_from('>H', head, 8)[0] * struct.unpack_from(
        '>H', head, 10)[0]
    struct.pack_into('>I', body, 4 * row_index, len(data))
    struct.pack_into('>I', body, 4 * (n + row_index), len(new_row))
    return bytes(head + body) + new_row


@pytest.mark.parametrize('case', ['short_row_keeps_the_row_before',
                                  'nonzero_last_op_ends_the_image',
                                  'run_past_the_row', 'offset_past_the_data',
                                  'copy_to_the_last_byte',
                                  'tables_cut_short', 'two_channels',
                                  'unknown_compression'])
def test_sgi_rle_quirks_as_pil(tmp_path, case):
    img = SMOOTH[..., :3]
    data = _sgi_rle(img, 1)
    if case == 'short_row_keeps_the_row_before':
        data = _sgi_patch(data, 5, bytes([3, 200, 0]))     # 3 pixels
    elif case == 'nonzero_last_op_ends_the_image':
        data = _sgi_patch(data, 7, bytes([2, 9, 0x81, 5]))[:]
        data = data[:-4] + bytes([2, 9, 0x81, 5])
        head = bytearray(data[:512 + 8 * 69])
        struct.pack_into('>I', head, 512 + 4 * (69 + 7), 2)   # 2 ops
        data = bytes(head) + data[512 + 8 * 69:]
    elif case == 'run_past_the_row':
        data = _sgi_patch(data, 2, bytes([60, 1, 0]))
    elif case == 'offset_past_the_data':
        body = bytearray(data)
        struct.pack_into('>I', body, 512 + 4 * 3, len(data) + 100)
        data = bytes(body)
    elif case == 'copy_to_the_last_byte':
        data = _sgi_patch(data, 22, bytes([0x82, 1]))[:-0] + bytes([2])
    elif case == 'tables_cut_short':
        data = data[:512 + 100]
    elif case == 'two_channels':
        data = bytearray(data)
        struct.pack_into('>H', data, 10, 2)
        data = bytes(data)
    else:
        data = bytearray(data)
        data[2] = 2
        data = bytes(data)
    path = str(tmp_path / f'{case}.sgi')
    with open(path, 'wb') as f:
        f.write(data)
    _same_as_pil(path)


# --- PCX --------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['rgb', 'l', 'p', '1'])
@pytest.mark.parametrize('w', [1, 8, 37, 64])
def test_pcx_pil_written_as_pil(tmp_path, kind, w):
    img = Image.fromarray(np.resize(RGBA, (H, w, 4))[..., :3])
    img = {'rgb': img, 'l': img.convert('L'), 'p': img.quantize(100),
           '1': img.convert('1')}[kind]
    path = str(tmp_path / 'p.pcx')
    img.save(path, 'PCX')
    # PIL cannot read back its own 1-pixel-wide RGB file: both raise
    assert _same_as_pil(path) is (OSError if (kind, w) == ('rgb', 1)
                                  else None)


@pytest.mark.parametrize('planes,bits', [(4, 1), (2, 1), (3, 8), (1, 8),
                                         (1, 1)])
@pytest.mark.parametrize('w,pad', [(37, 0), (37, 1), (16, 2), (3, 1)])
def test_pcx_planes_and_padding_as_pil(tmp_path, planes, bits, w, pad):
    """Bit planes and byte planes, each row's planes ``pad`` bytes past
    their width: PIL works out the stride itself (made even where the
    header's differs), so an odd padding is a file PIL misreads or
    refuses."""
    idx = _rng.integers(0, 1 << planes if bits == 1 else 256,
                        (H, w, planes if bits == 8 else 1), dtype=np.uint8)
    stride = (w * bits + 7) // 8 + pad
    data = _pcx(idx if bits == 8 else idx[..., 0], planes, bits, stride,
                _rng.integers(0, 256, (16, 3)))
    path = str(tmp_path / 'pl.pcx')
    with open(path, 'wb') as f:
        f.write(data)
    _same_as_pil(path)


@pytest.mark.parametrize('case', ['run_across_the_row_end', 'cut_short',
                                  'two_bit_one_plane', 'version_2_eight_bit',
                                  'empty_box'])
def test_pcx_refusals_as_pil(tmp_path, case):
    data = bytearray(_pcx(RGBA[..., 0], 1, 8, W + 1))
    if case == 'run_across_the_row_end':
        data = data[:128] + bytes([0xC0 | 60, 7] * (H * 38 // 60 + 2))
    elif case == 'cut_short':
        data = data[:300]
    elif case == 'two_bit_one_plane':
        data[3] = 2
    elif case == 'version_2_eight_bit':
        data[1] = 2
    else:
        struct.pack_into('<H', data, 8, 0)
    path = str(tmp_path / f'{case}.pcx')
    with open(path, 'wb') as f:
        f.write(bytes(data))
    assert _same_as_pil(path) is not None


# --- native loops against their plain twins ----------------------------------

def _cuts_and_flips(data: bytes, seed: int, n: int = 20):
    rng = np.random.default_rng(seed)
    for k in range(n):
        b = bytearray(data)
        if k % 2 == 0:
            yield bytes(b[:int(rng.integers(0, len(b)))])
        else:
            for _ in range(int(rng.integers(1, 4))):
                b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
            yield bytes(b)


def _outcome(fn, *args):
    try:
        return fn(*args).tobytes()
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e).__name__


@pytest.mark.parametrize('channels', [3, 4])
def test_qoi_native_equals_plain(channels):
    buf = io.BytesIO()
    Image.fromarray(SMOOTH[..., :channels]).save(buf, 'QOI')
    ops = buf.getvalue()[14:]
    n = H * W
    assert qoi._qoi(ops, n, channels).tobytes() == \
        qoi._qoi_plain(ops, n, channels).tobytes()
    for bad in _cuts_and_flips(ops, channels):
        assert _outcome(qoi._qoi, bad, n, channels) == \
            _outcome(qoi._qoi_plain, bad, n, channels)


@pytest.mark.parametrize('z,bpc', [(1, 1), (3, 1), (4, 2)])
def test_sgi_rle_native_equals_plain(z, bpc):
    body = _sgi_rle(SMOOTH[..., :z], bpc)[512:]
    assert sgi._sgi_rle(body, W, H, z, bpc).tobytes() == \
        sgi._sgi_rle_plain(body, W, H, z, bpc).tobytes()
    for bad in _cuts_and_flips(body, z * 10 + bpc):
        assert _outcome(sgi._sgi_rle, bad, W, H, z, bpc) == \
            _outcome(sgi._sgi_rle_plain, bad, W, H, z, bpc)


@pytest.mark.parametrize('planes,bits', [(3, 8), (4, 1)])
def test_pcx_rle_native_equals_plain(planes, bits):
    idx = SMOOTH[..., :planes] if bits == 8 else SMOOTH[..., 0] % 16
    stride = (W * bits + 7) // 8 + 1
    rle = _pcx(idx, planes, bits, stride, np.zeros((16, 3)))[128:]
    n = planes * stride
    assert pcx._pcx_rle(rle, n, H).tobytes() == \
        pcx._pcx_rle_plain(rle, n, H).tobytes()
    for bad in _cuts_and_flips(rle, planes):
        assert _outcome(pcx._pcx_rle, bad, n, H) == \
            _outcome(pcx._pcx_rle_plain, bad, n, H)
