"""The port's DDS reader (``utils/dds.py``, its BCn blocks in
``native/bitmap_bcn.cpp``) against PIL's ``DdsImagePlugin``.

The committed fixtures (PIL's writer: DXT1, DXT3, DXT5, BC5, uncompressed
RGB, RGBA, L, LA; by hand: palette, 16-bit masks, R8G8B8A8, FourCC BC4
and BC5 and DX10 BC1-BC7 of seeded random blocks, mipmaps) equal PIL's
stored bytes. Every bit pattern is a block PIL decodes, so each BCn
format is held to PIL on 4,096 seeded random blocks (enough for each of
BC7's modes to show its 64 partitions), through the native stage and its
plain twin, and BC6H's half-float endpoints near their edges (the stage
against its twin at other sizes and on corrupt blocks:
``test_torch_bitmap_native.py``). The layouts PIL leaves raise the
exception type PIL raises.
"""
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba_nlvrl_tpu_torch import texture as ptex
from mitsuba_nlvrl_tpu_torch.testing import bitmap_stages
from mitsuba_nlvrl_tpu_torch.utils import dds

torch.set_num_threads(1)   # one intra-op thread a test worker

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
DDS_FIXTURES = [n for n in WANT.files if n.endswith('.dds')]


def _pil(data: bytes, mode=None):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im.convert(mode) if mode else im)


def test_dds_fixtures_are_listed():
    assert len(DDS_FIXTURES) == 27, DDS_FIXTURES


@pytest.mark.parametrize('name', DDS_FIXTURES)
def test_fixture_decodes_to_pils_stored_bytes(name):
    path = os.path.join(FIXTURES, name)
    assert ptex.identify(path) == 'DDS'
    with bitmap_stages.forbid_plain():
        got = ptex.read_rgb8(path)
    assert got.tobytes() == WANT[name].tobytes()
    assert np.asarray(Image.open(path).convert('RGB')).tobytes() == \
        WANT[name].tobytes()


# DXGI format -> PIL's mode
FORMATS = {71: 'RGBA', 74: 'RGBA', 77: 'RGBA', 80: 'L', 83: 'RGB',
           84: 'RGB', 95: 'RGB', 96: 'RGB', 98: 'RGBA'}


@pytest.mark.parametrize('dxgi', list(FORMATS))
def test_random_blocks_decode_as_pil(tmp_path, dxgi):
    """4,096 seeded random blocks (256 x 256 pixels) in PIL's own mode,
    alpha included: the native stage, then its plain twin."""
    data = bitmap_stages.bcn_random_dds(256, 256, dxgi, dxgi)
    path = str(tmp_path / 'r.dds')
    with open(path, 'wb') as f:
        f.write(data)
    want = _pil(data)
    mode, px, _ = dds.read_dds(path)
    assert mode == FORMATS[dxgi] and px.tobytes() == want.tobytes()
    with bitmap_stages.plain():
        _, px_plain, _ = dds.read_dds(path)
    assert px_plain.tobytes() == want.tobytes()


def _bc6h_mode11(e0, e1, index15: int) -> bytes:
    """A BC6H block of mode 11 (one subset, 10-bit endpoints as they
    are): every pixel at index 0 but the last, at ``index15``."""
    v, pos = 0, 0
    for val, nbits in [(0b00011, 5), *((c, 10) for c in (*e0, *e1)),
                       *([(0, 3)] + [(0, 4)] * 14 + [(index15, 4)])]:
        v |= (int(val) & ((1 << nbits) - 1)) << pos
        pos += nbits
    return v.to_bytes(16, 'little')


@pytest.mark.parametrize('signed', [False, True])
def test_bc6h_half_float_edges_as_pil(signed):
    """Endpoints across the 10-bit range (signed: both signs), at index 0
    and at each of the 16 interpolation weights: PIL clamps the half float
    to [0, 1] and truncates it times 255."""
    rng = np.random.default_rng(6)
    blocks = []
    for k in range(256):
        e0 = rng.integers(0, 1024, 3) if k % 4 else np.full(3, k * 4)
        e1 = rng.integers(0, 1024, 3)
        blocks.append(_bc6h_mode11(e0, e1, k % 16))
    data = bitmap_stages.dds_file(64, 64, b''.join(blocks),
                                  dxgi=96 if signed else 95)
    want = _pil(data)
    got = dds._bcn(data[148:], 64, 64, 6, signed)[..., :3]
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('fourcc,exc', [(b'DXT2', NotImplementedError),
                                        (b'BC4S', NotImplementedError),
                                        (b'RGBG', NotImplementedError)])
def test_unimplemented_fourcc_raises_as_pil(tmp_path, fourcc, exc):
    data = bitmap_stages.dds_file(8, 8, bytes(64), fourcc=fourcc)
    with pytest.raises(exc):
        _pil(data)
    path = str(tmp_path / 'x.dds')
    with open(path, 'wb') as f:
        f.write(data)
    with pytest.raises(exc):
        ptex.read_rgb8(path)


@pytest.mark.parametrize('case', ['dxgi_bc6h_typeless', 'dxgi_r10g10b10a2',
                                  'header_size', 'short_blocks',
                                  'short_luminance', 'luminance_4bit'])
def test_refusals_raise_as_pil(tmp_path, case):
    if case == 'dxgi_bc6h_typeless':
        data = bitmap_stages.dds_file(8, 8, bytes(64), dxgi=94)
    elif case == 'dxgi_r10g10b10a2':
        data = bitmap_stages.dds_file(8, 8, bytes(256), dxgi=24)
    elif case == 'header_size':
        data = bytearray(bitmap_stages.dds_file(8, 8, bytes(32),
                                                fourcc=b'DXT1'))
        data[4] = 100
        data = bytes(data)
    elif case == 'short_blocks':
        data = bitmap_stages.dds_file(64, 64, bytes(100), fourcc=b'DXT5')
    elif case == 'short_luminance':
        data = bitmap_stages.dds_file(8, 8, bytes(50), pfflags=0x20000,
                                      bitcount=8)
    else:
        data = bitmap_stages.dds_file(8, 8, bytes(64), pfflags=0x20000,
                                      bitcount=4)
    try:
        _pil(data, 'RGB')
        want = None
    except Exception as e:          # noqa: BLE001 - the type is compared
        want = type(e)
    assert want is not None
    path = str(tmp_path / 'x.dds')
    with open(path, 'wb') as f:
        f.write(data)
    with pytest.raises(OSError if issubclass(want, OSError) else want):
        ptex.read_rgb8(path)


@pytest.mark.parametrize('masks,bitcount', [
    ((0xF800, 0x07E0, 0x001F), 16), ((0x7C00, 0x03E0, 0x001F, 0x8000), 16),
    ((0xFF0000, 0xFF00, 0xFF), 24), ((0x3FF, 0xFFC00, 0x3FF00000,
                                      0xC0000000), 32),
    ((0xE0, 0x1C, 0x03), 8)])
def test_bit_masks_as_pil(tmp_path, masks, bitcount):
    """PIL's ``DdsRgbDecoder``: each field shifted down and scaled to 8
    bits through a float division."""
    rng = np.random.default_rng(bitcount + len(masks))
    raw = rng.integers(0, 256, 37 * 23 * bitcount // 8, dtype=np.uint8)
    data = bitmap_stages.dds_file(37, 23, raw.tobytes(),
                                  pfflags=0x40 | (len(masks) == 4),
                                  bitcount=bitcount, masks=masks)
    path = str(tmp_path / 'm.dds')
    with open(path, 'wb') as f:
        f.write(data)
    assert ptex.read_rgb8(path).tobytes() == _pil(data, 'RGB').tobytes()


def test_masked_data_cut_short_reads_zeros_as_pil(tmp_path):
    """PIL's masked decoder reads past the data's end as zero words."""
    data = bitmap_stages.dds_file(8, 8, bytes(range(101)), pfflags=0x41,
                                  bitcount=32, masks=(0xFF, 0xFF00, 0xFF0000,
                                                      0xFF000000))
    path = str(tmp_path / 'short.dds')
    with open(path, 'wb') as f:
        f.write(data)
    assert ptex.read_rgb8(path).tobytes() == _pil(data, 'RGB').tobytes()
