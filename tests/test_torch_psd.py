"""PSD (``utils/psd.py``) against PIL: the composite image of every mode
of PIL's ``PsdImagePlugin.MODES`` (1-bit bitmap; grey, multichannel and
duotone as ``L``; indexed with its planar palette; RGB and RGBA; CMYK;
Lab), raw and RLE, with and without resources and a layer section, and
what PIL refuses (16 and 32 bits, PSB, too few channels, another
compression, short files) raising PIL's exception class. The committed
fixtures (``scripts/port_make_bitmaps.py``) and files written here by
``testing/bitmap_stages.psd_file`` (PIL has no PSD writer); the load
path held to the reference's, which opens PSD through PIL.
"""
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
from mitsuba_nlvrl_tpu_torch.utils import psd

torch.set_num_threads(1)   # one intra-op thread a test worker

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, 'data', 'bitmaps')
REFUSED = os.path.join(HERE, 'data', 'bitmaps_refused')
WANT = np.load(os.path.join(FIXTURES, 'pil_rgb.npz'))
with open(os.path.join(REFUSED, 'pil_errors.json')) as _f:
    ERRORS = json.load(_f)
NAMES = sorted(n for n in WANT.files if n.endswith('.psd'))
REFUSED_PSD = sorted(n for n in ERRORS if n.endswith('.psd'))
H, W = 23, 37
_rng = np.random.default_rng(29)
CH = _rng.integers(0, 256, (5, H, W), dtype=np.uint8)
CH[:, 4:9] = CH[:, 4:5, :1]                     # flat rows: RLE runs
COLOUR = _rng.integers(0, 256, 768, dtype=np.uint8).tobytes()


def _pil_or_error(path):
    try:
        return np.asarray(Image.open(path).convert('RGB'))
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e)


def _same_as_pil(path):
    want = _pil_or_error(path)
    if isinstance(want, type):
        with pytest.raises(OSError if issubclass(want, OSError) else want):
            ptex.read_rgb8(path)
        return want
    got = ptex.read_rgb8(path)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    return None


def test_fixtures_are_listed():
    assert len(NAMES) == 21, NAMES
    assert len(REFUSED_PSD) == 9, REFUSED_PSD
    assert sorted(psd.MODES) == sorted(
        __import__('PIL.PsdImagePlugin', fromlist=['MODES']).MODES)


@pytest.mark.parametrize('name', NAMES)
def test_fixture_decodes_to_pils_stored_bytes(name):
    path = os.path.join(FIXTURES, name)
    assert ptex.identify(path) == 'PSD'
    got = ptex.read_rgb8(path)
    assert got.tobytes() == WANT[name].tobytes()
    assert np.asarray(Image.open(path).convert('RGB')).tobytes() == \
        WANT[name].tobytes()


@pytest.mark.parametrize('name', REFUSED_PSD)
def test_refused_psd_raises_pils_class(name):
    path = os.path.join(REFUSED, name)
    want = _same_as_pil(path)
    assert want is not None and want.__name__ == ERRORS[name]['error']


@pytest.mark.parametrize('name', NAMES)
def test_decoder_mode_is_pils(name):
    """The mode PIL opens each file in (``1``, ``L``, ``P``, ``RGB``,
    ``RGBA``, ``CMYK``, ``LAB``) and the samples it holds."""
    path = os.path.join(FIXTURES, name)
    mode, px, _ = ptex._decode(path)
    im = Image.open(path)
    assert mode == im.mode
    want = np.asarray(im)
    if mode == '1':
        want = want.astype(np.uint8) * 255
    if mode == 'LAB':                   # PIL packs a* and b* signed
        want = want ^ np.uint8([0, 128, 128])
    assert px.tobytes() == want.tobytes()


# (channels of CH, Photoshop mode, psd_file arguments)
LAYOUTS = {
    'bitmap_odd_width': (lambda: CH[:1, :, :29] & 1, 0, {'bits': 1}),
    'bitmap_rle_width_8': (lambda: CH[:1, :, :8] >> 7, 0, {
        'bits': 1, 'compression': 1}),
    'grey_one_pixel': (lambda: CH[:1, :1, :1], 1, {}),
    'grey_rle_one_column': (lambda: CH[:1, :, :1], 1, {'compression': 1}),
    'grey_three_channels_rle': (lambda: CH[:3], 1, {'compression': 1}),
    'multichannel_rle': (lambda: CH[:4], 7, {'compression': 1}),
    'duotone_rle': (lambda: CH[:1], 8, {'compression': 1,
                                        'colour': bytes(range(100))}),
    'palette_short_colour': (lambda: CH[:1], 2, {'colour': COLOUR[:600]}),
    'palette_two_channels_rle': (lambda: CH[:2], 2, {
        'colour': COLOUR, 'compression': 1}),
    'rgb_wide_rle': (lambda: np.tile(CH[:3], (1, 1, 9)), 3, {
        'compression': 1}),
    'rgba_raw': (lambda: CH[:4], 3, {}),
    'rgb_five_channels_raw': (lambda: CH, 3, {}),
    'cmyk_five_channels_raw': (lambda: CH, 4, {}),
    'lab_alpha_rle': (lambda: CH[:4], 9, {'compression': 1}),
    'resources_odd_and_even': (lambda: CH[:3], 3, {
        'compression': 1, 'resources': ((1005, b'a'), (1006, b'bc'),
                                        (1039, bytes(7)))}),
    'layer_section': (lambda: CH[:3], 3, {'layers': bytes(range(200))}),
    'rgb16': (lambda: CH[:3], 3, {'bits': 16}),
    'bitmap16': (lambda: CH[:1], 0, {'bits': 16}),
    'rgb_two_channels': (lambda: CH[:2], 3, {}),
    'lab_two_channels': (lambda: CH[:2], 9, {}),
    'rle3': (lambda: CH[:3], 3, {'compression': 3}),
    'psb': (lambda: CH[:3], 3, {'version': 2}),
    'mode6': (lambda: CH[:3], 6, {}),
}
REFUSE = {'rgb16', 'bitmap16', 'rgb_two_channels', 'lab_two_channels',
          'rle3', 'psb', 'mode6'}


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_layouts_as_pil(tmp_path, layout):
    planes, mode, kw = LAYOUTS[layout]
    path = str(tmp_path / 'f.psd')
    with open(path, 'wb') as f:
        f.write(bitmap_stages.psd_file(planes(), mode, **kw))
    want = _same_as_pil(path)
    assert (want is not None) == (layout in REFUSE)


def _rle_psd(rows_of_channel, byte_counts=None) -> bytes:
    """An RGB RLE PSD of hand-coded PackBits rows (``rows_of_channel``: a
    list of H rows of bytes for each of 3 channels)."""
    head = bitmap_stages.psd_file(CH[:3], 3)
    pos = 26 + 12 + 2                   # header, three empty sections
    out = bytearray(head[:pos])
    out[-2:] = struct.pack('>H', 1)
    counts = byte_counts or [len(r) for ch in rows_of_channel for r in ch]
    out += b''.join(struct.pack('>H', c) for c in counts)
    out += b''.join(r for ch in rows_of_channel for r in ch)
    return bytes(out)


@pytest.mark.parametrize('case', ['run_past_row', 'literal_past_row',
                                  'noop_codes', 'rows_across_counts',
                                  'counts_wrong', 'ends_in_literal'])
def test_packbits_rows_as_pil(tmp_path, case):
    """PIL decodes a channel's rows one after another from the offset its
    byte counts give, cutting a run or literal at its row's end and
    skipping 128; the counts inside a channel do not matter."""
    rows = [[bitmap_stages.packbits(CH[c, y].tobytes()) for y in range(H)]
            for c in range(3)]
    counts = None
    if case == 'run_past_row':
        rows[0][3] = bytes([257 - W - 20, 9])
    elif case == 'literal_past_row':
        rows[1][5] = bytes([W + 9]) + bytes(range(W + 10))
    elif case == 'noop_codes':
        rows[2] = [b'\x80' + r + b'\x80' for r in rows[2]]
    elif case == 'rows_across_counts':
        flat = b''.join(rows[0])
        rows[0] = [flat[:len(flat) // 2], flat[len(flat) // 2:]] + \
            [b''] * (H - 2)
    elif case == 'counts_wrong':
        counts = [len(r) + (1 if k % 7 == 0 else 0) for k, r in
                  enumerate(r for ch in rows for r in ch)]
    else:
        rows[2][-1] = bytes([W - 1]) + CH[2, -1].tobytes()[:5]
    path = str(tmp_path / 'p.psd')
    with open(path, 'wb') as f:
        f.write(_rle_psd(rows, counts))
    _same_as_pil(path)


def test_load_bitmap_matches_reference(tmp_path):
    """``texture.load_bitmap`` (gamma on and off) of an RGB RLE PSD, an
    indexed PSD and a CMYK PSD equals the reference's, which opens them
    through PIL, to the byte."""
    paths = []
    for k, (planes, mode, kw) in enumerate((
            (CH[:3], 3, {'compression': 1}),
            (CH[:1], 2, {'colour': COLOUR}),
            (CH[:4], 4, {'compression': 1}))):
        paths.append(str(tmp_path / f'{k}.psd'))
        with open(paths[-1], 'wb') as f:
            f.write(bitmap_stages.psd_file(planes, mode, **kw))
    for path in paths:
        for gamma in (True, False):
            want = jtex.load_bitmap(path, gamma=gamma)
            got = ptex.load_bitmap(path, gamma=gamma)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
