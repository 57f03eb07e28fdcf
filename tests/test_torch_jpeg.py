"""The port's JPEG decoder (``utils/io.read_jpeg``) against PIL, the
reference's decoder, and ``texture.load_bitmap`` against the reference's
on JPEG files.

PIL writes each file: 4:4:4, 4:2:2 and 4:2:0 colour and grey, at
qualities 50 and 95, with and without restart markers, sequential and
progressive (PIL's scans use successive approximation: DC and AC first
and refinement scans), and Adobe CMYK, at 37 x 23 so that the last MCU
column and row are cut. A YCCK file is a CMYK one with its Adobe
transform set to 2; lossless (SOF3) files are encoded here. The decoder
runs libjpeg's default path (islow IDCT, fancy upsampling, its integer
colour tables), so the samples equal PIL's ``convert('RGB')`` byte for
byte. Kinds PIL refuses (12-bit, hierarchical) raise ``OSError`` in both;
arithmetic coding and a progressive file whose output libjpeg would
block-smooth raise, naming ROADMAP 12.6."""
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba_nlvrl_tpu import texture as jtex
from mitsuba_nlvrl_tpu_torch import texture as ptex
from mitsuba_nlvrl_tpu_torch.utils.io import read_jpeg

torch.set_num_threads(1)   # one intra-op thread a test worker

H, W = 23, 37
# (PIL mode, PIL subsampling): 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0
LAYOUTS = {'444': ('RGB', 0), '422': ('RGB', 1), '420': ('RGB', 2),
           'grey': ('L', 0)}


def _picture(seed=0):
    """Gradients with a third of the pixels noise: smooth areas and
    every AC coefficient busy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([(xx * 7) % 256, (yy * 11) % 256,
                     ((xx + yy) * 5) % 256], -1)
    noise = rng.integers(0, 256, (H, W, 3))
    return np.where(rng.uniform(size=(H, W, 1)) < 0.3, noise,
                    base).astype(np.uint8)


def _write(tmp_path, layout, quality, restart, **kw):
    mode, sub = LAYOUTS[layout]
    img = _picture()
    im = Image.fromarray(img if mode == 'RGB' else img[..., 0], mode)
    path = str(tmp_path / f'{layout}_{quality}_{restart}.jpg')
    extra = {'restart_marker_blocks': restart} if restart else {}
    im.save(path, quality=quality, subsampling=sub, **extra, **kw)
    return path


@pytest.mark.parametrize('progressive', [False, True])
@pytest.mark.parametrize('restart', [0, 2])
@pytest.mark.parametrize('quality', [50, 95])
@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_read_jpeg_equals_pil(tmp_path, layout, quality, restart,
                              progressive):
    path = _write(tmp_path, layout, quality, restart,
                  **({'progressive': True} if progressive else {}))
    with open(path, 'rb') as f:
        data = f.read()
    assert (b'\xff\xdd' in data) == bool(restart)     # a DRI segment
    ref = np.asarray(Image.open(path).convert('RGB'))
    got = read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_load_bitmap_jpeg_matches_reference(tmp_path, layout):
    path = _write(tmp_path, layout, 90, 4)
    for gamma in (True, False):
        got = ptex.load_bitmap(path, gamma=gamma)
        assert got.tobytes() == jtex.load_bitmap(path, gamma=gamma).tobytes()


def _scans(data):
    """Positions of the SOS markers of a JPEG."""
    out, i = [], data.find(b'\xff\xda')
    while i >= 0:
        out.append(i)
        i = data.find(b'\xff\xda', i + 2)
    return out


def test_progressive_jpeg_raises_naming_its_roadmap_entry(tmp_path):
    """A progressive file decodes as PIL decodes it (successive
    approximation: PIL's ten scans refine DC and AC bits). Cut after its
    first scans, it leaves low AC coefficients incomplete, where libjpeg
    would block-smooth the output: that file raises, naming 12.6, and the
    reference decodes it (the gap, stated)."""
    path = _write(tmp_path, '420', 80, 0, progressive=True)
    with open(path, 'rb') as f:
        data = f.read()
    sos = _scans(data)
    assert len(sos) >= 6                      # first and refinement scans
    ahal = [data[i + 4 + 2 * data[i + 4] + 3] for i in sos]
    assert any(a >> 4 for a in ahal)          # some scan refines (Ah > 0)
    ref = np.asarray(Image.open(path).convert('RGB'))
    assert read_jpeg(path).tobytes() == ref.tobytes()
    cut = tmp_path / 'cut.jpg'
    cut.write_bytes(data[:sos[3]] + b'\xff\xd9')
    assert np.asarray(Image.open(str(cut)).convert('RGB')).shape == (H, W, 3)
    with pytest.raises(NotImplementedError,
                       match=r'block smoothing.*item 12\.6'):
        read_jpeg(str(cut))


@pytest.mark.parametrize('progressive', [False, True])
@pytest.mark.parametrize('transform', [0, 2, None])
def test_cmyk_and_ycck_jpeg_equal_pil(tmp_path, transform, progressive):
    """Adobe CMYK (transform 0), YCCK (2: the same file relabelled) and
    four components with no Adobe marker, through PIL's CMYK -> RGB."""
    cmyk = np.concatenate([_picture(), _picture(1)[..., :1]], -1)
    path = str(tmp_path / 'cmyk.jpg')
    Image.fromarray(cmyk, 'CMYK').save(path, quality=90,
                                       progressive=progressive)
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    i = data.find(b'Adobe')
    assert data[i + 11] == 0
    if transform is None:
        j = i - 4
        data = data[:j] + data[j + 2 + struct.unpack('>H',
                                                     data[j + 2:j + 4])[0]:]
    else:
        data[i + 11] = transform
    with open(path, 'wb') as f:
        f.write(data)
    ref = np.asarray(Image.open(path).convert('RGB'))
    assert read_jpeg(path).tobytes() == ref.tobytes()
    for gamma in (True, False):
        assert ptex.load_bitmap(path, gamma=gamma).tobytes() == \
            jtex.load_bitmap(path, gamma=gamma).tobytes()


def _lossless(path, img, psv, restart=0):
    """A lossless (SOF3) JPEG of ``img`` (H, W, C) uint8: predictor
    ``psv``, Pt 0, one interleaved scan, every category coded in 5 bits,
    a restart marker every ``restart`` pixels (whole rows)."""
    Hh, Ww, C = img.shape
    x = img.astype(np.int64)
    bits = []
    for k in range(Hh * Ww):
        y, xx = divmod(k, Ww)
        first = restart and (y * Ww) % restart == 0 or y == 0
        if restart and k and k % restart == 0:
            bits += [1] * (-len(bits) % 8)
            bits.append(('RST', (k // restart - 1) % 8))
        for c in range(C):
            a = x[y, xx - 1, c] if xx else 0
            b = x[y - 1, xx, c] if y else 0
            cc = x[y - 1, xx - 1, c] if y and xx else 0
            if first:
                p = a if xx else 128
            elif xx == 0:
                p = b
            else:
                p = (a, b, cc, a + b - cc, a + ((b - cc) >> 1),
                     b + ((a - cc) >> 1), (a + b) >> 1)[psv - 1]
            d = (int(x[y, xx, c]) - int(p)) & 0xFFFF
            d = d - 65536 if d >= 32768 else d
            n = abs(d).bit_length()
            bits += [(n >> i) & 1 for i in range(4, -1, -1)]
            if n:
                v = d if d > 0 else d + (1 << n) - 1
                bits += [(v >> i) & 1 for i in range(n - 1, -1, -1)]
    bits += [1] * (-len(bits) % 8)
    out, cur = b'', []
    for b in bits + [('END', 0)]:
        if isinstance(b, tuple):
            out += np.packbits(np.array(cur, np.uint8)).tobytes().replace(
                b'\xff', b'\xff\x00')
            cur = []
            if b[0] == 'RST':
                out += bytes([0xFF, 0xD0 + b[1]])
        else:
            cur.append(b)
    sof = struct.pack('>BHHB', 8, Hh, Ww, C) + b''.join(
        bytes([i + 1, 0x11, 0]) for i in range(C))
    dht = bytes([0]) + bytes([0, 0, 0, 0, 17] + [0] * 11) + bytes(range(17))
    sos = bytes([C]) + b''.join(bytes([i + 1, 0]) for i in range(C)) + \
        bytes([psv, 0, 0])
    seg = b''
    if restart:
        seg = b'\xff\xdd' + struct.pack('>HH', 4, restart)
    with open(path, 'wb') as f:
        f.write(b'\xff\xd8' + b'\xff\xc3' + struct.pack('>H', len(sof) + 2)
                + sof + b'\xff\xc4' + struct.pack('>H', len(dht) + 2) + dht
                + seg + b'\xff\xda' + struct.pack('>H', len(sos) + 2) + sos
                + out + b'\xff\xd9')


@pytest.mark.parametrize('psv', range(1, 8))
@pytest.mark.parametrize('channels', [1, 3])
def test_lossless_jpeg_equals_pil(tmp_path, channels, psv):
    """libjpeg-turbo under PIL decodes lossless JPEG (grey, and three
    components with ids 1-3 as RGB); predictors 1-7, with restart
    intervals of two rows for the odd ones."""
    img = _picture(psv)[..., :channels]
    path = str(tmp_path / 'lossless.jpg')
    _lossless(path, img, psv, restart=2 * W if psv % 2 else 0)
    ref = np.asarray(Image.open(path).convert('RGB'))
    assert (ref == np.broadcast_to(img, ref.shape)).all()   # the encoder
    assert read_jpeg(path).tobytes() == ref.tobytes()


@pytest.mark.parametrize('kind', ['12-bit', 'hierarchical'])
def test_jpeg_kinds_pil_refuses_raise_oserror_in_both(tmp_path, kind):
    """A 12-bit frame (PIL's JPEG plugin refuses it: no plugin opens the
    file) and a hierarchical one (libjpeg refuses SOF5) fail in both."""
    path = _write(tmp_path, '420', 80, 0)
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    i = data.find(b'\xff\xc0')
    if kind == '12-bit':
        data[i + 4] = 12
    else:
        data[i + 1] = 0xC5
    with open(path, 'wb') as f:
        f.write(data)
    with pytest.raises(OSError):
        jtex.load_bitmap(path)
    with pytest.raises(OSError):
        ptex.load_bitmap(path)


def test_arithmetic_jpeg_raises_naming_its_roadmap_entry(tmp_path):
    """No arithmetic-coded file can be made here (PIL writes none), so
    the port raises at its frame header, naming 12.6."""
    path = _write(tmp_path, '420', 80, 0)
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    data[data.find(b'\xff\xc0') + 1] = 0xC9
    with open(path, 'wb') as f:
        f.write(data)
    with pytest.raises(NotImplementedError,
                       match=r'arithmetic-coded JPEG.*item 12\.6'):
        read_jpeg(path)
