"""The port's WebP decoders (``utils/webp.py``, ``vp8.py``, ``vp8l.py``)
against the reference's ``load_bitmap``, which opens the file with PIL's
``Image.open(path).convert('RGB')`` (libwebp underneath).

Every committed WebP fixture (``scripts/port_make_bitmaps.py``: lossless
at methods 0 and 6, palettes of 2, 4, 16 and 200 colours, grey, lossy at
three qualities, ALPH raw and lossless under each filter, the libwebp
encoder's simple filter, 4 token partitions, 1 segment, sharpness 7 and
no filter, 1x1, a two-frame animation) and a seeded sweep of small
random images, lossless and lossy, with and without alpha, load equal in
bits to the reference's; RGBA files also decode to PIL's RGBA bytes. An
animation whose first frame sits at an offset decodes onto its canvas,
truncated files raise ``OSError`` in both, and the two 512x512 files
decode to the digests of PIL's bytes."""
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
from mitsuba_nlvrl_tpu_torch.utils import webp

torch.set_num_threads(1)   # one intra-op thread a test worker

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
FIXTURES = os.path.join(DATA, 'bitmaps')
LARGE = os.path.join(DATA, 'webp_large')
WEBP_FIXTURES = sorted(n for n in os.listdir(FIXTURES)
                       if n.endswith('.webp'))


def _assert_matches_reference(path):
    """The port's loads equal the reference's in bits (gamma on and off),
    the format is identified as PIL identifies it, the mode is PIL's, and
    an RGBA image's pixels are PIL's RGBA bytes."""
    im = Image.open(path)
    assert ptex.identify(path) == im.format == 'WEBP'
    for g in (True, False):
        want = jtex.load_bitmap(path, gamma=g)
        got = ptex.load_bitmap(path, gamma=g)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    mode, px, _ = ptex._decode(path)
    assert mode == im.mode
    if mode == 'RGBA':
        assert px.tobytes() == np.asarray(im).tobytes()


@pytest.mark.parametrize('name', WEBP_FIXTURES)
def test_fixture_matches_reference(name):
    _assert_matches_reference(os.path.join(FIXTURES, name))


# the sweep: (picture, height, width, colours, alpha, lossless, method,
# quality); the pixels are random from seed 4000 + the case's index.
# Between them the lossless cases use every transform (colour indexing
# at each bundling), the colour cache and meta prefix codes; the lossy
# ones segments, the skip flag, and ALPH with and without quantised
# levels. Pictures: 'noise' (random colours of the palette), 'mix' (half
# of them replaced by gradients), 'corr' (channels moving together),
# 'halves' (a 4-level top half over a noisy bottom: two code groups),
# 'flat' (one colour under a noisy top strip: empty macroblocks).
SWEEP = [
    ('noise', 9, 13, 2, True, True, 0, 0),
    ('noise', 21, 7, 4, False, True, 3, 50),
    ('noise', 15, 31, 16, True, True, 6, 100),
    ('noise', 25, 17, 17, False, True, 4, 50),
    ('mix', 31, 39, 256, False, True, 6, 100),
    ('corr', 27, 19, 64, False, True, 5, 50),
    ('halves', 37, 39, 256, False, True, 6, 100),
    ('halves', 40, 33, 256, True, True, 5, 100),
    ('noise', 11, 29, 256, False, True, 1, 0),
    ('corr', 13, 23, 5, True, True, 4, 50),
    ('corr', 33, 35, 3, False, True, 2, 100),
    ('mix', 40, 39, 256, True, True, 6, 0),
    ('flat', 39, 40, 256, False, False, 0, 10),
    ('mix', 23, 37, 256, False, False, 4, 75),
    ('noise', 17, 9, 64, True, False, 6, 5),
    ('mix', 31, 31, 256, True, False, 2, 95),
    ('noise', 1, 1, 2, False, False, 3, 50),
    ('mix', 8, 33, 16, False, False, 5, 30),
    ('flat', 35, 36, 256, True, False, 1, 60),
    ('mix', 40, 27, 256, False, False, 6, 85),
    ('noise', 19, 2, 256, True, False, 0, 40),
    ('mix', 29, 40, 100, False, False, 1, 20),
    ('halves', 37, 40, 256, True, False, 4, 70),
    ('noise', 5, 3, 3, False, False, 2, 90),
]


def _sweep_image(i):
    """Sweep case ``i``'s PIL image and save options."""
    kind, h, w, ncol, alpha, lossless, method, q = SWEEP[i]
    rng = np.random.default_rng(4000 + i)
    pal = rng.integers(0, 256, (ncol, 4), dtype=np.uint8)
    if not alpha:
        pal[:, 3] = 255
    img = pal[rng.integers(0, ncol, (h, w))]
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == 'mix':
        grad = np.stack([xx * 5, yy * 7, (xx + yy) * 3], -1) % 256
        img[..., :3] = np.where(rng.uniform(size=(h, w, 1)) < 0.5,
                                img[..., :3], grad)
    elif kind == 'halves':
        img[:h // 2, :, :3] = rng.integers(0, 4, (h // 2, w, 3)) * 60
    elif kind == 'flat':
        img[4:, :, :3] = 120
    elif kind == 'corr':
        g = (xx * 3 + yy * 2 + rng.integers(0, 30, (h, w))) % 200
        img[..., :3] = np.stack([g + rng.integers(0, 3, (h, w)), g, g + 40],
                                -1)
    im = Image.fromarray(img, 'RGBA') if alpha else \
        Image.fromarray(img[..., :3])
    if lossless:
        return im, {'lossless': True, 'method': method, 'quality': q,
                    'exact': i % 5 == 1}
    return im, {'quality': q, 'method': method,
                'alpha_quality': 50 if i % 3 == 0 else 100}


@pytest.mark.parametrize('i', range(len(SWEEP)))
def test_random_image_matches_reference(tmp_path, i):
    im, kw = _sweep_image(i)
    path = str(tmp_path / f'sweep{i}.webp')
    im.save(path, 'WEBP', **kw)
    _assert_matches_reference(path)


def _chunks(data):
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos + 4:pos + 8], 'little')
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _riff(chunks):
    body = b'WEBP' + b''.join(t + struct.pack('<I', len(p)) + p
                              + b'\0' * (len(p) & 1) for t, p in chunks)
    return b'RIFF' + struct.pack('<I', len(body)) + body


@pytest.mark.parametrize('lossless,flags', [(True, 0x12), (False, 0x12),
                                            (False, 0x02)])
def test_animation_first_frame_at_an_offset(tmp_path, lossless, flags):
    """A still bitstream repacked as the first ``ANMF`` of an animation,
    at (6, 4) on a 50 x 40 canvas: decoded there onto transparent black,
    in PIL's mode (the VP8X alpha flag)."""
    rng = np.random.default_rng(11)
    rgba = rng.integers(0, 256, (23, 37, 4), dtype=np.uint8)
    b = io.BytesIO()
    Image.fromarray(rgba, 'RGBA').save(b, 'WEBP', lossless=lossless,
                                       quality=60)
    frame = b''.join(t + struct.pack('<I', len(p)) + p + b'\0' * (len(p) & 1)
                     for t, p in _chunks(b.getvalue())
                     if t in (b'ALPH', b'VP8 ', b'VP8L'))
    anmf = b''.join(v.to_bytes(3, 'little') for v in (3, 2, 36, 22, 100)) \
        + b'\0' + frame
    vp8x = bytes([flags, 0, 0, 0]) + (49).to_bytes(3, 'little') + \
        (39).to_bytes(3, 'little')
    path = str(tmp_path / 'anim.webp')
    with open(path, 'wb') as f:
        f.write(_riff([(b'VP8X', vp8x), (b'ANIM', bytes(6)),
                       (b'ANMF', anmf)]))
    _assert_matches_reference(path)
    mode, px, _ = ptex._decode(path)
    assert px.shape[:2] == (40, 50) and not px[:4].any()


@pytest.mark.parametrize('name,cut', [
    ('webp_lossless_m0.webp', 0.5), ('webp_lossy_q50.webp', 0.9),
    ('webp_alph_lossless_gradient.webp', 0.99),
    ('webp_animation_2_frames.webp', 0.6), ('picture64.webp', 0.1)])
def test_truncated_files_raise_oserror_in_both(tmp_path, name, cut):
    with open(os.path.join(FIXTURES, name), 'rb') as f:
        data = f.read()
    path = str(tmp_path / name)
    with open(path, 'wb') as f:
        f.write(data[:max(16, int(len(data) * cut))])
    with pytest.raises(OSError):
        jtex.load_bitmap(path)
    with pytest.raises(OSError):
        ptex.load_bitmap(path)


def test_large_files_decode_to_pils_digests():
    """The 512 x 512 lossless and lossy files (a texture's size): the
    port's RGB bytes have the stored digest of PIL's, and PIL's bytes
    still have it."""
    with open(os.path.join(LARGE, 'pil_rgb_sha256.json')) as f:
        want = json.load(f)
    assert sorted(want) == ['lossless_512.webp', 'lossy_512.webp']
    for name, d in want.items():
        path = os.path.join(LARGE, name)
        got = ptex.read_rgb8(path)
        assert list(got.shape) == d['shape'] == [512, 512, 3]
        assert hashlib.sha256(got.tobytes()).hexdigest() == d['sha256'], name
        pil = np.asarray(Image.open(path).convert('RGB'))
        assert hashlib.sha256(pil.tobytes()).hexdigest() == d['sha256'], name


def test_bad_containers_raise_oserror():
    """Files PIL refuses at open: a RIFF that is not WebP, a VP8X image
    whose bitstream differs from its canvas, a lossless bitstream after
    an ALPH chunk."""
    with open(os.path.join(FIXTURES, 'webp_lossless_m0.webp'), 'rb') as f:
        vp8l = _chunks(f.read())[0][1]
    wrong = bytes([0, 0, 0, 0]) + (9).to_bytes(3, 'little') + \
        (9).to_bytes(3, 'little')
    right = bytes([0x10, 0, 0, 0]) + (36).to_bytes(3, 'little') + \
        (22).to_bytes(3, 'little')
    for data in (b'RIFF\x04\0\0\0WAVE',
                 _riff([(b'VP8X', wrong), (b'VP8L', vp8l)]),
                 _riff([(b'VP8X', right), (b'ALPH', b'\0' * 900),
                        (b'VP8L', vp8l)])):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        with pytest.raises(OSError):
            webp.decode_webp(data)
