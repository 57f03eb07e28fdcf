"""The port's baseline JPEG decoder (``utils/io.read_jpeg``) against PIL,
the reference's decoder, and ``texture.load_bitmap`` against the
reference's on JPEG files.

PIL writes each file: 4:4:4, 4:2:2 and 4:2:0 colour and grey, at
qualities 50 and 95, with and without restart markers, at 37 x 23 so that
the last MCU column and row are cut. The decoder runs libjpeg's default
path (islow IDCT, fancy upsampling, its integer colour tables), so the
samples equal PIL's ``convert('RGB')`` byte for byte. A progressive file
raises, naming its ROADMAP entry."""
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


@pytest.mark.parametrize('restart', [0, 2])
@pytest.mark.parametrize('quality', [50, 95])
@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_read_jpeg_equals_pil(tmp_path, layout, quality, restart):
    path = _write(tmp_path, layout, quality, restart)
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


def test_progressive_jpeg_raises_naming_its_roadmap_entry(tmp_path):
    path = _write(tmp_path, '420', 80, 0, progressive=True)
    with pytest.raises(NotImplementedError,
                       match=r'progressive JPEG.*item 12\.6'):
        read_jpeg(path)
