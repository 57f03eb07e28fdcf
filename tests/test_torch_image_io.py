"""The port's image I/O against the reference's: what one package writes
the other reads to the same pixels, exactly, for EXR, PFM, PPM and RGBE;
PNG files are the same bytes; ``resample_image`` gives the same image.
The writers also take a tensor."""
import io
import os

import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.utils import io as J
from mitsuba_nlvrl_tpu_torch.utils import io as P

torch.set_num_threads(1)   # one intra-op thread a test worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a PIZ-compressed EXR in the repository (none is committed yet)
PIZ_EXR = os.path.join(ROOT, 'tests', 'data', 'piz.exr')


def _image(seed, h=7, w=11, c=3):
    rng = np.random.default_rng(seed)
    img = rng.lognormal(-1.0, 1.5, (h, w, c)).astype(np.float32)
    img[0, 0] = 0.0
    return img


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_exr_both_ways(tmp_path, channels):
    img = _image(1, c=channels)
    for writer, reader in ((P.write_exr, J.read_exr),
                           (J.write_exr, P.read_exr)):
        path = str(tmp_path / 'a.exr')
        writer(path, img)
        got, names = reader(path)
        ref, ref_names = J.read_exr(path)
        assert names == ref_names and np.array_equal(got, ref)
        # channels come back in alphabetical order
        order = {1: ['Y'], 3: list('RGB'), 4: list('RGBA')}[channels]
        assert np.array_equal(got[..., [names.index(c) for c in order]],
                              img)
    P.write_exr(str(tmp_path / 't.exr'), torch.from_numpy(img))
    J.write_exr(str(tmp_path / 'n.exr'), img)
    assert (tmp_path / 't.exr').read_bytes() == \
        (tmp_path / 'n.exr').read_bytes()


@pytest.mark.parametrize('fmt', ['pfm', 'ppm', 'rgbe'])
def test_pfm_ppm_rgbe_both_ways(tmp_path, fmt):
    img = _image(2)
    for wpkg, rpkg in ((P, J), (J, P)):
        path = str(tmp_path / f'a.{fmt}')
        getattr(wpkg, f'write_{fmt}')(path, img)
        got = getattr(rpkg, f'read_{fmt}')(path)
        ref = getattr(J, f'read_{fmt}')(path)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    if fmt == 'pfm':
        assert np.array_equal(got, img)
    getattr(P, f'write_{fmt}')(str(tmp_path / 't'), torch.from_numpy(img))
    getattr(J, f'write_{fmt}')(str(tmp_path / 'n'), img)
    assert (tmp_path / 't').read_bytes() == (tmp_path / 'n').read_bytes()


def test_png_bytes_equal(tmp_path):
    img = _image(3)
    gray = _image(4, c=1)[..., 0]
    for im in (img, gray, (img * 80).astype(np.uint8)):
        a, b = io.BytesIO(), io.BytesIO()
        P.write_png(a, im)
        J.write_png(b, im)
        assert a.getvalue() == b.getvalue()
    P.write_png(str(tmp_path / 'a.png'), torch.from_numpy(img), gamma=False)
    J.write_png(str(tmp_path / 'b.png'), img, gamma=False)
    assert (tmp_path / 'a.png').read_bytes() == \
        (tmp_path / 'b.png').read_bytes()


@pytest.mark.parametrize('rfilter,boundary', [
    ('lanczos', 'clamp'), ('gaussian', 'wrap'), ('mitchell', 'mirror'),
    ('box', 'zero'), ('tent', 'clamp'), ('catmullrom', 'clamp')])
def test_resample_image(rfilter, boundary):
    img = _image(5, h=13, w=17)
    for size in ((9, 6), (34, 20), (17, 13)):
        got = P.resample_image(torch.from_numpy(img), size, rfilter,
                               boundary, clamp_range=(0.0, np.inf))
        ref = J.resample_image(img, size, rfilter, boundary,
                               clamp_range=(0.0, np.inf))
        assert got.shape == ref.shape and np.array_equal(got, ref)


@pytest.mark.skipif(not os.path.exists(PIZ_EXR),
                    reason="no PIZ-compressed EXR in the repository")
def test_read_exr_piz_matches_reference():
    got, names = P.read_exr(PIZ_EXR)
    ref, ref_names = J.read_exr(PIZ_EXR)
    assert names == ref_names and np.array_equal(got, ref)
