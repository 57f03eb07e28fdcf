"""``stokes`` renders of the polarized box through the port against the
reference on the CPU: components 0-3 around ``path`` (the polarized
variant) and, with spectral transport on, components 0 and 3 (the
spectral polarized variant, the named conductor's per-wavelength
Mueller structure among its terms).

Each reference image comes from one compiled pass that keeps all four
components (``torch_parity.reference_stokes_images``: the reference's
pass keys, sensor rays, Stokes estimate and film splat) under
``ieee_reference``. Tolerance: every pixel of every component within
1e-3 of the pixel's largest S0 channel (S1-S3 are signed and cross
zero), the ray counts equal."""
import functools

import numpy as np
import pytest

from mitsuba_nlvrl_tpu.core import transform as jtr
from mitsuba_nlvrl_tpu.scene import ior_data as jior

from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import (build_both, check_stokes_render,
                          reference_stokes_images)

RES, SPP = 16, 2


def _box(spectral: bool):
    desc = scenes.cornell_box(spp=SPP, res=RES,
                              integrator=pscenes.stokes_integrator(0, 6))
    desc = pscenes.dress_polarized(
        desc, jtr, conductor=pscenes.SPECTRAL_CONDUCTOR if spectral else None)
    desc['spectral'] = spectral
    return desc


@functools.lru_cache(maxsize=None)
def _case(spectral: bool, ior_dir: str):
    sj, mj, sp, mp = build_both(_box(spectral))
    images_j, rays_j = reference_stokes_images(sj, mj, SPP)
    return sp, mp, images_j, rays_j


@pytest.fixture
def ior_dir(tmp_path_factory, monkeypatch):
    d = pscenes.write_conductor_spd(
        str(tmp_path_factory.getbasetemp() / 'ior'))
    monkeypatch.setenv('MNT_IOR_DIR', d)
    monkeypatch.setattr(jior, '_SPD_DIRS', [d])
    return d


@pytest.mark.parametrize('component', [0, 1, 2, 3])
def test_stokes_render_matches_reference(component, ior_dir):
    sp, mp, images_j, rays_j = _case(False, ior_dir)
    img = check_stokes_render(sp, mp, images_j, rays_j, component, SPP)
    assert np.isfinite(img).all()
    if component == 0:
        assert img.mean() > 0.01
    else:
        assert np.abs(img).max() > 1e-3      # the box polarizes


@pytest.mark.parametrize('component', [0, 3])
def test_spectral_stokes_render_matches_reference(component, ior_dir):
    sp, mp, images_j, rays_j = _case(True, ior_dir)
    assert mp.spectral and mp.has_conductor_spd
    img = check_stokes_render(sp, mp, images_j, rays_j, component, SPP)
    assert np.isfinite(img).all()
    assert np.abs(img).max() > 1e-3
