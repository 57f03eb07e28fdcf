"""The volumetric slice as a whole: ``volpath`` and ``volpathmis`` renders
of the port against the reference's from the same seed and the same
arrays (carried across by ``scene_from_numpy``), the two NEE paths of the
port against each other, and the builder's media against the reference
builder's.

Both packages draw the same random numbers, so they trace the same paths
up to decisions a last-bit difference flips (XLA on the CPU fuses
multiply-adds). The reference gates are ``testing/compare.py``'s: at
least 99% of pixels within 1e-3 relative, means within 1e-3, ray counts
within 0.1%, and the golden suite's per-pixel z-test on 99% of pixels.
Found at these sizes (16x16, 2 spp, seed 0): every pixel within 1e-3,
means within 3e-7 relative, ray counts equal (hetvol takes the
single-segment NEE in both packages; the homogeneous box the general
walk). The two NEE estimators draw
different random numbers, so that comparison is statistical: the z-test,
and image means within four standard errors of their difference (the
errors from the per-pass means).
"""
import functools

import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch.integrators import volpath as pvolpath
from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
from mitsuba_nlvrl_tpu_torch.ops.cuda import intersect_cuda as kern
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import build_both, scene_arrays

SPP = 2
RES = 16
HOMOGENEOUS = {'type': 'homogeneous', 'sigma_t': 0.5, 'albedo': 0.8}


def _desc(name, pkg=scenes):
    """The scenes of this file, from either package's scene module."""
    if name.startswith('hetvol'):
        return pkg.cornell_box(
            spp=SPP, res=RES, integrator={'type': 'volpath', 'max_depth': 8},
            medium=pscenes.hetvol_medium(grid_res=16, seed=0, scale=20.0))
    return pkg.cornell_box(spp=SPP, res=RES,
                           integrator={'type': name.split('-')[1],
                                       'max_depth': 8},
                           medium=HOMOGENEOUS)


@functools.lru_cache(maxsize=None)
def _scenes(name):
    return build_both(_desc(name))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(image, rays) of the reference's render."""
    sj, mj, _, _ = _scenes(name)
    stats = []
    img = np.asarray(J.render(sj, mj, seed=0, spp=SPP, ray_stats=stats))
    return img, sum(float(r) for r in stats)


@functools.lru_cache(maxsize=None)
def _port(name, nee_walk=False):
    """(image, per-pass images, rays) of the port's render of the
    reference's arrays; ``nee_walk`` forces its general NEE walk."""
    _, _, sp, mp = _scenes(name)
    gate = pvolpath._nee_single_segment
    if nee_walk:
        pvolpath._nee_single_segment = lambda meta: False
    try:
        return compare.render_with_passes(sp, mp, 0, SPP)
    finally:
        pvolpath._nee_single_segment = gate


@pytest.mark.parametrize('name', ['homogeneous-volpath',
                                  'homogeneous-volpathmis',
                                  'hetvol-volpath'])
def test_volpath_matches_reference(name):
    _, _, _, mp = _scenes(name)
    # the homogeneous box takes the general NEE walk, hetvol the fast path
    assert pvolpath._nee_single_segment(mp) == name.startswith('hetvol')
    img_j, rays_j = _reference(name)
    img_p, passes, rays_p = _port(name, False)
    assert img_p.shape == img_j.shape == (RES, RES, 3)
    a = compare.agreement(img_p, img_j, passes, rays_p, rays_j)
    compare.check(a)
    assert a['mean'] > 0.01


def test_fast_nee_matches_the_general_walk():
    """hetvol's single-segment NEE against the general surface-crossing
    walk on the same scene: two estimators of the same image."""
    img_f, passes_f, rays_f = _port('hetvol-volpath', False)
    img_w, passes_w, rays_w = _port('hetvol-volpath', True)
    assert not np.array_equal(img_f, img_w)    # the other path ran
    assert rays_w > rays_f                     # a segment a crossing
    var = passes_f.var(axis=0, ddof=1) + passes_w.var(axis=0, ddof=1)
    p = compare.z_test(img_f, SPP, img_w, var / 2, SPP)
    alpha_c = 1.0 - (1.0 - compare.Z_ALPHA) ** (1.0 / p.size)
    assert (p >= alpha_c).mean() >= compare.Z_FRACTION
    se = np.sqrt((passes_f.reshape(SPP, -1).mean(1).var(ddof=1)
                  + passes_w.reshape(SPP, -1).mean(1).var(ddof=1)) / SPP)
    assert abs(img_f.mean() - img_w.mean()) <= 4 * se + 1e-6


META_FIELDS = ('n_tris', 'n_shapes', 'n_bsdfs', 'n_media', 'bsdf_types',
               'medium_types', 'phase_types', 'has_media', 'camera_medium',
               'integrator')


@pytest.mark.parametrize('name', ['homogeneous-volpath', 'hetvol-volpath'])
def test_builder_matches_reference(name):
    """Each package's own builder on the same description: every array
    the port holds equals the reference's to 1e-6 (the grid's bounds and
    packed rows exactly), and the render of the port's own build passes
    the reference gates."""
    sj, mj = J.build_scene(_desc(name))
    sp, mp = P.build_scene(_desc(name, pscenes), device='cpu')
    ref, port = scene_arrays(sj), scene_arrays(sp)
    for k, a in port.items():
        b = ref[k]
        assert a.shape == b.shape, k
        if k.startswith('media.grid') or a.dtype.kind in 'biu':
            assert (a == b).all(), k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert ('media.grid_sigma_p8' in port) == name.startswith('hetvol')
    for f in META_FIELDS:
        assert getattr(mp, f) == getattr(mj, f), f
    if name == 'homogeneous-volpath':
        img_j, rays_j = _reference(name)
        img_p, passes, rays_p = compare.render_with_passes(sp, mp, 0, SPP)
        compare.check(compare.agreement(img_p, img_j, passes, rays_p,
                                        rays_j))


def test_hetvol_box_scene():
    """The full-width configuration's description, built at a smaller
    grid (a 128^3 grid is the same code)."""
    d = pscenes.hetvol_density(48, seed=0)
    assert d.shape == (48, 48, 48) and d.dtype == np.float32
    assert d.max() == 1.0 and d.min() == 0.0
    assert np.array_equal(d, pscenes.hetvol_density(48, seed=0))
    assert not np.array_equal(d, pscenes.hetvol_density(48, seed=1))
    desc = pscenes.hetvol_box(40, 30, spp=1, grid_res=48, seed=0,
                              scale=100.0)
    s, m = P.build_scene(desc, device='cpu')
    assert (m.film.width, m.film.height) == (40, 30)
    assert m.integrator == 'volpath' and m.iprop('max_depth') == 8
    params = s.media.params[0]
    assert float(params[6]) == 100.0                  # scale
    assert np.allclose(params[3:6].numpy(), 0.75)     # albedo default
    assert float(params[7]) == pytest.approx(0.8)     # HG g default
    assert float(params[14]) == 100.0                 # majorant
    # vacuum blocks: the leap has work to do
    assert (s.media.grid_sup == 0).any() and (s.media.grid_sup > 0).any()
    assert (s.media.grid_sigma_p8[:, 9] < 0).any()


@pytest.mark.parametrize('name', ['homogeneous-volpathmis',
                                  'hetvol-volpath'])
def test_volumetric_render_hands_the_kernel_contiguous_rays(monkeypatch,
                                                            name):
    """The wrapper refuses strided rays on the card, so every ray the
    volumetric integrators build must be contiguous already; the any-hit
    calls of hetvol's NEE go to the occluder subset."""
    calls = []
    plain = kern.intersect_tris_plain

    def check(*args, any_hit=False):
        assert all(x.is_contiguous() for x in args)
        assert all(x.dtype == torch.float32 for x in args)
        calls.append((args[0].shape[0], any_hit))
        return plain(*args, any_hit=any_hit)
    monkeypatch.setattr(pisect, 'intersect_tris', check)
    desc = _desc(name, pscenes)
    desc['sensor']['film'].update(width=8, height=8)
    scene, meta = P.build_scene(desc, device='cpu')
    P.render(scene, meta, seed=0, spp=1)
    if name == 'hetvol-volpath':
        assert set(calls) == {(24, False), (12, True)}
    else:
        assert set(calls) == {(24, False)}
