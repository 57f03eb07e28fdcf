"""The port's spectral variant against the reference's on the CPU: the
hero-wavelength sampler and its pdf, the CIE and D65 tables, Planck's
law, the sigmoid-polynomial upsampling and its coefficient table, the
emitters' true spectra, a named conductor's per-wavelength Fresnel
ratio, and a spectral ``path`` render with a tabulated conductor; and
the integrators that still refuse a spectral scene.

Tolerances: the elementwise functions within 1e-6 relative (1e-6
absolute near zero); within 1e-5 the hero sampler's inverse pdfs, the
upsampled reflectance and weight and Planck's law, whose atanh, cosh
and exp XLA and torch approximate a few ulps apart (measured: 0.8e-6,
0.9e-6 absolute, 3.5e-6 and 4.0e-6 relative at most);
the table equal in bits; the fit within 1e-9 (both numpy); the render's
every pixel within 1e-3 relative (1e-6 absolute) and its ray count equal,
the reference under ``ieee_reference`` with one pass a dispatch."""
import functools
import os

import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
from mitsuba_nlvrl_tpu import bsdf as jbsdf
from mitsuba_nlvrl_tpu import emitter as jem
from mitsuba_nlvrl_tpu.core import spectral as jsp
from mitsuba_nlvrl_tpu.core import spectrum as jspec
from mitsuba_nlvrl_tpu.core import transform as jtr
from mitsuba_nlvrl_tpu.ops import intersect as jisect
from mitsuba_nlvrl_tpu.scene import ior_data as jior

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch import bsdf as pbsdf
from mitsuba_nlvrl_tpu_torch import emitter as pem
from mitsuba_nlvrl_tpu_torch.core import spectral as psp
from mitsuba_nlvrl_tpu_torch.core import spectrum as pspec
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import (build_both, ieee_jit, ieee_reference,
                          jax_meta_dict, port_si, scene_arrays)

N = 2048
T = torch.as_tensor


def _close(a, b, rtol=1e-6, atol=1e-6, what=''):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=what)


def _lam(rng, n=N):
    """Wavelengths over and a little past [360, 830] nm."""
    lam = rng.uniform(340.0, 850.0, (n, 4)).astype(np.float32)
    lam[0] = (360.0, 830.0, 359.99, 830.01)
    return lam


def test_hero_wavelengths_and_pdf_match_reference():
    u = np.random.default_rng(1).uniform(size=N).astype(np.float32)
    u[:3] = (0.0, 0.5, np.float32(1.0 - 2 ** -24))
    lam_p, w_p = psp.sample_hero_wavelengths(T(u))
    lam_j, w_j = ieee_jit(jsp.sample_hero_wavelengths)(u)
    _close(lam_p, lam_j, what='wavelengths')
    _close(w_p, w_j, 1e-5, 1e-5, 'inverse pdfs')
    lam = _lam(np.random.default_rng(2))
    _close(psp.pdf_rgb_spectrum(T(lam)), ieee_jit(jsp.pdf_rgb_spectrum)(lam),
           1e-6, 1e-9, 'pdf')


def test_tables_and_planck_match_reference():
    rng = np.random.default_rng(3)
    lam = _lam(rng)
    _close(psp.cie1931_xyz(T(lam)), ieee_jit(jsp.cie1931_xyz)(lam),
           what='cie')
    _close(psp.d65_eval(T(lam)), ieee_jit(jsp.d65_eval)(lam), what='d65')
    tab = rng.uniform(0.0, 3.0, (N, 95)).astype(np.float32)
    _close(psp.cie_table_eval(T(tab), T(lam)),
           ieee_jit(jsp.cie_table_eval)(tab, lam), what='table')
    _close(psp.cie_table_eval(T(tab[0]), T(lam)),
           ieee_jit(jsp.cie_table_eval)(tab[0], lam), what='shared table')
    temp = rng.uniform(1000.0, 12000.0, (N, 1)).astype(np.float32)
    _close(psp.planck(T(lam), T(temp)), ieee_jit(jsp.planck)(lam, temp),
           1e-5, 1e-12, 'planck')
    vals = rng.uniform(0.0, 2.0, (N, 4)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, (N, 4)).astype(np.float32)
    _close(psp.spectral_to_srgb(T(vals), T(lam), T(w)),
           ieee_jit(jsp.spectral_to_srgb)(vals, lam, w), what='develop')
    rgb = rng.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    for f in ('srgb_to_xyz', 'xyz_to_srgb', 'luminance'):
        _close(getattr(pspec, f)(T(rgb)),
               ieee_jit(getattr(jspec, f))(rgb), what=f)


def _colours(rng, n=N):
    """Seeded colours: uniform, saturated, grey, black, near-black."""
    rgb = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    rgb[:8] = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
    rgb[8:16] = rng.uniform(size=(8, 1))
    rgb[16:20] = 0.0
    rgb[20:24] = 1e-6
    return rgb


def test_upsampling_matches_reference():
    rng = np.random.default_rng(4)
    rgb = _colours(rng)
    lam = _lam(rng)
    _close(psp._lut_fetch(T(rgb)), ieee_jit(jsp._lut_fetch)(rgb),
           what='coefficients')
    _close(psp.upsample_reflectance(T(rgb), T(lam)),
           ieee_jit(jsp.upsample_reflectance)(rgb, lam), 1e-5, 1e-6,
           'reflectance')
    big = rgb * rng.uniform(0.0, 20.0, (N, 1)).astype(np.float32)
    _close(psp.upsample_weight(T(big), T(lam)),
           ieee_jit(jsp.upsample_weight)(big, lam), 1e-5, 1e-6, 'weight')
    _close(psp.emitter_spectrum(T(big), T(lam)),
           ieee_jit(jsp.emitter_spectrum)(big, lam), what='emitter')
    coeff = rng.normal(0.0, 5.0, (N, 3)).astype(np.float32)
    _close(psp.srgb_model_eval(T(coeff), T(lam)),
           ieee_jit(jsp.srgb_model_eval)(coeff, lam), 1e-6, 1e-6, 'model')


def test_lut_is_the_ports_own_copy_equal_to_the_reference():
    """The port reads its own table (never the reference package's data
    directory); its array equals the reference's file."""
    port_dir = os.path.dirname(os.path.dirname(psp.__file__))
    assert psp.LUT_PATH.startswith(port_dir + os.sep)
    ours = np.load(psp.LUT_PATH)['lut']
    theirs = np.load(jsp._LUT_PATH)['lut']
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert np.array_equal(psp.get_lut_np(), ours)


def test_missing_lut_is_fitted_into_build(tmp_path, monkeypatch):
    """Without the shipped table the port fits one (here a stand-in fit)
    and writes it under ``_build/``, where the next load finds it."""
    built = str(tmp_path / '_build' / 'srgb_coeff.npz')
    table = np.arange(3 * psp.LUT_S * psp.LUT_A * psp.LUT_A * 3,
                      dtype=np.float32).reshape(3, psp.LUT_S, psp.LUT_A,
                                                psp.LUT_A, 3)
    monkeypatch.setattr(psp, 'LUT_PATH', str(tmp_path / 'absent.npz'))
    monkeypatch.setattr(psp, 'BUILT_LUT_PATH', built)
    monkeypatch.setattr(psp, '_LUT_CACHE', None)
    monkeypatch.setattr(psp, 'build_lut', lambda: table)
    assert np.array_equal(psp.get_lut_np(), table)
    assert np.array_equal(np.load(built)['lut'], table)
    monkeypatch.setattr(psp, '_LUT_CACHE', None)
    monkeypatch.setattr(psp, 'build_lut', lambda: 1 / 0)
    assert np.array_equal(psp.get_lut_np(), table)


def test_fit_matches_reference():
    """The Gauss-Newton fit on 64 seeded colours (the whole table's fit,
    about half a minute, is not run here)."""
    rgb = np.random.default_rng(5).uniform(size=(64, 3))
    np.testing.assert_allclose(psp.fit_sigmoid_coeffs(rgb),
                               jsp.fit_sigmoid_coeffs(rgb), rtol=1e-9,
                               atol=1e-9)


def _ior_dir(tmp_path_factory):
    return pscenes.write_conductor_spd(
        str(tmp_path_factory.getbasetemp() / 'ior'))


@pytest.fixture
def conductor_dir(tmp_path_factory, monkeypatch):
    """The named conductor's curves in a directory both packages read."""
    d = _ior_dir(tmp_path_factory)
    monkeypatch.setenv('MNT_IOR_DIR', d)
    monkeypatch.setattr(jior, '_SPD_DIRS', [d])
    return d


def _lights_box(pkg):
    """The box under an RGB area light, a blackbody point, a d65 constant
    and an irregular-SPD spot (every SPEC_* kind and radiance slot)."""
    desc = pkg.cornell_box(spp=1, res=8, light='area')
    desc['emitters'] = [
        {'type': 'point', 'position': (0.2, 0.5, 0.1),
         'intensity': {'type': 'blackbody', 'temperature': 3200.0}},
        {'type': 'constant', 'radiance': {'type': 'd65', 'scale': 0.3}},
        {'type': 'spot', 'position': (0.0, 0.9, -0.5),
         'direction': (0.0, -1.0, 0.3),
         'intensity': pscenes.cbox_light_spd()}]
    desc['spectral'] = True
    return desc


def test_spectral_radiance_matches_reference():
    sj, mj, sp, mp = build_both(_lights_box(scenes))
    assert mp.spectral
    rng = np.random.default_rng(6)
    E = int(sp.emitters.type.shape[0])
    e_idx = rng.integers(-1, E, N).astype(np.int32)
    rgb = rng.uniform(0.0, 5.0, (N, 3)).astype(np.float32)
    lam = _lam(rng)
    got = pem.spectral_radiance(sp, T(rgb), T(e_idx), T(lam))
    ref = ieee_jit(jem.spectral_radiance)(sj, rgb, e_idx, lam)
    _close(got, ref)
    assert set(sp.emitters.spec_kind.tolist()) == {0, 1, 2}


def _rays(seed, n=N):
    """Seeded rays from the camera's side into the box."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([[0.0, 0.0, -3.2]]), (n, 1))
    tgt = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    tgt[:, 2] = rng.uniform(-0.9, 1.0, n)
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)) \
        .astype(np.float32)


def test_spectral_fresnel_ratio_matches_reference(conductor_dir):
    """On the lanes of the spectral box (the named conductor's two blocks
    among them): the ratio F(lam) / upsample(F_rgb) of each lane."""
    desc = pscenes.dress_spectral(scenes.cornell_box(spp=1, res=8), jtr)
    sj, mj, sp, mp = build_both(desc)
    assert mp.has_conductor_spd and mj.has_conductor_spd
    o, d = _rays(7)
    from mitsuba_nlvrl_tpu.core.ray import Ray as JRay
    inf = np.full(N, np.inf, np.float32)
    zero = np.zeros(N, np.float32)
    with ieee_reference():
        si_j = ieee_jit(lambda s, r: jisect.ray_intersect(s, r))(
            sj, JRay(o, d, zero, inf))
    # the reference's hits, so that both evaluate the very same lanes (the
    # hits' frames differ by an ulp, which a grazing cosine magnifies)
    si_p = port_si(si_j)
    rng = np.random.default_rng(8)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2])
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    # the delta conductor's mirror directions
    wi = np.asarray(si_j.wi)
    wo[: N // 4] = wi[: N // 4] * np.float32([-1.0, -1.0, 1.0])
    lam = _lam(rng)
    got = pbsdf.spectral_fresnel_ratio(sp, mp, si_p, T(wo), T(lam))
    with ieee_reference():
        ref = ieee_jit(lambda s, si, w, l: jbsdf.spectral_fresnel_ratio(
            s, mj, si, w, l))(sj, si_j, wo, lam)
    _close(got, ref)
    cond = np.isin(np.asarray(si_j.bsdf_idx),
                   np.flatnonzero(np.asarray(sj.bsdfs.params)[:, 13] > 0))
    assert cond.sum() > 50
    assert (np.abs(got.numpy()[cond] - 1.0) > 1e-3).any()


@functools.lru_cache(maxsize=None)
def _spectral_render(ior_dir):
    desc = scenes.cornell_box(spp=2, res=16,
                              integrator={'type': 'path', 'max_depth': 6})
    desc['shapes'][5]['emitter']['radiance'] = pscenes.cbox_light_spd()
    desc = pscenes.dress_spectral(desc, jtr)
    sj, mj, sp, mp = build_both(desc)
    stats = []
    with ieee_reference():
        img = np.asarray(J.render(sj, mj, seed=0, spp=2, ray_stats=stats,
                                  spp_per_dispatch=1))
    return sp, mp, img, sum(float(r) for r in stats)


def test_spectral_render_matches_reference(conductor_dir):
    """A spectral ``path`` render of the box under the reference cbox.xml's
    tabulated light, with the named conductor's two blocks."""
    sp, mp, img_j, rays_j = _spectral_render(conductor_dir)
    assert mp.spectral and mp.has_conductor_spd
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, 2)
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert rays_p == rays_j
    assert img_p.mean() > 0.01


@pytest.mark.parametrize('integrator', ['volpath', 'vrl'])
def test_spectral_request_renders_rgb_transport(integrator):
    """A spectral request on an integrator other than ``path`` renders
    what the reference renders, its RGB transport (the reference renders
    spectral only under ``path``): from the port's builder, and from the
    reference's arrays through both packages, every pixel within 1e-3
    relative and the rays equal (``vrl`` on the reference's maps); the
    double variant builds in float64."""
    from torch_parity import HOMOGENEOUS_HG, two_pass_desc
    if integrator == 'vrl':
        dj, dp = (two_pass_desc(pkg, 'vrl', 'homogeneous')
                  for pkg in (scenes, pscenes))
    else:
        dj, dp = (pkg.cornell_box(spp=2, res=8, medium=HOMOGENEOUS_HG,
                                  integrator={'type': integrator,
                                              'max_depth': 4})
                  for pkg in (scenes, pscenes))
    dj['spectral'] = dp['spectral'] = True
    _, mq = P.build_scene(dp, device='cpu')
    assert mq.spectral and mq.integrator == integrator
    sj, mj, sp, mp = build_both(dj)
    stats, aux = [], None
    with ieee_reference():
        if integrator == 'vrl':
            from mitsuba_nlvrl_tpu.render import preprocess
            aux = preprocess(sj, mj, 0)
        img_j = np.asarray(J.render(sj, mj, seed=0, spp=2, aux=aux,
                                    ray_stats=stats, spp_per_dispatch=1))
    maps_p = (P.maps_from_numpy(scene_arrays(aux), device='cpu')
              if aux is not None else None)
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, 2, maps_p)
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert rays_p == sum(float(r) for r in stats)
    assert img_p.mean() > 0.005
    desc = pscenes.cornell_box(spp=1, res=8)
    desc['double'] = True
    s64, _ = P.build_scene(desc, device='cpu')
    assert s64.dtype == torch.float64


