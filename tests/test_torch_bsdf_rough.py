"""The port's microfacet, plastic and two-sided BSDFs against the
reference's: packed rows equal for each type; ``eval``, ``pdf`` and
``sample`` through the type dispatch on one packed row a type, on 4,096
random directions with wi in the upper and in the lower hemisphere (the
sampled direction where its pdf is positive); the
16x16, 4 spp ``cbox_materials`` render (``path``) and a 16x8 photon-mapper
render of it, whose camera gathers reach ``estimate_surface``'s
per-photon BSDF branch.

Tolerances: rows equal; ``eval`` and ``pdf`` at given directions 1e-5
relative with an absolute floor of 1e-5 of the largest value; sampled
directions within 4e-5 absolute (tests/test_torch_microfacet.py says
why), and the sampled weight and pdf 1e-4 relative (they are evaluated
at the sampled direction, whose last-bit difference from sin and cos the
lobe's steepness scales by about 1 / alpha^2, 280 at the polarized
plastic's alpha 0.06); the sampled lobe equal on all lanes; the renders every pixel within 1e-3 relative (1e-6 absolute) and
the rays within ``compare.RAYS_RTOL`` (0.1%: a sample drawn through sin
and cos, which the two libraries round apart in the last bit, may send
one path elsewhere)."""
import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu import bsdf as jbsdf
from mitsuba_nlvrl_tpu.core import transform as jtr
from mitsuba_nlvrl_tpu_torch import bsdf as pbsdf
from mitsuba_nlvrl_tpu_torch.integrators import photon_est as pest
from mitsuba_nlvrl_tpu_torch.testing import compare
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import (build_both, ieee_reference, jax_meta_dict,
                          scene_arrays)

RTOL = 1e-5
SAMPLED_RTOL = 1e-4
DIR_ATOL = 4e-5
N = 4096
ROWS = {
    'thindielectric': {'type': 'thindielectric', 'int_ior': 1.5,
                       'specular_transmittance': (0.9, 0.8, 0.7)},
    'roughconductor': {'type': 'roughconductor', 'alpha_u': 0.1,
                       'alpha_v': 0.35, 'eta': (0.2, 0.9, 1.1),
                       'k': (3.9, 2.4, 2.1)},
    'roughdielectric': {'type': 'roughdielectric', 'alpha': 0.25,
                        'int_ior': 'bk7'},
    'plastic': {'type': 'plastic', 'diffuse_reflectance': (0.6, 0.3, 0.1),
                'int_ior': 1.6},
    'roughplastic': {'type': 'roughplastic', 'alpha': 0.2,
                     'diffuse_reflectance': (0.2, 0.5, 0.3)},
    'pplastic': {'type': 'pplastic', 'diffuse_reflectance': (0.5, 0.4, 0.2),
                 'specular_reflectance': (0.9, 0.9, 0.9)},
    'twosided': {'type': 'twosided',
                 'bsdf': {'type': 'roughplastic', 'alpha': 0.3}},
}


def _close(got, ref, name, atol=None, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, name
    if atol is None:
        atol = rtol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize('name', list(ROWS))
def test_pack_rows_match_reference(name):
    assert pbsdf.pack_params(ROWS[name]) == jbsdf.pack_params(ROWS[name])


def _tables(name, hemisphere, seed=0):
    """(reference scene, si, meta), (port scene, si, meta), wo, u1, u2 for
    ``N`` lanes of one packed row."""
    code, flags, row = jbsdf.pack_params(ROWS[name])
    rng = np.random.default_rng(seed)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)
    wi = unit(N)
    wi[:, 2] = np.abs(wi[:, 2]) * (1 if hemisphere == 'upper' else -1)
    wo = unit(N)
    u1 = rng.uniform(0, 1, N).astype(np.float32)
    u2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    meta = SimpleNamespace(bsdf_types=(code,))
    out = []
    for lib, arr in ((jnp, jnp.asarray), (torch, torch.from_numpy)):
        bsdfs = SimpleNamespace(type=arr(np.int32([code])),
                                flags=arr(np.int32([flags])),
                                params=arr(np.float32([row])))
        si = SimpleNamespace(wi=arr(wi), bsdf_idx=arr(np.zeros(N, np.int32)))
        out.append((SimpleNamespace(bsdfs=bsdfs), si, meta))
    return out, [(jnp.asarray(a), torch.from_numpy(a)) for a in (wo, u1, u2)]


@pytest.mark.parametrize('hemisphere', ['upper', 'lower'])
@pytest.mark.parametrize('name', list(ROWS))
def test_eval_pdf_sample_match_reference(name, hemisphere):
    ((sj, si_j, m), (sp, si_p, _)), ((wo_j, wo_p), (u1_j, u1_p),
                                     (u2_j, u2_p)) = _tables(name, hemisphere)
    _close(pbsdf.eval(sp, m, si_p, wo_p), jbsdf.eval(sj, m, si_j, wo_j),
           'eval')
    _close(pbsdf.pdf(sp, m, si_p, wo_p), jbsdf.pdf(sj, m, si_j, wo_j), 'pdf')
    for mode in (pbsdf.RADIANCE, pbsdf.IMPORTANCE):
        bs_p, w_p = pbsdf.sample(sp, m, si_p, u1_p, u2_p, mode)
        bs_j, w_j = jbsdf.sample(sj, m, si_j, u1_j, u2_j, mode)
        for f in ('delta', 'null'):
            assert (getattr(bs_p, f).numpy()
                    == np.asarray(getattr(bs_j, f))).all(), f
        # a direction is used only where its pdf is positive (the rough
        # lobes sample garbage from below, where pdf and weight are 0)
        live = np.asarray(bs_j.pdf) > 0
        assert (bs_p.pdf.numpy() > 0).tolist() == live.tolist()
        _close(bs_p.wo[torch.from_numpy(live)], np.asarray(bs_j.wo)[live],
               f'wo {mode}', DIR_ATOL)
        _close(bs_p.pdf, bs_j.pdf, f'pdf {mode}', rtol=SAMPLED_RTOL)
        _close(bs_p.eta, bs_j.eta, f'eta {mode}')
        _close(w_p, w_j, f'weight {mode}', rtol=SAMPLED_RTOL)
        assert np.isfinite(w_p.numpy()).all()


@pytest.mark.parametrize('change', [
    {'type': 'measured', 'filename': 'm.bsdf'},
    {'type': 'measured_polarized', 'filename': 'm.pbsdf'},
    {'type': 'mask', 'bsdf': {'type': 'measured', 'filename': 'm.bsdf'}},
    {'type': 'twosided', 'bsdf': {'type': 'measured_polarized',
                                  'filename': 'm.pbsdf'}},
])
def test_outside_the_slice_still_raises(change, tmp_path):
    """The measured BSDFs build and render from their files (slice 10);
    wrapped in ``mask`` or ``twosided`` they raise NotImplementedError, as
    the reference does (its ``pack_params`` packs no measured row)."""
    from mitsuba_nlvrl_tpu_torch.bsdf.measured import write_tensor_file
    write_tensor_file(str(tmp_path / 'm.bsdf'),
                      pscenes.measured_fields(res=8, n_theta=3))
    write_tensor_file(str(tmp_path / 'm.pbsdf'),
                      pscenes.measured_pol_fields())

    def located(b):
        b = dict(b)
        if 'filename' in b:
            b['filename'] = str(tmp_path / b['filename'])
        if 'bsdf' in b:
            b['bsdf'] = located(b['bsdf'])
        return b
    descs = [pkg.cornell_box(spp=1, res=8) for pkg in (pscenes, scenes)]
    for d in descs:
        d['shapes'][0]['bsdf'] = located(change)
    if change['type'] in ('mask', 'twosided'):
        for build in (lambda: P.build_scene(descs[0], device='cpu'),
                      lambda: J.build_scene(descs[1])):
            with pytest.raises(NotImplementedError, match='bsdf type'):
                build()
        return
    s, m = P.build_scene(descs[0], device='cpu')
    assert P.bsdf.BSDF_TYPES[change['type']] in m.bsdf_types
    img = P.render(s, m, seed=0)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.01


ITEM7_ROWS = [
    {'type': 'mask', 'opacity': 0.4, 'bsdf': {'type': 'diffuse'}},
    {'type': 'roughconductor', 'alpha': {'type': 'checkerboard',
                                         'color0': 0.1, 'color1': 0.4}},
    {'type': 'roughplastic', 'specular_reflectance': {
        'type': 'checkerboard', 'color0': 0.9, 'color1': 0.3}},
    {'type': 'plastic', 'diffuse_reflectance': {'type': 'checkerboard'}},
]


@pytest.mark.parametrize('change', ITEM7_ROWS)
def test_item7_rows_build_and_match(change):
    """A mask and textured alpha, specular and plastic diffuse parameters
    build, through the port's description and from the reference's
    arrays, and the 16x16, 2 spp render matches the reference's on every
    pixel (1e-3 relative), the rays within ``compare.RAYS_RTOL``."""
    d = scenes.cornell_box(spp=2, res=16)
    d['shapes'][0]['bsdf'] = change
    dp = pscenes.cornell_box(spp=2, res=16)
    dp['shapes'][0]['bsdf'] = change
    sj, mj, sp, mp = build_both(d)
    sq, _ = P.build_scene(dp, device='cpu')
    ref = scene_arrays(sj)
    for k, a in scene_arrays(sq).items():
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(ref[k], np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    stats = []
    with ieee_reference():
        img_j = np.asarray(J.render(sj, mj, seed=0, spp=2, ray_stats=stats,
                                    spp_per_dispatch=1))
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, 2)
    _check_pixels(img_p, img_j, rays_p, sum(float(r) for r in stats))


def test_mask_from_reference_arrays_raises():
    """A reference scene with a masked polarizer beside a measured BSDF
    (the measured row and its warps, slot 0, carried as arrays) builds
    from ``scene_from_numpy``: its arrays equal the port's own build of
    the same description, and it renders. (A mask around the measured
    BSDF itself raises in both packages:
    ``test_outside_the_slice_still_raises``.)"""
    from test_measured import _synth_fields
    descs = []
    for pkg in (scenes, pscenes):
        d = pkg.cornell_box(spp=1, res=8)
        d['shapes'][0]['bsdf'] = {'type': 'mask', 'opacity': 0.5,
                                  'bsdf': {'type': 'polarizer'}}
        d['shapes'][1]['bsdf'] = {'type': 'measured',
                                  '_fields': _synth_fields(res=8, n_theta=3)}
        descs.append(d)
    sj, mj = J.build_scene(descs[0])
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    assert len(sp.measured) == 1 and tuple(mp.measured_meta[0]) == \
        tuple(mj.measured_meta[0])
    sq, mq = P.build_scene(descs[1], device='cpu')
    assert mq == mp
    ref = scene_arrays(sj)
    for k, a in scene_arrays(sq).items():
        assert np.array_equal(np.asarray(a), np.asarray(ref[k])), k
    img = P.render(sp, mp, seed=0)
    assert bool(img.isfinite().all()) and float(img.mean()) > 0.01


def test_mask_from_reference_arrays_builds():
    d = scenes.cornell_box(spp=1, res=8)
    d['shapes'][0]['bsdf'] = {'type': 'mask', 'opacity': 0.5,
                              'bsdf': {'type': 'diffuse'}}
    sj, mj = J.build_scene(d)
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    assert (sp.bsdfs.flags[0] & 32) > 0 and float(sp.bsdfs.params[0, 14]) \
        == 0.5


def _materials_desc(pkg, tr_mod, **kw):
    res_w, res_h = kw.pop('res')
    d = pkg.cornell_box(spp=kw.pop('spp'), res=res_w, **kw)
    d['sensor']['film']['height'] = res_h
    return pscenes.dress_materials(d, tr_mod)


def test_materials_scene_builds_the_reference_arrays():
    """The port's ``cbox_materials`` builds the reference's arrays from
    the same description."""
    sj, _ = J.build_scene(_materials_desc(
        scenes, jtr, res=(16, 16), spp=4,
        integrator={'type': 'path', 'max_depth': 8}))
    sp, mp = P.build_scene(pscenes.cbox_materials(16, 16, 4), device='cpu')
    ref, got = scene_arrays(sj), scene_arrays(sp)
    for k, a in got.items():
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(ref[k], np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert {7, 8, 18, 5, 6, 3, 0} == set(mp.bsdf_types)


def _check_pixels(img_p, img_j, rays_p, rays_j):
    assert img_p.shape == img_j.shape
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())
    assert abs(rays_p - rays_j) <= compare.RAYS_RTOL * rays_j, (rays_p,
                                                               rays_j)
    assert img_p.mean() > 0.005


def test_materials_path_render_matches_reference():
    sj, mj, sp, mp = build_both(_materials_desc(
        scenes, jtr, res=(16, 16), spp=4,
        integrator={'type': 'path', 'max_depth': 8}))
    stats = []
    img_j = np.asarray(J.render(sj, mj, seed=0, spp=4, ray_stats=stats))
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, 4)
    _check_pixels(img_p, img_j, rays_p, sum(float(r) for r in stats))


PM_KNOBS = dict(global_photons=4096, volume_photons=4096, max_depth=6,
                light_depth_cap=6, max_cam_iters=4, gather_points_cap=4)


@functools.lru_cache(maxsize=None)
def _materials_pm_case():
    from mitsuba_nlvrl_tpu.render import preprocess
    integ = {'type': 'photonmapper', **PM_KNOBS}
    desc = _materials_desc(scenes, jtr, res=(16, 8), spp=2,
                           integrator=integ,
                           medium={'type': 'homogeneous', 'sigma_t': 0.5,
                                   'albedo': 0.8})
    sj, mj, sp, mp = build_both(desc)
    with ieee_reference():
        maps_j = preprocess(sj, mj, 0)
    maps_p = P.maps_from_numpy(scene_arrays(maps_j), device='cpu')
    return sj, mj, maps_j, sp, mp, maps_p


def test_materials_photonmapper_reaches_per_photon_gather():
    _, mj, _, _, mp, _ = _materials_pm_case()
    assert not pest._gather_diffuse_only(mp)
    from mitsuba_nlvrl_tpu.integrators import photon_est as jest
    assert not jest._gather_diffuse_only(mj)


def test_materials_photonmapper_render_matches_reference():
    """The port's camera passes on the reference's maps, carried over:
    every pixel within 1e-3 relative of the reference's."""
    sj, mj, maps_j, sp, mp, maps_p = _materials_pm_case()
    stats = []
    with ieee_reference():
        img_j = np.asarray(J.render(sj, mj, seed=0, spp=2, aux=maps_j,
                                    ray_stats=stats, spp_per_dispatch=1))
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, 2, maps_p)
    _check_pixels(img_p, img_j, rays_p, sum(float(r) for r in stats))
