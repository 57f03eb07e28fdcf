"""The wrapper integrators ``aov`` and ``moment`` through the port against
the reference on the CPU: the geometric AOVs, ``moment`` around
``path``, and a ``moment``-wrapped ``photonmapper``, whose preprocess
(the photon shooting) runs as the wrapped integrator's.

References under ``ieee_reference`` with one pass a dispatch; the AOV
images of every kind come from one compiled pass (the reference's pass
keys, sensor rays and film splat). Tolerance: every pixel within 1e-3
relative (1e-6 absolute), the ray counts equal."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mitsuba_nlvrl_tpu as J
from mitsuba_nlvrl_tpu import film as jfilm, sensor as jsensor
from mitsuba_nlvrl_tpu.core.rng import Sampler as JSampler
from mitsuba_nlvrl_tpu.integrators import aov as jaov
from mitsuba_nlvrl_tpu.integrators.common import film_sample_positions

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch.testing import compare

import scenes
from torch_parity import build_both, ieee_jit, ieee_reference, two_pass_case

RES, SPP = 16, 2
KINDS = ('depth', 'sh_normal', 'geo_normal', 'position', 'uv',
         'prim_index', 'shape_index')


def _close(img_p, img_j):
    close = np.abs(img_p - img_j) <= 1e-3 * np.abs(img_j) + 1e-6
    assert close.all(), float(np.abs(img_p - img_j).max())


def _with_aov(meta, kind):
    return dataclasses.replace(meta, integrator_props=(('aovs',
                                                        f'x:{kind}'),))


@functools.lru_cache(maxsize=None)
def _aov_case():
    """The box (a sphere in it) under ``aov`` and the reference's image of
    every kind."""
    desc = scenes.cornell_box(spp=SPP, res=RES, integrator={'type': 'aov'})
    desc['shapes'].append({'type': 'sphere', 'center': (0.3, -0.5, 0.2),
                           'radius': 0.35,
                           'bsdf': {'type': 'diffuse', 'reflectance': 0.5}})
    sj, mj, sp, mp = build_both(desc)
    N = RES * RES

    def one_pass(scene, key, p):
        pos_key, samp_key = jax.random.split(key)
        pos, pos01 = film_sample_positions(mj, pos_key, p)
        ray, sw = jsensor.sample_ray(
            scene, mj, pos01,
            jax.random.uniform(jax.random.fold_in(pos_key, 1), (N, 2)))
        jit = pos - jnp.floor(pos)
        imgs = []
        for kind in KINDS:
            L, _, _ = jaov.sample_aov(scene, _with_aov(mj, kind),
                                      JSampler.make(samp_key, N), ray)
            imgs.append(jfilm.splat_pixel_ordered(
                mj.film, jit, L * sw, jfilm.new_image(mj.film)))
        return jnp.stack(imgs)

    acc = 0.0
    with ieee_reference():
        f = ieee_jit(one_pass)
        for p in range(SPP):
            acc = acc + np.asarray(f(sj, jax.random.fold_in(
                jax.random.PRNGKey(0), p), jnp.uint32(p)))
    images = {k: np.asarray(jfilm.develop(a)) for k, a in zip(KINDS, acc)}
    return sp, mp, images


@pytest.mark.parametrize('kind', KINDS)
def test_aov_matches_reference(kind):
    sp, mp, images = _aov_case()
    img_p, _, rays = compare.render_with_passes(sp, _with_aov(mp, kind), 0,
                                                SPP)
    _close(img_p, images[kind])
    assert rays == 0            # aov traces no counted rays
    assert np.abs(img_p).max() > 0


@functools.lru_cache(maxsize=None)
def _moment_reference():
    desc = scenes.cornell_box(spp=SPP, res=RES, integrator={
        'type': 'moment', 'integrator': {'type': 'path', 'max_depth': 5}})
    sj, mj, sp, mp = build_both(desc)
    stats = []
    with ieee_reference():
        img = np.asarray(J.render(sj, mj, seed=0, spp=SPP, ray_stats=stats,
                                  spp_per_dispatch=1))
    return sp, mp, img, sum(float(r) for r in stats)


def test_moment_around_path_matches_reference():
    sp, mp, img_j, rays_j = _moment_reference()
    assert mp.integrator == 'moment'
    img_p, _, rays_p = compare.render_with_passes(sp, mp, 0, SPP)
    _close(img_p, img_j)
    assert rays_p == rays_j and img_p.mean() > 0.05


def test_moment_wrapped_photonmapper_runs_its_preprocess():
    """``moment`` around ``photonmapper``: the port's ``preprocess`` shoots
    the wrapped integrator's photons (its maps equal the plain
    integrator's), and its camera passes on the reference's maps match the
    reference's ``moment`` render."""
    sj, mj, maps_j, sp, mp, maps_p = two_pass_case('photonmapper',
                                                   'homogeneous')

    def wrapped(meta):
        return dataclasses.replace(
            meta, integrator='moment', integrator_props=(
                ('integrator', (('type', 'photonmapper'),)
                 + tuple(meta.integrator_props)),))
    mj_m, mp_m = wrapped(mj), wrapped(mp)
    own = P.maps_to_numpy(P.preprocess(sp, mp_m, 0))
    plain = P.maps_to_numpy(P.preprocess(sp, mp, 0))
    assert set(own) == set(plain) and len(own) > 3
    for k in own:
        assert np.array_equal(own[k], plain[k]), k
    stats = []
    with ieee_reference():
        img_j = np.asarray(J.render(sj, mj_m, seed=0, spp=SPP, aux=maps_j,
                                    ray_stats=stats, spp_per_dispatch=1))
    img_p, _, rays_p = compare.render_with_passes(sp, mp_m, 0, SPP, maps_p)
    _close(img_p, img_j)
    assert rays_p == sum(float(r) for r in stats)
    assert img_p.mean() > 0.0
