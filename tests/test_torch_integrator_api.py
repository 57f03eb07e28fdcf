"""The integrator API through the port against the reference on the CPU:
``render``, ``render_pass`` and ``preprocess`` with ``integrator=`` (the
scene rendered with another integrator than its own), and
``integrators.register`` (a user's integrator named by a scene, with and
without a preprocess), which the builder accepts once it is registered.

References under ``ieee_reference`` with one pass a dispatch.
Tolerance: every pixel within 1e-6 relative (1e-7 absolute; a depth is
one intersection's t), the ray counts equal."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
from mitsuba_nlvrl_tpu import integrators as jintegrators
from mitsuba_nlvrl_tpu.integrators import depth as jdepth

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch import integrators as pintegrators
from mitsuba_nlvrl_tpu_torch.core import rng as prng
from mitsuba_nlvrl_tpu_torch.integrators import depth as pdepth

import scenes
from torch_parity import build_both, ieee_reference, two_pass_desc

RES, SPP = 8, 2
# the reference's render module (the package exports its render function
# under the module's name)
jrender_mod = importlib.import_module('mitsuba_nlvrl_tpu.render')


def _close(img_p, img_j):
    img_p, img_j = np.asarray(img_p), np.asarray(img_j)
    assert img_p.shape == img_j.shape
    close = np.abs(img_p - img_j) <= 1e-6 * np.abs(img_j) + 1e-7
    assert close.all(), float(np.abs(img_p - img_j).max())


def _path_box():
    return scenes.cornell_box(spp=SPP, res=RES, integrator={
        'type': 'path', 'max_depth': 4})


@functools.lru_cache(maxsize=None)
def _depth_case():
    """The box built for ``path``, rendered by both packages with
    ``integrator='depth'``; the reference's image and one pass."""
    sj, mj, sp, mp = build_both(_path_box())
    with ieee_reference():
        img = np.asarray(J.render(sj, mj, seed=0, spp=SPP,
                                  integrator='depth', spp_per_dispatch=1))
        acc, rays = jrender_mod.render_pass(
            sj, mj, jax.random.fold_in(jax.random.PRNGKey(0), 1), 'depth',
            None, jnp.uint32(1))
    return sp, mp, img, np.asarray(acc), float(rays)


def test_render_with_integrator_keyword_matches_reference():
    sp, mp, img_j, _, _ = _depth_case()
    assert mp.integrator == 'path'
    img_p = P.render(sp, mp, seed=0, spp=SPP, integrator='depth')
    _close(img_p, img_j)
    assert float(img_p.max()) > 1.0     # depths, not radiance
    # the same as the box built for depth
    sd, md = P.build_scene(scenes.cornell_box(spp=SPP, res=RES, integrator={
        'type': 'depth'}), device='cpu')
    assert torch.equal(img_p, P.render(sd, md, seed=0, spp=SPP))
    assert not torch.equal(img_p, P.render(sp, mp, seed=0, spp=SPP))


def test_render_pass_with_integrator_keyword_matches_reference():
    sp, mp, _, acc_j, rays_j = _depth_case()
    acc_p, rays_p = P.render_pass(sp, mp, prng.fold_in(prng.PRNGKey(0), 1),
                                  1, integrator='depth')
    _close(acc_p, acc_j)
    assert float(rays_p) == rays_j


def test_preprocess_with_integrator_keyword():
    """A ``moment``-wrapped photon mapper: ``integrator=`` naming a
    one-pass integrator has no preprocess in either package, and naming
    another wrapper unwraps to the same photon mapper, whose maps equal
    the scene's own (held to the reference's in test_torch_aov.py)."""
    desc = two_pass_desc(scenes, 'photonmapper', 'homogeneous')
    desc['integrator'] = {'type': 'moment', 'integrator': desc['integrator']}
    sj, mj, sp, mp = build_both(desc)
    for name in ('depth', 'path', 'volpath'):
        assert jrender_mod.preprocess(sj, mj, 0, integrator=name) is None
        assert P.preprocess(sp, mp, 0, integrator=name) is None
    own = P.maps_to_numpy(P.preprocess(sp, mp, 0))
    via = P.maps_to_numpy(P.preprocess(sp, mp, 0, integrator='stokes'))
    assert own.keys() == via.keys() and len(own) > 0
    for k in own:
        assert np.array_equal(own[k], via[k], equal_nan=True), k


def _halved_depth(pkg_depth, with_preprocess):
    """A user's integrator: half the depth; with a preprocess, a pass
    also adds the maps that its preprocess made (all zeros)."""
    def sample(scene, meta, sampler, ray, active=None, diff=False,
               aux=None):
        assert (aux is not None) == with_preprocess
        L, valid, sampler = pkg_depth.sample(scene, meta, sampler, ray,
                                             active=active, diff=diff)
        return L * 0.5 + (aux[0] if with_preprocess else 0.0), valid, \
            sampler
    return sample


@pytest.mark.parametrize('with_preprocess', [False, True])
def test_registered_integrator_matches_reference(with_preprocess):
    """A scene names a registered integrator; both packages render it
    alike, and its preprocess (where it has one) hands every pass its
    result. Before registration the port's builder refuses the name with
    the reference's KeyError."""
    name = f'halved_depth_{int(with_preprocess)}'
    desc = scenes.cornell_box(spp=SPP, res=RES, integrator={'type': name})
    with pytest.raises(KeyError, match=f"unknown integrator '{name}'"):
        P.build_scene(desc, device='cpu')
    seen = []

    def preprocess(zeros):
        def pre(scene, meta, key):
            seen.append(meta.integrator)
            return zeros(1)
        return {'preprocess': pre} if with_preprocess else {}
    jintegrators.register(name, _halved_depth(jdepth, with_preprocess),
                          **preprocess(jnp.zeros))
    pintegrators.register(name, _halved_depth(pdepth, with_preprocess),
                          **preprocess(torch.zeros))
    try:
        sj, mj, sp, mp = build_both(desc)
        with ieee_reference():
            img_j = np.asarray(J.render(sj, mj, seed=0, spp=SPP,
                                        spp_per_dispatch=1))
        sb, mb = P.build_scene(desc, device='cpu')
        img_p = P.render(sp, mp, seed=0, spp=SPP)
        _close(img_p, img_j)
        assert torch.equal(img_p, P.render(sb, mb, seed=0, spp=SPP))
        assert seen == ([name] * 3 if with_preprocess else [])
        depth = P.render(sp, mp, seed=0, spp=SPP, integrator='depth')
        assert torch.equal(img_p, depth * 0.5)
    finally:
        for reg in (jintegrators, pintegrators):
            reg._REGISTRY.pop(name, None)
            reg._PREPROCESS.pop(name, None)
