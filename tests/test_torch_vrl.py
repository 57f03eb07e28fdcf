"""The port's VRL integrator against the reference's, lane by lane on
the reference's own maps (carried over with ``maps_from_numpy``): the VRL
clusters, the photon estimates, the cluster draw, one VRL's contribution
and the VRL query, in a homogeneous box (anisotropic phase) and in the
nonlinear box of ``cbox_nlvrl`` (its 640-cell IOR grid and laser); whole
``vrl`` renders of both boxes, 16x8 at 2 spp; and which options of
ROADMAP item 9 build (tests/test_torch_vrl_options.py holds them against
the reference).

The reference runs with IEEE rounding (``torch_parity.ieee_reference``):
the camera rays bend in the nonlinear medium and turn on the last bit at
every total internal reflection. Found at these sizes (the knobs of
``torch_parity.TWO_PASS_KNOBS``):
  * the clusters' integer tables equal and their floats within 1e-5; the
    estimates, the draws, the contributions and the queries within 1e-4
    relative on every one of 256 lanes (the reference's cumulative sums
    and transcendental functions round otherwise than torch's in the last
    bit; no lane chose another cluster or VRL);
  * the renders on the reference's maps, carried over: every pixel within
    1e-3 relative (the worst 6e-8 absolute) and the ray counts equal;
  * the renders on the port's own light pass (both packages shoot the
    same paths; the nonlinear box's maps differ where a total internal
    reflection after a scatter flips): the golden suite's z-test on every
    pixel, the means within 1e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu.core.ray import Ray as JRay
from mitsuba_nlvrl_tpu.core.rng import Sampler as JSampler
from mitsuba_nlvrl_tpu.integrators import photon_est as jest
from mitsuba_nlvrl_tpu.integrators import vrl as jvrl
from mitsuba_nlvrl_tpu.ops import intersect as jisect
from mitsuba_nlvrl_tpu_torch.core import rng
from mitsuba_nlvrl_tpu_torch.core.ray import Ray as PRay
from mitsuba_nlvrl_tpu_torch.core.rng import Sampler as PSampler
from mitsuba_nlvrl_tpu_torch.integrators import photon_est as pest
from mitsuba_nlvrl_tpu_torch.integrators import vrl as pvrl
from mitsuba_nlvrl_tpu_torch.ops import intersect as pisect
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import (check_render_on_reference_maps,
                          check_render_own_light_pass, jax_meta_dict,
                          scene_arrays, two_pass_case)

LANE_RTOL = 1e-4
SPP = 2
MEDIA = ['homogeneous', 'nonlinear']


def _lanes(a, b, name, rtol=LANE_RTOL):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, name
    if a.dtype.kind in 'biu':
        assert (a == b).all(), name
        return
    scale = max(float(np.abs(a).max()), 1e-30)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * 1e-3 * scale,
                               err_msg=name)


@pytest.mark.parametrize('medium', MEDIA)
def test_build_vrl_clusters_matches_reference(medium):
    _, _, maps_j, sp, _, maps_p = two_pass_case('vrl', medium)
    got = pvrl.build_vrl_clusters(sp, maps_p, 1024)
    ref = maps_j.clusters
    M = got.rows.shape[1] // 5
    assert (got.c_lum.shape[0], got.s_lum.shape[1], M) == (4, 16, 4)
    for f in pvrl.VRLClusters._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        if f == 'rows':
            assert (a[:, 4 * M:] == b[:, 4 * M:]).all()     # member ids
            a, b = a[:, :4 * M], b[:, :4 * M]
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7, err_msg=f)


def _segments(seed, N=256):
    """Camera segments inside the medium cube, as numpy."""
    r = np.random.default_rng(seed)
    o = r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = r.uniform(0.05, 1.0, N).astype(np.float32)
    return o, d, length, r


@pytest.mark.parametrize('medium', MEDIA)
def test_photon_estimates_match_reference(medium):
    sj, mj, maps_j, sp, mp, maps_p = two_pass_case('vrl', medium)
    o, d, _, r = _segments(1)
    N = o.shape[0]
    mint = np.zeros(N, np.float32)
    maxt = np.full(N, np.inf, np.float32)
    si_j = jisect.ray_intersect(sj, JRay(*(jnp.asarray(x)
                                           for x in (o, d, mint, maxt))))
    si_p = pisect.ray_intersect(sp, PRay(*(torch.as_tensor(x)
                                           for x in (o, d, mint, maxt))))
    act = r.random(N) > 0.1
    sr = float(pvrl.scene_radius_of(sp))
    for caustic, rel in ((True, 0.0125), (False, 0.05)):
        radius = np.float32(rel * sr)
        a = jest.estimate_surface(sj, mj, maps_j, si_j, jnp.asarray(act),
                                  jnp.float32(radius), caustic)
        b = pest.estimate_surface(sp, mp, maps_p, si_p, torch.as_tensor(act),
                                  torch.tensor(radius), caustic)
        _lanes(a, b, f'surface caustic={caustic}')
    # volume photons gathered at points of the (photon-dense) first
    # segments with jittered radii, as the camera pass gathers them
    x = (o + d * r.uniform(0, 0.3, (N, 1))).astype(np.float32)
    wo = -d
    radius = np.float32(0.005 * sr) * (0.75 + 0.5 * r.random(N)).astype(
        np.float32)
    midx = np.zeros(N, np.int32)
    a = jest.estimate_volume(sj, mj, maps_j, jnp.asarray(x), jnp.asarray(wo),
                             jnp.asarray(midx), jnp.asarray(act),
                             jnp.asarray(radius))
    b = pest.estimate_volume(sp, mp, maps_p, torch.as_tensor(x),
                             torch.as_tensor(wo), torch.as_tensor(midx),
                             torch.as_tensor(act), torch.as_tensor(radius))
    _lanes(a, b, 'volume')


@pytest.mark.parametrize('medium', MEDIA)
def test_cluster_draw_and_contribution_match_reference(medium):
    sj, mj, maps_j, sp, mp, maps_p = two_pass_case('vrl', medium)
    o, d, length, r = _segments(2)
    N = o.shape[0]
    u = r.random((5, N)).astype(np.float32)
    V = int(maps_p.vrl_o.shape[0])
    cam = np.zeros(N, np.int32)
    sig_j = jvrl._sigma_min_bound(sj, mj, jnp.asarray(cam))
    sig_p = pvrl._sigma_min_bound(sp, mp, torch.as_tensor(cam))
    _lanes(sig_j, sig_p, 'sigma_min')
    w_j = jvrl._cluster_weights(maps_j.clusters, *(jnp.asarray(x)
                                                   for x in (o, d, length)),
                                sig_j)
    w_p = pvrl._cluster_weights(maps_p.clusters, *(torch.as_tensor(x)
                                                   for x in (o, d, length)),
                                sig_p)
    _lanes(w_j, w_p, 'coarse weights')
    a = jvrl.sample_cluster_vrl(
        maps_j.clusters, w_j, jnp.cumsum(w_j, axis=1),
        *(jnp.asarray(x) for x in (o, d, length, u[0], u[1], u[2])), V,
        sig_j)
    b = pvrl.sample_cluster_vrl(
        maps_p.clusters, w_p, torch.cumsum(w_p, dim=1),
        *(torch.as_tensor(x) for x in (o, d, length, u[0], u[1], u[2])), V,
        sig_p)
    for x, y, name in zip(a, b, ('vi', 'inv_pdf', 'ok')):
        _lanes(x, y, name)
    assert bool(b[2].any())
    channel = (u[3] * 3).astype(np.int32).clip(0, 2)
    act = np.asarray(a[2])
    c_j, s_j = jvrl.vrl_contrib(
        sj, mj, maps_j, *(jnp.asarray(x) for x in (o, d, length, cam)),
        a[0], jnp.asarray(u[3]), jnp.asarray(u[4]), jnp.asarray(channel),
        JSampler.make(jax.random.PRNGKey(5), N), jnp.asarray(act))
    c_p, s_p = pvrl.vrl_contrib(
        sp, mp, maps_p, *(torch.as_tensor(x) for x in (o, d, length, cam)),
        b[0], torch.as_tensor(u[3]), torch.as_tensor(u[4]),
        torch.as_tensor(channel), PSampler.make(rng.PRNGKey(5), N),
        torch.as_tensor(act))
    _lanes(c_j, c_p, 'contribution')
    assert float(c_p.abs().max()) > 0
    assert int(s_j.dim) == s_p.dim


@pytest.mark.parametrize('strategy', ['cluster', 'uniform'])
@pytest.mark.parametrize('medium', MEDIA)
def test_query_vrls_matches_reference(medium, strategy):
    sj, mj, maps_j, sp, mp, maps_p = two_pass_case('vrl', medium)
    o, d, length, r = _segments(3)
    N = o.shape[0]
    cam = np.zeros(N, np.int32)
    channel = r.integers(0, 3, N).astype(np.int32)
    act = r.random(N) > 0.1
    q_j, s_j = jvrl.query_vrls(
        sj, mj, maps_j, *(jnp.asarray(x) for x in (o, d, length, cam,
                                                   channel)),
        JSampler.make(jax.random.PRNGKey(9), N), jnp.asarray(act), 2,
        strategy=strategy)
    q_p, s_p = pvrl.query_vrls(
        sp, mp, maps_p, *(torch.as_tensor(x) for x in (o, d, length, cam,
                                                       channel)),
        PSampler.make(rng.PRNGKey(9), N), torch.as_tensor(act), 2,
        strategy=strategy)
    _lanes(q_j, q_p, 'query')
    assert float(q_p.abs().max()) > 0
    assert int(s_j.dim) == s_p.dim


@pytest.mark.parametrize('medium', MEDIA)
def test_render_on_reference_maps_matches_reference(medium):
    check_render_on_reference_maps('vrl', medium, SPP)


@pytest.mark.parametrize('medium', MEDIA)
def test_render_own_light_pass_matches_reference(medium):
    check_render_own_light_pass('vrl', medium, SPP)


ITEM9_VALUES = {'vrl_ris': True, 'rr_vrl': True, 'vrl_aniso_cdf': True,
                'dice_vrl': 3, 'long_vrl': True, 'use_bre': True,
                'map_psum_axis': 'mp'}


@pytest.mark.parametrize('integrator', ['vrl', 'photonmapper'])
@pytest.mark.parametrize('prop', list(ITEM9_VALUES))
def test_deferred_properties_raise(prop, integrator):
    """The options of ROADMAP item 9 and ``map_psum_axis`` (the map
    all-reduce across ranks, item 12) build, from the port's builder and
    from a reference scene carried over; none raises any more."""
    def desc(pkg):
        d = pscenes.cornell_box(spp=1, res=8, medium=dict(
            pscenes.NLVRL_MEDIUM)) if pkg is pscenes else \
            scenes.cornell_box(spp=1, res=8,
                               medium=dict(pscenes.NLVRL_MEDIUM))
        d['integrator'] = {'type': integrator, prop: ITEM9_VALUES[prop]}
        return d
    sj, mj = J.build_scene(desc(scenes))
    _, mp = P.build_scene(desc(pscenes), device='cpu')
    assert mp.iprop(prop) == ITEM9_VALUES[prop]
    _, mc = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                               device='cpu')
    assert mc.iprop(prop) == mj.iprop(prop) == ITEM9_VALUES[prop]
    # the option at its default builds
    d = desc(pscenes)
    d['integrator'][prop] = None if prop == 'map_psum_axis' else \
        (1 if prop == 'dice_vrl' else False)
    P.build_scene(d, device='cpu')
