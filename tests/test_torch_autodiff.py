"""The port's differentiable render against ``jax.grad`` of the reference.

The same inputs go through both packages: scenes built from the
reference's own arrays (``torch_parity.build_both``), cotangents from
numpy seeds. The reference runs under ``torch_parity.ieee_reference``
(IEEE rounding, as every parity test here); the port runs torch autograd
on the CPU. Both packages draw the same random numbers and take the same
decisions, so their gradients agree lane for lane. Each reference graph
is traced and compiled once (the lru_caches below): a differentiable
volumetric render costs the reference 20-80 s of XLA on an 8-core CPU,
so the walks of the ``volpath`` case run one tracking event a trip
(``WALK_UNROLL = 1`` in both packages, the reference's
``MNT_WALK_UNROLL`` knob; the estimator is the same, its draws come
per event instead of per eight).

Found at these sizes: the ``path`` images and gradients equal within
2e-8 absolute; the ``volpath`` image within 1e-7, its gradients within
1e-5 relative. The reference's reverse-mode gradient of ``media.params``
is NaN in some columns (sigma_t, scale and the bbox's y bounds): a
masked lane's infinite partial times the zero of ``jnp.maximum``'s
derivative (a product in JAX, a select in torch) and a zero direction
component's infinite slab distance. Its forward-mode derivative there is
finite and the port's gradient equals it, so those columns are held to
``jax.jvp``. Tolerances: images 1e-5 relative, gradients 1e-4 relative
plus 1e-6 (path) or 1e-5 (volpath) absolute.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu.medium as jmed
from mitsuba_nlvrl_tpu import autodiff as jad
from mitsuba_nlvrl_tpu.core import math as jm
from mitsuba_nlvrl_tpu.scene.vol_io import VolumeGrid

import mitsuba_nlvrl_tpu_torch.medium as pmed
from mitsuba_nlvrl_tpu_torch import autodiff as pad
from mitsuba_nlvrl_tpu_torch.core import math as pm_

import scenes
from torch_parity import build_both, ieee_jit, ieee_reference, two_pass_desc

RES = 4
DERIV_KEY = 0xDE21
# the media.params columns (sigma_t, scale, the bbox's y bounds) where the
# reference's reverse-mode gradient of the volpath box is NaN; they are
# held to its forward-mode derivative
NAN_COLUMNS = (0, 1, 2, 6, 9, 12)


def _gauss_medium():
    """The 8^3 heterogeneous medium of tests/test_autodiff.py."""
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, 8)] * 3, indexing='ij')
    g = (0.3 + 0.5 * np.exp(-2.0 * (xx ** 2 + yy ** 2 + zz ** 2))
         ).astype(np.float32)
    vg = VolumeGrid(data=g[..., None], bbox_min=np.float32([-0.95] * 3),
                    bbox_max=np.float32([0.95] * 3))
    return {'type': 'heterogeneous',
            'sigma_t': {'type': 'gridvolume', '_grid': vg},
            'albedo': 0.8, 'scale': 1.0}


def _desc(case):
    if case == 'volpath':
        return scenes.cornell_box(
            spp=1, res=RES, integrator={'type': 'volpath', 'max_depth': 3},
            medium=_gauss_medium())
    desc = scenes.cornell_box(spp=1, res=RES,
                              integrator={'type': 'path', 'max_depth': 3})
    desc['spectral'] = case == 'path_spectral'
    return desc


KEYS = {'path': ('bsdfs.params', 'emitters.params'),
        'path_spectral': ('bsdfs.params', 'emitters.params'),
        'volpath': ('media.params', 'media.grid_sigma_t')}


@contextlib.contextmanager
def _unroll(case):
    """One tracking event a walk trip in both packages (volpath only)."""
    if case != 'volpath':
        yield
        return
    saved = jmed.WALK_UNROLL, pmed.WALK_UNROLL
    jmed.WALK_UNROLL = pmed.WALK_UNROLL = 1
    try:
        yield
    finally:
        jmed.WALK_UNROLL, pmed.WALK_UNROLL = saved


def _cotangent(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (RES, RES, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _scenes(case):
    return build_both(_desc(case))


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's image and gradients of sum(image * W) w.r.t. the
    case's keys, at the key of seed 0 and at the unbiased mode's
    derivative key (one compiled graph, the key an argument)."""
    sj, mj, _, _ = _scenes(case)
    pm = jad.traverse(sj).keep(KEYS[case])
    W = jnp.asarray(_cotangent())

    def loss(params, key):
        img = jad.render(sj, mj, params=params, pmap=pm, spp=1, seed=key)
        return jnp.sum(img * W), img

    k0 = jax.random.PRNGKey(0)
    out = {}
    with _unroll(case), ieee_reference():
        f = ieee_jit(jax.value_and_grad(loss, has_aux=True))
        for name, key in (('primal', k0),
                          ('deriv', jax.random.fold_in(k0, DERIV_KEY))):
            (_, img), g = f(pm.to_dict(), key)
            out[name] = (np.asarray(img),
                         {k: np.asarray(v) for k, v in g.items()})
    return out


@functools.lru_cache(maxsize=None)
def _reference_linearized(case, cols):
    """The reference's image, reverse-mode gradients of sum(image * W) and
    forward-mode derivatives along the ``media.params`` columns ``cols``
    (row 0), from one linearization of the seed-0 render (one traced and
    compiled graph: ``jax.grad`` is the transpose of this linearization)."""
    sj, mj, _, _ = _scenes(case)
    pm = jad.traverse(sj).keep(KEYS[case])
    W = jnp.asarray(_cotangent())
    p0 = pm.to_dict()

    def loss(params):
        img = jad.render(sj, mj, params=params, pmap=pm, spp=1, seed=0)
        return jnp.sum(img * W), img

    def linearized(params, tangents):
        _, f_jvp, img = jax.linearize(loss, params, has_aux=True)
        grads, = jax.linear_transpose(f_jvp, params)(jnp.float32(1.0))
        zeros = {k: jnp.zeros_like(v) for k, v in params.items()}
        jvps = jax.vmap(lambda t: f_jvp({**zeros, 'media.params': t}))(
            tangents)
        return img, grads, jvps

    T = np.zeros((len(cols),) + p0['media.params'].shape, np.float32)
    for i, c in enumerate(cols):
        T[i, 0, c] = 1.0
    with _unroll(case), ieee_reference():
        img, grads, jvps = ieee_jit(linearized)(p0, jnp.asarray(T))
    return (np.asarray(img), {k: np.asarray(v) for k, v in grads.items()},
            np.asarray(jvps))


def _port(case, unbiased=False):
    """The port's image and gradients of sum(image * W)."""
    _, _, sp, mp = _scenes(case)
    pm = pad.traverse(sp).keep(KEYS[case])
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pm.to_dict().items()}
    with _unroll(case):
        img = pad.render(sp, mp, params=params, pmap=pm, spp=1, seed=0,
                         unbiased=unbiased)
        (img * torch.as_tensor(_cotangent())).sum().backward()
    return img.detach().numpy(), {k: v.grad.numpy()
                                  for k, v in params.items()}


def _check_grads(got, ref, atol):
    for k, r in ref.items():
        g = got[k]
        assert np.isfinite(g).all(), k
        ok = np.isfinite(r)
        np.testing.assert_allclose(g[ok], r[ok], rtol=1e-4, atol=atol,
                                   err_msg=k)


# --- the safe functions ----------------------------------------------------

ROOT_X = [-1.0, -1e-13, 0.0, 1e-13, 1e-12, 2e-12, 1e-6, 0.5, 4.0]
SINE_X = [-1.5, -1.0, -1.0 + 1e-7, -0.5, 0.0, 0.5, 1.0 - 1e-7, 1.0, 1.5]


@pytest.mark.parametrize('name,xs', [('safe_sqrt', ROOT_X),
                                     ('safe_rsqrt', ROOT_X),
                                     ('safe_acos', SINE_X),
                                     ('safe_asin', SINE_X)])
def test_safe_function_derivatives_match_reference(name, xs):
    """Value and derivative at and around the singular points, where both
    packages clamp the derivative to zero."""
    x = np.asarray(xs, np.float32)
    fj = getattr(jm, name)
    gj = np.asarray(jax.vmap(jax.grad(fj))(jnp.asarray(x)))
    t = torch.as_tensor(x).requires_grad_(True)
    y = getattr(pm_, name)(t)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(fj(x)),
                               rtol=1e-6)
    assert np.isfinite(t.grad.numpy()).all()
    np.testing.assert_allclose(t.grad.numpy(), gj, rtol=1e-6, atol=0)
    # the primal (no autograd) form is the same function
    np.testing.assert_array_equal(
        getattr(pm_, name)(torch.as_tensor(x)).numpy(),
        y.detach().numpy())


# --- whole renders ---------------------------------------------------------

def test_path_gradients_match_reference():
    """bsdfs.params and emitters.params through ``path`` (max_depth 3)."""
    img_j, g_j = _reference('path')['primal']
    img_p, g_p = _port('path')
    np.testing.assert_allclose(img_p, img_j, rtol=1e-5, atol=1e-7)
    _check_grads(g_p, g_j, 1e-6)
    assert all(np.abs(g).sum() > 0 for g in g_p.values())


def test_unbiased_mode_matches_reference():
    """``unbiased=True``: the value of the seed's render, the gradient of
    the render on the reference's ``fold_in(PRNGKey(seed), 0xDE21)``
    stream."""
    ref = _reference('path')
    img_p, g_p = _port('path', unbiased=True)
    np.testing.assert_allclose(img_p, ref['primal'][0], rtol=1e-5,
                               atol=1e-7)
    _check_grads(g_p, ref['deriv'][1], 1e-6)
    # the two streams differ: the derivative is not the primal's
    assert not np.allclose(ref['deriv'][1]['bsdfs.params'],
                           ref['primal'][1]['bsdfs.params'])


def test_volpath_gradients_match_reference():
    """media.params and media.grid_sigma_t through ``volpath`` on the
    heterogeneous box (the diff estimator: explicit emission walks,
    bounded walks and bounces). Where the reference's reverse-mode
    gradient is NaN, the port's equals its forward-mode derivative."""
    img_j, g_j, jvp_j = _reference_linearized('volpath', NAN_COLUMNS)
    img_p, g_p = _port('volpath')
    np.testing.assert_allclose(img_p, img_j, rtol=1e-5, atol=1e-6)
    _check_grads(g_p, g_j, 1e-5)
    nan_cols = np.flatnonzero(np.isnan(g_j['media.params'][0]))
    assert set(nan_cols) <= set(NAN_COLUMNS), nan_cols
    np.testing.assert_allclose(g_p['media.params'][0, list(NAN_COLUMNS)],
                               jvp_j, rtol=1e-4, atol=1e-5)
    assert (g_p['media.grid_sigma_t'] != 0).sum() > 10
    assert np.abs(g_p['media.params'][0, :3]).sum() > 0      # sigma_t


def test_path_spectral_gradients_match_reference():
    """The spectral path on the reference graph of its own variant (the
    polarized variant's graph costs the reference some 45 s of XLA, over
    this file's budget: ROADMAP, item 11)."""
    img_j, g_j = _reference('path_spectral')['primal']
    img_p, g_p = _port('path_spectral')
    scale = max(np.abs(img_j).max(), 1e-3)
    np.testing.assert_allclose(img_p, img_j, rtol=1e-4, atol=1e-5 * scale)
    _check_grads(g_p, g_j, 1e-5 * scale)
    assert np.abs(g_p['bsdfs.params']).sum() > 0


# --- the two-pass integrators ----------------------------------------------

@pytest.mark.parametrize('integrator', ['vrl', 'photonmapper'])
def test_two_pass_camera_pass_is_not_differentiable(integrator):
    """The reference's differentiable render of ``vrl`` and
    ``photonmapper`` fails (it hands the camera pass no maps, and the pass
    runs ``lax.while_loop``s, which reverse mode cannot go through); the
    port raises naming the reason, from its differentiable render and from
    its camera pass under autograd."""
    desc = two_pass_desc(scenes, integrator, 'homogeneous')
    sj, mj, sp, mp = build_both(desc)
    pj = jad.traverse(sj).keep(['bsdfs.params'])
    with pytest.raises(Exception):
        jax.grad(lambda p: jnp.mean(jad.render(
            sj, mj, params={'bsdfs.params': p}, pmap=pj)))(
                pj['bsdfs.params'])
    pp = pad.traverse(sp).keep(['bsdfs.params'])
    leaf = pp['bsdfs.params'].clone().requires_grad_(True)
    with pytest.raises(ValueError, match='cannot be differentiated'):
        pad.render(sp, mp, params={'bsdfs.params': leaf}, pmap=pp)
    import mitsuba_nlvrl_tpu_torch as P
    from mitsuba_nlvrl_tpu_torch.integrators import get_integrator
    from mitsuba_nlvrl_tpu_torch.core import rng
    from mitsuba_nlvrl_tpu_torch.core.ray import Ray
    from mitsuba_nlvrl_tpu_torch.core.rng import Sampler
    maps = P.preprocess(sp, mp, 0)
    o = torch.zeros((4, 3))
    ray = Ray(o, torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3), o[:, 0],
              o[:, 0] + 10.0)
    scene = sp._replace(bsdfs=sp.bsdfs._replace(params=leaf))
    with pytest.raises(ValueError, match='reverse-mode'):
        get_integrator(integrator)(scene, mp, Sampler.make(
            rng.PRNGKey(0), 4), ray, aux=maps)


def _leaves(prefix, node, out):
    """{dotted path: array} of a record of either package (as
    ``torch_parity.scene_arrays``, without converting the arrays)."""
    if hasattr(node, '_fields'):
        for f in node._fields:
            _leaves(f'{prefix}.{f}' if prefix else f, getattr(node, f), out)
    elif isinstance(node, tuple):
        for i, x in enumerate(node):
            _leaves(f'{prefix}.{i}', x, out)
    elif hasattr(node, 'shape'):
        out[prefix] = node
    return out


def test_light_pass_gradient_matches_reference():
    """The light pass is differentiable in both packages: the photon and
    VRL maps' gradient w.r.t. bsdfs.params (a seeded cotangent on every
    floating-point map array)."""
    from mitsuba_nlvrl_tpu.render import preprocess as jpre
    import mitsuba_nlvrl_tpu_torch as P
    sj, mj, sp, mp = build_both(two_pass_desc(scenes, 'vrl',
                                              'homogeneous'))
    leaf = sp.bsdfs.params.clone().requires_grad_(True)
    maps_p = _leaves('', P.preprocess(
        sp._replace(bsdfs=sp.bsdfs._replace(params=leaf)), mp, 0), {})
    rng = np.random.default_rng(7)
    W = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
         for k, v in sorted(maps_p.items()) if v.is_floating_point()}
    sum((maps_p[k] * torch.as_tensor(W[k])).sum() for k in W).backward()
    g_p = leaf.grad.numpy()

    pj = jad.traverse(sj).keep(['bsdfs.params'])

    def jloss(p):
        maps = _leaves('', jpre(pj.updated_scene({'bsdfs.params': p}), mj,
                                0), {})
        return sum(jnp.sum(maps[k] * W[k]) for k in W)

    with ieee_reference(nested=True):
        g_j = np.asarray(ieee_jit(jax.grad(jloss))(pj['bsdfs.params']))
    assert np.isfinite(g_p).all() and np.abs(g_p).sum() > 0
    np.testing.assert_allclose(g_p, g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())
