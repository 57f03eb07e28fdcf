"""Reverse-mode gradients of ``bsdfs.params`` through the microfacet and
plastic BSDFs, the port against the reference's linearization.

Two boxes at 8x8, 1 spp, ``path`` with max_depth 3: the materials box
(``roughconductor``, ``roughdielectric``, ``roughplastic``, ``plastic``
and ``pplastic`` beside ``twosided`` diffuse and ``thindielectric``;
every row takes a gradient at this size) and the S1 component of the
polarized box under ``stokes`` (``pplastic``, ``roughconductor``, the
polarizers, ``dielectric``, ``conductor``). The masked type dispatch
evaluates every type on every lane and selects; a masked lane's zero
cotangent then meets an infinite factor, so the reference's ``jax.grad``
is NaN in a third of the entries, where its forward mode is finite. The
port's gradient is finite everywhere and is held, entry by entry, to the
reference's linearization: one JVP along each entry of
``bsdfs.params`` (the transpose of the same linear map is ``jax.grad``,
equal to it wherever that is finite; its graph costs the reference
twice the XLA time of the JVPs' and is not built here).

Each reference graph is traced and compiled once. Tolerances: images
1e-5 relative (1e-7 absolute), gradients 1e-4 relative plus 1e-6 of the
image's scale absolute."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu import autodiff as jad
from mitsuba_nlvrl_tpu.core import transform as jtr

from mitsuba_nlvrl_tpu_torch import autodiff as pad
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import build_both, ieee_jit, ieee_reference

RES = 8
KEY = 'bsdfs.params'


def _desc(case):
    if case == 'materials':
        d = scenes.cornell_box(spp=1, res=RES, integrator={
            'type': 'path', 'max_depth': 3})
        return pscenes.dress_materials(d, jtr)
    d = scenes.cornell_box(spp=1, res=RES,
                           integrator=pscenes.stokes_integrator(1, 3))
    return pscenes.dress_polarized(d, jtr)


@functools.lru_cache(maxsize=None)
def _case(case):
    """The reference's image and the forward-mode derivative of sum(image
    * W) along every entry of bsdfs.params, from one linearization; the
    port's scene and meta."""
    sj, mj, sp, mp = build_both(_desc(case))
    pm = jad.traverse(sj).keep([KEY])
    p0 = pm.to_dict()
    W = jnp.asarray(_cotangent())

    def loss(params):
        img = jad.render(sj, mj, params=params, pmap=pm, spp=1, seed=0)
        return jnp.sum(img * W), img

    def linearized(params):
        _, f_jvp, img = jax.linearize(loss, params, has_aux=True)
        shape = params[KEY].shape
        eye = jnp.eye(int(np.prod(shape)), dtype=jnp.float32).reshape(
            (-1,) + shape)
        return img, jax.vmap(lambda t: f_jvp({KEY: t}))(eye).reshape(shape)

    with ieee_reference():
        img, jvp = ieee_jit(linearized)(p0)
    return np.asarray(img), np.asarray(jvp), sp, mp


def _cotangent():
    return np.random.default_rng(7).standard_normal(
        (RES, RES, 3)).astype(np.float32)


def _port(case):
    sp, mp = _case(case)[2:]
    pm = pad.traverse(sp).keep([KEY])
    leaf = pm[KEY].detach().clone().requires_grad_(True)
    img = pad.render(sp, mp, params={KEY: leaf}, pmap=pm, spp=1, seed=0)
    (img * torch.as_tensor(_cotangent())).sum().backward()
    return img.detach().numpy(), leaf.grad.numpy()


@pytest.mark.parametrize('case', ['materials', 'stokes_s1'])
def test_bsdf_params_gradient_is_finite_and_matches_reference(case):
    img_j, jvp_j, sp, _ = _case(case)
    img_p, grad_p = _port(case)
    scale = max(float(np.abs(img_j).max()), 1e-3)
    np.testing.assert_allclose(img_p, img_j, rtol=1e-5, atol=1e-7)
    assert np.isfinite(grad_p).all(), int((~np.isfinite(grad_p)).sum())
    assert np.isfinite(jvp_j).all()
    np.testing.assert_allclose(grad_p, jvp_j, rtol=1e-4, atol=1e-6 * scale)
    # the gradient reaches the plastic rows (and at this size, on the
    # materials box, every row)
    types = np.asarray(sp.bsdfs.type)
    moved = np.abs(grad_p).sum(axis=1) > 0
    assert moved[types == 18].all(), (types, moved)     # pplastic
    if case == 'materials':
        assert moved.all(), (types, moved)
