"""The port's autodiff API against the reference's (the non-chi2 cases of
tests/test_api.py, and the parts the differentiable render rests on):
``traverse``/``ParameterMap`` and its key map, the optimizers against
``optax`` fed the same gradients, ``with_sigma_grid``, the scatter
``film.splat`` for every filter, ``render_torch`` and the inverse-rendering
loop. Tolerances: optimizer trajectories and the splat within 1e-6
relative (float32 rounding of the same formulas), derived grid arrays
exactly, gradients of ``render_torch`` exactly (the same computation).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mitsuba_nlvrl_tpu as J
from mitsuba_nlvrl_tpu import autodiff as jad
from mitsuba_nlvrl_tpu import film as jfilm
from mitsuba_nlvrl_tpu import medium as jmed
from mitsuba_nlvrl_tpu.scene.types import FilmMeta as JFilmMeta

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu_torch import autodiff as pad
from mitsuba_nlvrl_tpu_torch import film as pfilm
from mitsuba_nlvrl_tpu_torch import medium as pmed
from mitsuba_nlvrl_tpu_torch.core import counters
from mitsuba_nlvrl_tpu_torch.integrators.regen import regen_supported
from mitsuba_nlvrl_tpu_torch.scene.types import FilmMeta as PFilmMeta
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

import scenes
from torch_parity import build_both, jax_meta_dict, scene_arrays

torch.set_num_threads(1)   # one intra-op thread a test worker


def test_traverse_parameter_map():
    scene, meta = P.build_scene(scenes.cornell_box(spp=1, res=8),
                                device='cpu')
    pm = pad.traverse(scene)
    assert 'bsdfs.params' in pm.keys()
    assert set(pm.keys()) == set(jad._DIFF_LEAVES)
    ref = pm['bsdfs.params'].clone()
    pm['bsdfs.params'] = ref * 0.5
    assert torch.equal(pm.scene.bsdfs.params, ref * 0.5)
    assert pm.keep(['bsdfs.params', 'media.params']).keys() == [
        'bsdfs.params', 'media.params']


def test_reference_parameter_map_loads_key_for_key():
    """A reference ``ParameterMap.to_dict()`` as numpy arrays loads into
    the port's map through ``scene_from_numpy``, key for key; a new
    density grid refreshes its derived arrays as the reference's does."""
    desc = scenes.cornell_box(spp=1, res=8, medium=pscenes.hetvol_medium(
        grid_res=16, seed=0, scale=20.0),
        integrator={'type': 'volpath'})
    sj, mj = J.build_scene(desc)
    pj = jad.traverse(sj)
    values = {k: np.asarray(v) * 0.5 for k, v in pj.to_dict().items()}
    sp, _ = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                               device='cpu', params=values)
    got = pad.traverse(sp).to_dict()
    assert list(got) == list(values)
    for k, v in values.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    ref = jmed.with_sigma_grid(sj.media, values['media.grid_sigma_t'])
    for f in ('grid_sup', 'grid_sup_min', 'grid_sigma_p8'):
        np.testing.assert_array_equal(getattr(sp.media, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    with pytest.raises(KeyError):
        P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                           device='cpu', params={'geo.v0': 0.0})


@pytest.mark.parametrize('grid', ['dense', 'one_voxel'])
def test_with_sigma_grid_matches_reference(grid):
    sj, _, sp, _ = build_both(scenes.cornell_box(
        spp=1, res=4, integrator={'type': 'volpath'},
        medium=pscenes.hetvol_medium(grid_res=16, seed=1, scale=5.0)))
    g = (np.random.default_rng(3).uniform(size=(12, 9, 10))
         if grid == 'dense' else np.full((1, 1, 1), 0.5)).astype(np.float32)
    ref = jmed.with_sigma_grid(sj.media, g)
    got = pmed.with_sigma_grid(sp.media, torch.as_tensor(g))
    for f in ('grid_sigma_t', 'grid_sup', 'grid_sup_min', 'grid_sigma_p8'):
        r, p = getattr(ref, f), getattr(got, f)
        if r is None:
            assert p is None, f
        else:
            np.testing.assert_array_equal(p.numpy(), np.asarray(r), f)


def test_parameter_map_grid_leaf_follows_the_reference():
    """A concrete grid refreshes the derived arrays; a grid that requires
    grad drops the packed copy and keeps the supervoxel bound, as the
    reference does for a traced value; any other leaf is a plain
    replace."""
    sp, _ = P.build_scene(pscenes.hetvol_box(4, 4, spp=1, grid_res=16),
                          device='cpu')
    pm = pad.traverse(sp)
    g = pm['media.grid_sigma_t'] * 0.5
    pm['media.grid_sigma_t'] = g
    assert pm.scene.media.grid_sigma_p8 is not None
    assert torch.equal(pm.scene.media.grid_sup, sp.media.grid_sup * 0.5)
    leaf = g.clone().requires_grad_(True)
    sc = pm.updated_scene({'media.grid_sigma_t': leaf})
    assert sc.media.grid_sigma_t is leaf and sc.media.grid_sigma_p8 is None
    assert sc.media.grid_sup is pm.scene.media.grid_sup
    env = pm.updated_scene({'emitters.env_map': sp.emitters.env_map + 1.0})
    assert env.emitters.env_warp is sp.emitters.env_warp


OPTIMIZERS = {
    'sgd': (lambda pm: pad.SGD(pm, lr=0.1),
            lambda optax: optax.sgd(0.1, 0.0)),
    'sgd_momentum': (lambda pm: pad.SGD(pm, lr=0.05, momentum=0.9),
                     lambda optax: optax.sgd(0.05, 0.9)),
    'adam': (lambda pm: pad.Adam(pm, lr=0.05),
             lambda optax: optax.adam(0.05, b1=0.9, b2=0.999)),
}


@pytest.mark.parametrize('name', list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Five steps fed the same gradients: the port's parameters follow
    the reference optimizer's (optax) trajectory."""
    optax = pytest.importorskip('optax')
    make_p, make_j = OPTIMIZERS[name]
    sp, _ = P.build_scene(scenes.cornell_box(spp=1, res=4), device='cpu')
    pm = pad.traverse(sp).keep(['bsdfs.params', 'emitters.params'])
    opt = make_p(pm)
    params_j = {k: jnp.asarray(v.numpy()) for k, v in pm.to_dict().items()}
    tx = make_j(optax)
    state = tx.init(params_j)
    rng = np.random.default_rng(5)
    for _ in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params_j.items()}
        upd, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                               state, params_j)
        params_j = optax.apply_updates(params_j, upd)
        opt.step({k: torch.as_tensor(g) for k, g in grads.items()})
        for k in params_j:
            np.testing.assert_allclose(opt.params[k].detach().numpy(),
                                       np.asarray(params_j[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    sc = opt.update_scene()
    assert torch.equal(sc.bsdfs.params, opt.params['bsdfs.params'])
    assert not sc.bsdfs.params.requires_grad


@pytest.mark.parametrize('rfilter', list(pfilm.FILTER_RADII))
def test_splat_matches_reference(rfilter):
    """The scatter splat (every tap of every sample, samples off the
    pixel grid, some off the film, some with zero weight) and its
    gradient w.r.t. the values."""
    H, W, N = 5, 7, 64
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1.0, 8.0, size=(N, 2)).astype(np.float32)
    vals = rng.uniform(size=(N, 3)).astype(np.float32)
    wts = np.where(rng.uniform(size=N) < 0.2, 0.0, 1.0).astype(np.float32)
    cot = rng.standard_normal((H, W, 4)).astype(np.float32)
    fj = JFilmMeta(width=W, height=H, rfilter=rfilter)

    def jsplat(v):
        return jfilm.splat(fj, jnp.asarray(pos), v, jnp.asarray(wts),
                           jfilm.new_image(fj))
    img_j = np.asarray(jsplat(jnp.asarray(vals)))
    g_j = np.asarray(jax.grad(lambda v: jnp.sum(jsplat(v) * cot))(
        jnp.asarray(vals)))
    v = torch.as_tensor(vals).requires_grad_(True)
    img_p = pfilm.splat(PFilmMeta(width=W, height=H, rfilter=rfilter),
                        torch.as_tensor(pos), v, torch.as_tensor(wts),
                        pfilm.new_image(PFilmMeta(W, H, rfilter)))
    (img_p * torch.as_tensor(cot)).sum().backward()
    assert img_p.shape == (H, W, 4) and img_j[..., 3].sum() > 0
    np.testing.assert_allclose(img_p.detach().numpy(), img_j, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), g_j, rtol=1e-6, atol=1e-6)


def test_render_torch_matches_render():
    """``render_torch``'s gradient equals ``autodiff.render``'s (the
    reference's bridge test, without the bridge)."""
    scene, meta = P.build_scene(scenes.cornell_box(spp=1, res=8),
                                device='cpu')
    fn = pad.render_torch(scene, meta, spp=1, seed=4,
                          param_keys=['bsdfs.params'])
    assert fn.param_keys == ['bsdfs.params']
    t = fn.initial_values[0].clone().requires_grad_(True)
    img = fn(t)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    img.mean().backward()
    pm = pad.traverse(scene).keep(['bsdfs.params'])
    leaf = scene.bsdfs.params.clone().requires_grad_(True)
    pad.render(scene, meta, params={'bsdfs.params': leaf}, pmap=pm, spp=1,
               seed=4).mean().backward()
    assert torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0
    assert torch.equal(t.grad, leaf.grad)


def test_optimizer_descends_loss():
    """Adam on the BSDF albedo reduces an L2 loss toward a target render
    (the reference's inverse-rendering smoke test, at 8x8)."""
    scene, meta = P.build_scene(scenes.cornell_box(spp=1, res=8),
                                device='cpu')
    pm = pad.traverse(scene).keep(['bsdfs.params'])
    with torch.no_grad():
        target = pad.render(scene, meta, spp=1, seed=3)
    opt = pad.Adam(pm, lr=0.05)
    opt.params = {'bsdfs.params': pm['bsdfs.params'] * 0.3}
    losses = []
    for _ in range(9):
        img = pad.render(scene, meta, params=opt.params, pmap=pm, spp=1,
                         seed=3)
        loss = ((img - target) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        assert torch.isfinite(opt.params['bsdfs.params'].grad).all()
        losses.append(float(loss))
        opt.step()
    assert losses[-1] < losses[0], losses


def test_diff_render_counts_the_recompute_apart():
    """The backward pass recomputes each checkpointed bounce: its host
    reads count apart, so the forward counts are one forward pass's."""
    scene, meta = P.build_scene(scenes.cornell_box(
        spp=1, res=4, integrator={'type': 'volpath', 'max_depth': 3},
        medium={'type': 'homogeneous', 'sigma_t': 0.5, 'albedo': 0.8}),
        device='cpu')
    leaf = scene.bsdfs.params.clone().requires_grad_(True)
    pm = pad.traverse(scene).keep(['bsdfs.params'])
    counters.reset()
    with torch.no_grad():
        pad.render(scene, meta, spp=1, seed=0)
    forward_only = counters.read()
    counters.reset()
    img = pad.render(scene, meta, params={'bsdfs.params': leaf}, pmap=pm,
                     spp=1, seed=0)
    after_forward = counters.read()
    img.mean().backward()
    after = counters.read()
    assert after_forward['host_syncs'] == forward_only['host_syncs'] > 0
    assert after['host_syncs'] == after_forward['host_syncs']
    assert after['host_syncs_recompute'] > 0
    assert after_forward['host_syncs_recompute'] == 0


def test_diff_render_never_takes_the_regeneration_scheduler():
    _, meta = P.build_scene(scenes.cornell_box(spp=1, res=4), device='cpu')
    assert regen_supported(meta, 'path')
    assert not regen_supported(meta, 'path', diff=True)
