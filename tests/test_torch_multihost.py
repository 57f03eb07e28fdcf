"""The port's data-parallel render (``parallel/render_dist.py``) against
the reference's, and its draws at given lanes of a global wavefront
(``core/rng.Lanes``).

Ports ``tests/test_multihost.py``'s three cases and adds two. Ranks run
in processes of their own (``torch_dist.py``: gloo, a file store, one
thread a rank); the reference runs in this process.

  * Two ranks render what one rank renders, to 1e-6 relative a pixel
    (only the order of the film's sums differs). The one-rank render
    matches the reference's ``render_distributed`` on a 2-device CPU
    mesh with the same seed, spp and fold: 99% of pixels within 1e-3
    relative, the means within 1e-3, and the rays within 0.1% of the
    reference's count of the same wavefront.
  * Folding is unbiased: fold 4 against fold 1, the means within 5%.
  * ``measure_fold``'s contract at 24x24, folds 2, reps 1.
  * ``train_step``'s loss and gradient against ``jax.value_and_grad``
    of the reference's, within ``test_torch_autodiff.py``'s tolerance
    (rtol 1e-4, atol 1e-5 of the largest entry).
  * A draw at scattered lanes equals the same slice of the whole draw,
    bit for bit, for every shape the renderer draws.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mitsuba_nlvrl_tpu.parallel import render_dist as jrd
from mitsuba_nlvrl_tpu_torch.core import rng
from mitsuba_nlvrl_tpu_torch.medium import WALK_UNROLL
from mitsuba_nlvrl_tpu_torch.parallel import render_dist as prd

import scenes
from torch_dist import pack, start_ranks, wait_ranks
from torch_parity import (build_both, ieee_jit, ieee_reference,
                          jax_meta_dict, scene_arrays)

torch.set_num_threads(1)   # one intra-op thread a test worker

RES, SPP, FOLD, SEED = 32, 4, 2, 1


@functools.lru_cache(maxsize=None)
def _box(res=RES, spp=SPP, max_depth=None):
    integ = {'type': 'path'}
    if max_depth is not None:
        integ['max_depth'] = max_depth
    return build_both(scenes.cornell_box(spp=spp, res=res, integrator=integ))


def _reference_rays(sj, mj, seed, spp, fold):
    """The reference's ray count of ``render_distributed``'s wavefront:
    its dispatch body, the sampler's count kept."""
    from mitsuba_nlvrl_tpu import sensor
    from mitsuba_nlvrl_tpu.core.rng import Sampler
    from mitsuba_nlvrl_tpu.integrators import get_integrator
    integ = get_integrator(mj.integrator)
    W, H = mj.film.width, mj.film.height

    @functools.partial(jax.jit, static_argnames=('n_fold',))
    def rays(scene, key, n_fold):
        posf = jnp.tile(jrd._pixel_base(mj), (n_fold, 1))
        n = posf.shape[0]
        posf = posf + jax.random.uniform(jax.random.fold_in(key, 0xf17),
                                         (n, 2))
        scale = jnp.asarray([1.0 / W, 1.0 / H], jnp.float32)
        ray, _ = sensor.sample_ray(scene, mj, posf * scale,
                                   jax.random.uniform(
                                       jax.random.fold_in(key, 1), (n, 2)))
        sampler = Sampler.make(jax.random.fold_in(key, 2), n)
        return integ(scene, mj, sampler, ray)[2].rays

    key, total, p = jax.random.PRNGKey(seed), 0.0, 0
    while p < spp:
        n_fold = min(fold, spp - p)
        total += float(rays(sj, jax.random.fold_in(key, p), n_fold=n_fold))
        p += n_fold
    return total


def test_two_ranks_render_what_one_rank_and_the_reference_render(tmp_path):
    sj, mj, sp, mp = _box()
    ranks = start_ranks(tmp_path, 'render', 2, pack(
        scene_arrays(sj), jax_meta_dict(mj), seed=SEED, spp=SPP, fold=FOLD))
    info = {}
    one = prd.render_distributed(sp, mp, None, seed=SEED, spp=SPP,
                                 fold=FOLD, info=info).numpy()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('dp',))
    ref = np.asarray(jrd.render_distributed(sj, mj, mesh, seed=SEED,
                                            spp=SPP, fold=FOLD))
    ref_rays = _reference_rays(sj, mj, SEED, SPP, FOLD)
    two = wait_ranks(ranks)

    # both ranks hold the same film, one rank's to the order of its sums
    assert two[0]['img'].tobytes() == two[1]['img'].tobytes()
    np.testing.assert_allclose(two[0]['img'], one, rtol=1e-6, atol=1e-9)
    assert float(two[0]['rays']) == float(info['rays'])
    # one all-reduce of the film a dispatch, one of the rays
    assert int(two[0]['all_reduces']) == SPP // FOLD + 1
    assert info['dispatches'] == SPP // FOLD and info['all_reduces'] == 0

    assert one.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(one).all() and one.mean() > 0.01
    rel = np.abs(one - ref) / np.maximum(np.abs(ref), 1e-6)
    assert (rel <= 1e-3).mean() >= 0.99, (rel <= 1e-3).mean()
    assert abs(one.mean() - ref.mean()) <= 1e-3 * ref.mean()
    assert abs(float(info['rays']) - ref_rays) <= 1e-3 * ref_rays, \
        (float(info['rays']), ref_rays)


def test_dp_pass_folding_unbiased():
    """Folding passes into the lane dimension keeps the estimator: fold 4
    and fold 1 agree to Monte Carlo noise, and a 32x32 film over 8 ranks
    folds at least 4 passes."""
    _, _, sp, mp = _box(spp=8)
    assert prd.dp_fold_for(mp, 8, 8) >= 4
    img_f = prd.render_distributed(sp, mp, None, seed=3, spp=8,
                                   fold=4).numpy()
    img_1 = prd.render_distributed(sp, mp, None, seed=3, spp=8,
                                   fold=1).numpy()
    assert np.isfinite(img_f).all() and np.isfinite(img_1).all()
    assert abs(img_f.mean() - img_1.mean()) / img_1.mean() < 0.05


def test_measure_fold_smoke():
    """measure_fold returns the reference's dict, every time positive,
    with the speedup beside the ratio."""
    _, _, sp, mp = _box(res=24, spp=2)
    rec = prd.measure_fold(sp, mp, folds=2, reps=1)
    for k in ('latency_fold_s', 'wall_fold_s', 'wall_nofold_s', 'kernel_s',
              'ratio', 'speedup'):
        assert k in rec and rec[k] > 0, (k, rec)
    assert rec['pixels'] == 24 * 24 and rec['folds'] == 2
    assert rec['backend'] == 'cpu' and rec['dist_backend'] is None


def test_train_step_matches_reference():
    sj, mj, sp, mp = _box(res=16, spp=1, max_depth=3)
    target = np.full((16, 16, 3), 0.2, np.float32)

    def merge(s, p):
        return s._replace(bsdfs=s.bsdfs._replace(params=p))

    with ieee_reference(nested=True):
        loss_j, g_j = ieee_jit(lambda p, key: jrd.train_step(
            sj, mj, p, jnp.asarray(target), key, merge))(
                sj.bsdfs.params, jax.random.PRNGKey(4))
    loss_p, g_p = prd.train_step(sp, mp, sp.bsdfs.params,
                                 torch.as_tensor(target), rng.PRNGKey(4),
                                 merge)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-4)
    assert np.isfinite(g_p.numpy()).all() and np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=1e-4,
                               atol=1e-5 * np.abs(g_j).max())
    # a dict of parameters comes back as a dict
    _, g_d = prd.train_step(sp, mp, {'p': sp.bsdfs.params},
                            torch.as_tensor(target), rng.PRNGKey(4),
                            lambda s, d: merge(s, d['p']))
    assert torch.equal(g_d['p'], g_p)


@pytest.mark.parametrize('shape,axis', [((257,), 0), ((257, 2), 0),
                                        ((WALK_UNROLL, 257, 3), 1),
                                        ((WALK_UNROLL, 257, 2), 1)])
def test_draws_at_global_lanes_are_slices_of_the_whole_draw(shape, axis):
    """The shapes the renderer draws: a lane's (N,), the 2D samples'
    (N, 2), the volumetric walk's (WALK_UNROLL, N, n_u). The whole draw
    equals jax.random.uniform's; a draw at scattered lanes equals its
    slice; a sampler at lanes draws its lanes' numbers, and fork and a
    dimension skip keep the lanes."""
    kj = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    kt = rng.fold_in(rng.PRNGKey(7), 3)
    whole = rng.uniform(kt, shape)
    assert whole.numpy().tobytes() == np.asarray(
        jax.random.uniform(kj, shape, jnp.float32)).tobytes()
    ids = torch.tensor([256, 3, 128, 0, 129, 77, 255])
    local = list(shape)
    local[axis] = len(ids)
    part = rng.uniform(kt, tuple(local), lanes=rng.Lanes(ids, shape[axis]),
                       axis=axis)
    assert torch.equal(part, whole.index_select(axis, ids))

    lanes = rng.Lanes(ids, 257)
    s_all = rng.Sampler.make(kt, 257)
    s_at = rng.Sampler.make(kt, len(ids), at=lanes)
    for _ in range(2):
        (a, s_all), (b, s_at) = s_all.next_2d(), s_at.next_2d()
        assert torch.equal(b, a[ids])
    s_all = s_all.fork(5)._replace(dim=s_all.dim + 3)
    s_at = s_at.fork(5)._replace(dim=s_at.dim + 3)
    assert s_at.at is lanes
    (a, _), (b, _) = s_all.next_1d(), s_at.next_1d()
    assert torch.equal(b, a[ids])
