"""The port's map-sharded estimates and camera passes
(``parallel/sharded_maps.py``, ``map_psum_axis``) against the reference's.

Ports ``tests/test_sharded_maps.py``'s two cases on one scene (its
2-D-mesh case's box and options, the light pass cut to 256 VRLs and 1,024
photons of each kind, so that both halves of each map hold valid entries)
and one reference light pass, whose maps every case carries over.
Ranks run in processes of their own (``torch_dist.py``: gloo, a file
store, one thread a rank): a 2-rank world and a 4-rank world, started
together.

  * The volume estimate on 2 ranks against the reference's single
    ``photon_est.estimate_volume`` on the same maps (rtol 2e-4, atol
    1e-6, as the reference's own test).
  * The ``vrl`` camera pass on a 2 x 2 (dp x mp) mesh against the
    reference's ``make_sharded_vrl_render`` on a 2 x 2 CPU mesh, the same
    maps, rays and key, one seed: 99% of lanes within 1e-3 relative, the
    means within 1e-3. The reference's statistical check on the port
    alone: 2 x 2 against 2 x 1, the means within 15% over 4 seeds (a map
    shard selects VRLs of its own: another unbiased estimator).
  * A 1 x 2 ``photonmapper`` pass and a 1 x 2 beam-estimate (``use_bre``)
    pass equal the unsharded pass within rtol 2e-4: photon gathers are
    sums.
  * In every case each rank's all-reduce count, final sampler dimension
    and radiance are equal across its map group.
  * ``map_psum_axis`` outside a bound group raises, as the reference's
    unbound ``psum`` does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu import sensor as jsensor
from mitsuba_nlvrl_tpu.integrators import photon_est as jest
from mitsuba_nlvrl_tpu.integrators import vrl as jvrl
from mitsuba_nlvrl_tpu.integrators.common import film_sample_positions
from mitsuba_nlvrl_tpu.parallel import sharded_maps as jsm
from mitsuba_nlvrl_tpu_torch.core import rng
from mitsuba_nlvrl_tpu_torch.core.ray import Ray
from mitsuba_nlvrl_tpu_torch.core.rng import Sampler
from mitsuba_nlvrl_tpu_torch.integrators import vrl as pvrl
from mitsuba_nlvrl_tpu_torch.parallel import sharded_maps as psm

import scenes
from torch_dist import pack, start_ranks, wait_ranks
from torch_parity import (build_both, ieee_jit, ieee_reference,
                          jax_meta_dict, scene_arrays)

torch.set_num_threads(1)   # one intra-op thread a test worker

SEEDS = 4
N_QUERY = 64


@functools.lru_cache(maxsize=None)
def _case():
    """The box, the reference's light pass, the camera rays and the
    volume queries, on both sides."""
    desc = scenes.cornell_box(
        spp=1, res=8, integrator={'type': 'vrl', 'max_depth': 5,
                                  'samples_per_query': 1,
                                  'max_cam_iters': 6,
                                  'gather_points_cap': 8,
                                  'vrl_clusters': 16,
                                  'min_vrl_length': 0.02,
                                  'target_vrls': 256,
                                  'global_photons': 1024},
        medium={'type': 'homogeneous', 'sigma_t': 0.6, 'albedo': 0.9})
    sj, mj, sp, mp = build_both(desc)
    maps_j = jvrl.preprocess(sj, mj, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    _, pos01 = film_sample_positions(mj, key)
    ray_j, _ = jsensor.sample_ray(
        sj, mj, pos01, jax.random.uniform(jax.random.fold_in(key, 1),
                                          (pos01.shape[0], 2)))
    # queries beside volume photons of both halves of the map
    radius = float(maps_j.vp_grid.cell_size)
    vp = np.asarray(maps_j.vp_pos)[np.asarray(maps_j.vp_valid)]
    pick = np.linspace(0, len(vp) - 1, N_QUERY).astype(int)
    q = vp[pick] + np.asarray(jax.random.uniform(
        jax.random.PRNGKey(3), (N_QUERY, 3), minval=-0.3,
        maxval=0.3)) * radius
    query = {'x': np.asarray(q),
             'wo': np.tile(np.float32([[0.0, 0.0, 1.0]]), (N_QUERY, 1)),
             'medium': np.zeros(N_QUERY, np.int32),
             'active': np.ones(N_QUERY, bool),
             'radius': np.full(N_QUERY, radius, np.float32)}
    maps_np = scene_arrays(maps_j)
    ray_np = {f: np.asarray(getattr(ray_j, f)) for f in Ray._fields}
    return sj, mj, maps_j, ray_j, sp, mp, maps_np, ray_np, query


def _inputs():
    sj, mj, _, _, _, _, maps_np, ray_np, query = _case()
    return pack(scene_arrays(sj), jax_meta_dict(mj), maps_np, seed=0,
                seeds=SEEDS, **{f'ray.{k}': v for k, v in ray_np.items()},
                **{f'q.{k}': v for k, v in query.items()})


def _port_ray(ray_np):
    return Ray(*(torch.as_tensor(np.array(ray_np[f])) for f in Ray._fields))


def _with(meta, integrator, **props):
    kept = tuple(kv for kv in meta.integrator_props if kv[0] not in props)
    return dataclasses.replace(meta, integrator=integrator,
                               integrator_props=kept + tuple(props.items()))


def _check_map_groups(outs, groups, name):
    """Each rank of a map group made the same all-reduces, ended at the
    same sampler dimension and holds the same radiance."""
    for g in groups:
        r0 = outs[g[0]]
        for r in g[1:]:
            o = outs[r]
            assert int(o[f'{name}.all_reduces']) == \
                int(r0[f'{name}.all_reduces']) > 0, name
            assert int(o[f'{name}.sampler_dim']) == \
                int(r0[f'{name}.sampler_dim']), name
            assert o[f'{name}.L'].tobytes() == r0[f'{name}.L'].tobytes()


def _gather(outs, name, ranks):
    """The whole wavefront's radiance from the ranks' rows."""
    parts = sorted((tuple(outs[r][f'{name}.rows']), outs[r][f'{name}.L'])
                   for r in ranks)
    assert parts[0][0][0] == 0
    return np.concatenate([L for _, L in parts])


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The 2-rank and the 4-rank worlds, started together, and what this
    process computes while they run: the reference's single volume
    estimate and 2 x 2 pass, and the port's unsharded passes."""
    sj, mj, maps_j, ray_j, sp, mp, maps_np, ray_np, query = _case()
    assert int(maps_j.vrl_count) > 64   # the sharded query has work
    tmp = tmp_path_factory.mktemp('sharded_maps')
    h2 = start_ranks(tmp, 'maps_2', 2, _inputs())
    h4 = start_ranks(tmp, 'maps_2x2', 4, _inputs())
    ref_vol = np.asarray(jest.estimate_volume(
        sj, mj, maps_j, *(jnp.asarray(query[k]) for k in (
            'x', 'wo', 'medium', 'active', 'radius'))))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ('dp', 'mp'))
    with ieee_reference(nested=True):
        ref22 = np.asarray(ieee_jit(jsm.make_sharded_vrl_render(mj, mesh))(
            sj, jsm.shard_photon_axis(maps_j, mesh, 'mp'), ray_j,
            jax.random.PRNGKey(0)))
    maps_p = P.maps_from_numpy(maps_np, device='cpu')
    ray_p = _port_ray(ray_np)
    unsharded = {}
    for name, m in (('pm', _with(mp, 'photonmapper')),
                    ('bre', _with(mp, 'photonmapper', use_bre=True))):
        fn = psm.make_sharded_vrl_render(m, None)
        unsharded[name] = fn(sp, psm.shard_photon_axis(maps_p, None), ray_p,
                             rng.PRNGKey(0)).numpy()
    return {'two': wait_ranks(h2), 'four': wait_ranks(h4),
            'ref_vol': ref_vol, 'ref22': ref22, 'unsharded': unsharded}


def test_sharded_volume_estimate_matches_single(ranks):
    ref = ranks['ref_vol']
    assert (ref.sum(axis=1) > 0).mean() > 0.5
    for o in ranks['two']:
        assert int(o['volume.all_reduces']) == 1
        np.testing.assert_allclose(o['volume'], ref, rtol=2e-4, atol=1e-6)


def test_sharded_vrl_render_2d_mesh(ranks):
    four, two = ranks['four'], ranks['two']
    groups = sorted({tuple(o['mp_group'].tolist()) for o in four})
    assert groups == [(0, 1), (2, 3)]
    for s in range(SEEDS):
        _check_map_groups(four, groups, f'vrl22_{s}')
    L22 = [_gather(four, f'vrl22_{s}', [0, 2]) for s in range(SEEDS)]
    L21 = [_gather(two, f'vrl21_{s}', [0, 1]) for s in range(SEEDS)]

    ref = ranks['ref22']
    got = L22[0]
    assert got.shape == ref.shape == (64, 3)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)
    assert (rel <= 1e-3).mean() >= 0.99, (rel <= 1e-3).mean()
    assert abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()

    L22, L21 = np.stack(L22), np.stack(L21)
    assert np.isfinite(L22).all() and L22.mean() > 0
    assert abs(L22.mean() - L21.mean()) / max(L21.mean(), 1e-9) < 0.15, \
        (L22.mean(), L21.mean())


@pytest.mark.parametrize('name', ['pm', 'bre'])
def test_photon_gathers_shard_as_sums(ranks, name):
    two = ranks['two']
    _check_map_groups(two, [(0, 1)], name)
    ref = ranks['unsharded'][name]
    assert np.abs(ref).sum() > 0
    for o in two:
        np.testing.assert_allclose(o[f'{name}.L'], ref, rtol=2e-4,
                                   atol=1e-6)


def test_map_psum_axis_without_a_bound_group_raises():
    sj, mj, maps_j, ray_j, sp, mp, maps_np, ray_np, _ = _case()
    from mitsuba_nlvrl_tpu.core.rng import Sampler as JSampler
    mj2 = _with(mj, 'vrl', map_psum_axis='mp')
    with pytest.raises(NameError, match='unbound axis name: mp'):
        jvrl.sample(sj, mj2, JSampler.make(jax.random.PRNGKey(0), 64),
                    ray_j, aux=maps_j)
    mp2 = _with(mp, 'vrl', map_psum_axis='mp')
    with pytest.raises(NameError, match='unbound axis name: mp'):
        pvrl.sample(sp, mp2, Sampler.make(rng.PRNGKey(0), 64),
                    _port_ray(ray_np),
                    aux=P.maps_from_numpy(maps_np, device='cpu'))
