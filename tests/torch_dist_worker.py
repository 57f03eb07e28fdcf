"""One rank of a multi-rank port test, in a process of its own.

    python tests/torch_dist_worker.py JOB RANK WORLD STORE IN OUT

joins a gloo world of WORLD ranks through the file store STORE (or, for
the ``init_env`` job, through the environment that torchrun sets), runs
JOB on the inputs of the ``.npz`` file IN and writes its outputs to the
``.npz`` file OUT. It pins torch to one thread and imports neither JAX
nor the reference package: the tests that start it (``torch_dist.py``)
hold its outputs against the reference in their own process. Scenes come
in as ``scene_from_numpy`` arrays, maps as ``maps_from_numpy`` arrays.
"""
import dataclasses
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import mitsuba_nlvrl_tpu_torch as P  # noqa: E402
from mitsuba_nlvrl_tpu_torch.core import rng  # noqa: E402
from mitsuba_nlvrl_tpu_torch.core.ray import Ray  # noqa: E402
from mitsuba_nlvrl_tpu_torch.parallel import (collectives,  # noqa: E402
                                              render_dist, scaling,
                                              sharded_maps)

torch.set_num_threads(1)


def _sub(inp, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in inp.items() if k.startswith(prefix + '.')}


def scene_of(inp):
    meta = pickle.loads(inp['meta'].tobytes())
    return P.scene_from_numpy(_sub(inp, 'scene'), meta, device='cpu')


def maps_of(inp):
    return P.maps_from_numpy(_sub(inp, 'maps'), device='cpu')


def ray_of(inp):
    return Ray(*(torch.as_tensor(inp[f'ray.{f}']) for f in Ray._fields))


def with_props(meta, integrator, **props):
    kept = tuple(kv for kv in meta.integrator_props if kv[0] not in props)
    return dataclasses.replace(meta, integrator=integrator,
                               integrator_props=kept
                               + tuple(props.items()))


def job_render(inp):
    """render_distributed over every rank."""
    scene, meta = scene_of(inp)
    info = {}
    img = render_dist.render_distributed(
        scene, meta, render_dist.make_mesh('cpu'), seed=int(inp['seed']),
        spp=int(inp['spp']), fold=int(inp['fold']), info=info)
    return {'img': img.numpy(), 'rays': float(info['rays']),
            'all_reduces': info['all_reduces'], 'fold': info['fold']}


def job_init_env(inp):
    """The world joined from the environment: each rank adds its rank."""
    t = torch.tensor([float(dist.get_rank())])
    return {'rank': dist.get_rank(), 'world': dist.get_world_size(),
            'sum': float(collectives.all_reduce_sum(t, dist.group.WORLD))}


def job_scaling(inp):
    """measure_scaling over every rank."""
    scene, meta = scene_of(inp)
    rec = scaling.measure_scaling(scene, meta, passes=2)
    return {'rec': np.frombuffer(pickle.dumps(rec), np.uint8)}


def _vrl_pass(scene, meta, maps, ray, mesh, seed):
    """One map-sharded camera pass: (the rank's rows, the info)."""
    fn = sharded_maps.make_sharded_vrl_render(meta, mesh)
    info = {}
    L = fn(scene, sharded_maps.shard_photon_axis(maps, mesh), ray,
           rng.PRNGKey(seed), info=info)
    return L.numpy(), info


def _record(out, name, L, info):
    out[f'{name}.L'] = L
    out[f'{name}.rows'] = np.array(info['rows'])
    out[f'{name}.all_reduces'] = info['all_reduces']
    out[f'{name}.sampler_dim'] = info['sampler_dim']
    out[f'{name}.rays'] = float(info['rays'])


def job_maps_2(inp):
    """Two ranks: the volume estimate on a 2-rank map axis, the 1 x 2
    photonmapper and beam-estimate passes, the 2 x 1 vrl passes."""
    scene, meta = scene_of(inp)
    maps, ray = maps_of(inp), ray_of(inp)
    out = {}
    mesh = render_dist.make_mesh('cpu', (2,), ('mp',))
    fn = sharded_maps.make_sharded_volume_estimate(meta, mesh)
    collectives.reset()
    out['volume'] = fn(scene, sharded_maps.shard_photon_axis(maps, mesh),
                       *(torch.as_tensor(inp[f'q.{k}']) for k in (
                           'x', 'wo', 'medium', 'active', 'radius'))
                       ).numpy()
    out['volume.all_reduces'] = collectives.all_reduces
    mesh12 = render_dist.make_mesh('cpu', (1, 2), ('dp', 'mp'))
    for name, m in (('pm', with_props(meta, 'photonmapper')),
                    ('bre', with_props(meta, 'photonmapper', use_bre=True))):
        _record(out, name, *_vrl_pass(scene, m, maps, ray, mesh12,
                                      int(inp['seed'])))
    mesh21 = render_dist.make_mesh('cpu', (2, 1), ('dp', 'mp'))
    for s in range(int(inp['seeds'])):
        _record(out, f'vrl21_{s}', *_vrl_pass(scene, meta, maps, ray, mesh21,
                                              s))
    return out


def job_maps_2x2(inp):
    """Four ranks: the vrl camera pass on a 2 x 2 (dp x mp) mesh."""
    scene, meta = scene_of(inp)
    maps, ray = maps_of(inp), ray_of(inp)
    mesh = render_dist.make_mesh('cpu', (2, 2), ('dp', 'mp'))
    out = {'mp_group': np.array(dist.get_process_group_ranks(
        mesh.get_group('mp')))}
    for s in range(int(inp['seeds'])):
        _record(out, f'vrl22_{s}', *_vrl_pass(scene, meta, maps, ray, mesh,
                                              s))
    return out


def main():
    job, rank, world, store, path_in, path_out = sys.argv[1:7]
    if job == 'init_env':
        scaling.init_distributed(device='cpu')
    else:
        scaling.init_distributed(f'file://{store}', int(world), int(rank),
                                 device='cpu')
    try:
        with np.load(path_in) as f:
            inp = dict(f)
        out = globals()[f'job_{job}'](inp)
        np.savez(path_out, **out)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
