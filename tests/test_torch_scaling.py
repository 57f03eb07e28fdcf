"""The port's scaling harness and process-group entry
(``parallel/scaling.py``).

  * ``init_distributed`` from arguments (a file store) and from the
    environment that torchrun sets (a port the system picks), 2 ranks
    each; a group of another backend than the device's raises.
  * ``measure_scaling`` on 2 gloo ranks: the one-rank and the two-rank
    renders draw the same numbers (checksum_rel_diff < 1e-5), and gloo on
    the CPU is no hardware statement (``hardware_valid`` False, ``note``
    set).
  * The proxies' dicts at tiny sizes, in this process.
  * The plausibility bound: a rate from a forged clock is rejected.
"""
import functools

import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu_torch.parallel import scaling

import scenes
from torch_dist import pack, start_ranks, unpickle, wait_ranks
from torch_parity import build_both, jax_meta_dict, scene_arrays

torch.set_num_threads(1)   # one intra-op thread a test worker


@functools.lru_cache(maxsize=None)
def _box():
    return build_both(scenes.cornell_box(spp=1, res=16))


def test_init_distributed_from_arguments_and_from_the_environment(tmp_path):
    sj, mj, _, _ = _box()
    inputs = pack(scene_arrays(sj), jax_meta_dict(mj))
    by_env = start_ranks(tmp_path, 'init_env', 2, inputs, from_env=True)
    by_args = start_ranks(tmp_path, 'scaling', 2, inputs)
    for r, o in enumerate(wait_ranks(by_env)):
        assert (int(o['rank']), int(o['world'])) == (r, 2)
        assert float(o['sum']) == 1.0
    recs = [unpickle(o['rec']) for o in wait_ranks(by_args)]
    # measure_scaling: every rank holds rank 0's record
    assert recs[0] == recs[1]
    rec = recs[0]
    assert rec['n'] == 2 and rec['integrator'] == 'path'
    assert rec['checksum_rel_diff'] < 1e-5, rec
    assert rec['hardware_valid'] is False and rec['note'], rec
    assert rec['backend'] == 'gloo'
    assert 0 < rec['rays_per_s_1'] <= rec['ceiling']
    assert 0 < rec['rays_per_s_n'] <= 2 * rec['ceiling']


def test_the_backend_follows_the_device(monkeypatch):
    """NCCL for the card's tensors, gloo for the CPU's, and a group of the
    other backend raises instead of summing elsewhere."""
    import torch.distributed as dist
    from mitsuba_nlvrl_tpu_torch.parallel import collectives
    assert collectives.backend_for('cuda') == 'nccl'
    assert collectives.backend_for('cpu') == 'gloo'
    collectives.check_backend(None, 'cuda')          # this process alone
    for have, device in (('gloo', 'cuda'), ('nccl', 'cpu')):
        monkeypatch.setattr(dist, 'get_backend', lambda g, b=have: b)
        with pytest.raises(RuntimeError, match=collectives.backend_for(
                device)):
            collectives.check_backend(object(), device)
        monkeypatch.setattr(dist, 'get_backend',
                            lambda g, d=device: collectives.backend_for(d))
        collectives.check_backend(object(), device)


def test_proxy_contracts():
    _, _, sp, mp = _box()
    ceiling = 4.0 * scaling.steady_render_rate(sp, mp, passes=1)
    rec = scaling.dp_fold_proxy(sp, mp, shard_lanes=64, folds=2, passes=1,
                                ceiling=ceiling)
    assert rec['shard_lanes'] == 64 and rec['folds'] == 2
    for k in ('folded_mrays', 'full_mrays', 'ratio'):
        assert rec[k] > 0, (k, rec)
    assert max(rec['folded_mrays'], rec['full_mrays']) \
        <= rec['ceiling_mrays']
    rec = scaling.weak_scaling_proxy(sp, mp, base=64, factors=(1, 2),
                                     passes=1, ceiling=ceiling)
    assert rec['sizes'] == [64, 128] and len(rec['rays_per_s']) == 2
    assert all(0 < r <= ceiling for r in rec['rays_per_s'])
    assert rec['per_ray_flat'] > 0
    # a wavefront larger than the film (16 x 16) may run faster, in
    # proportion to its lanes
    assert scaling.lane_bound(ceiling, mp, 128) == ceiling
    assert scaling.lane_bound(ceiling, mp, 1024) == 4 * ceiling


def test_plausibility_bound_rejects_a_forged_rate(monkeypatch):
    _, _, sp, mp = _box()
    for bad in (0.0, -1.0, float('nan'), float('inf'), 5e6):
        with pytest.raises(scaling.ImplausibleRate):
            scaling.check_rate('forged', bad, 4e6)
    assert scaling.check_rate('fine', 3e6, 4e6) == 3e6
    # a clock that barely moves: every pass seems to take a nanosecond
    ticks = iter(np.arange(1e6) * 1e-9)
    monkeypatch.setattr(scaling, '_clock', lambda: float(next(ticks)))
    with pytest.raises(scaling.ImplausibleRate, match='folded'):
        scaling.dp_fold_proxy(sp, mp, shard_lanes=64, folds=2, passes=1,
                              ceiling=1e9)
