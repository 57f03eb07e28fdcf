"""The port's film samplers, ``seed_for`` and the thinlens,
radiancemeter and irradiancemeter sensors against the reference's.

Tolerances: ``film_jitter`` and ``seed_for`` equal in bits (the jitter
against the reference's compiled function with a traced pass index, as
its render calls it: XLA multiplies by a constant's reciprocal and fuses
multiply-adds there, and the port rounds the same way); the sensors'
rays within 2e-6 absolute (the thin lens draws its lens point through
sin and cos, which the two libraries round apart in the last bit), their
weights equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_nlvrl_tpu as J
import mitsuba_nlvrl_tpu_torch as P
from mitsuba_nlvrl_tpu import sampler as jsampler
from mitsuba_nlvrl_tpu import sensor as jsensor
from mitsuba_nlvrl_tpu.core import rng as jrng
from mitsuba_nlvrl_tpu_torch import sampler as psampler
from mitsuba_nlvrl_tpu_torch import sensor as psensor
from mitsuba_nlvrl_tpu_torch.core import rng as prng
from mitsuba_nlvrl_tpu_torch.core import sync as psync

import scenes
from torch_parity import jax_meta_dict, scene_arrays

SAMPLERS = ('independent', 'stratified', 'multijitter', 'ldsampler',
            'orthogonal')
N = 4099
SEED = 11


@functools.lru_cache(maxsize=None)
def _reference_jitter(spp: int):
    """{(sampler, pass): offsets} of the reference's compiled film_jitter
    for the first and last pass of ``spp``."""
    def all_samplers(key, pass_idx):
        return [jsampler.film_jitter(s, key, pass_idx, spp, N)
                for s in SAMPLERS]
    f = jax.jit(all_samplers)
    out = {}
    for p in sorted({0, spp - 1}):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), p)
        for s, a in zip(SAMPLERS, f(key, jnp.uint32(p))):
            out[s, p] = np.asarray(a)
    return out


@pytest.mark.parametrize('spp', [1, 4, 7, 16])
@pytest.mark.parametrize('sampler', SAMPLERS)
def test_film_jitter_bit_equal(sampler, spp):
    ref = _reference_jitter(spp)
    for p in sorted({0, spp - 1}):
        key = prng.fold_in(prng.PRNGKey(SEED), p)
        got = psampler.film_jitter(sampler, key, p, spp, N).numpy()
        assert got.dtype == np.float32 and got.shape == (N, 2)
        assert got.tobytes() == ref[sampler, p].tobytes(), (sampler, spp, p)
        assert (got >= 0).all() and (got <= 1).all()


def test_orthogonal_has_its_own_branch():
    """The reference's ``orthogonal`` branch comes before its
    ``('multijitter', 'orthogonal')`` one, so orthogonal is the Bose
    construction, not multi-jitter; the port keeps that."""
    ref = _reference_jitter(16)
    assert ref['orthogonal', 0].tobytes() != ref['multijitter', 0].tobytes()
    key = prng.fold_in(prng.PRNGKey(SEED), 0)
    got = psampler.film_jitter('orthogonal', key, 0, 16, N).numpy()
    assert got.tobytes() == ref['orthogonal', 0].tobytes()


def test_cycle_walk_stops_early_on_host_past_its_masked_bound():
    """The Kensler walk reads the host once a round and stops when every
    value is in range: the same permutation as the reference's
    ``while_loop`` (513 may need up to 512 rounds), in far fewer reads
    than that bound. A power-of-two domain reads nothing."""
    rng = np.random.default_rng(0)
    i = rng.integers(0, 513, 2048).astype(np.uint32)
    p = rng.integers(0, 2 ** 32, 2048, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jsampler._cmj_permute(jnp.asarray(i), 513,
                                           jnp.asarray(p)))
    before = psync.host_syncs
    got = psampler._cmj_permute(torch.from_numpy(i.astype(np.int64)), 513,
                                torch.from_numpy(p.astype(np.int64)))
    reads = psync.host_syncs - before
    assert (got.numpy() == ref).all()
    assert set(got.numpy().tolist()) <= set(range(513))
    assert 2 <= reads < 64, reads
    before = psync.host_syncs
    psampler._cmj_permute(torch.from_numpy(i.astype(np.int64) % 512), 512,
                          torch.from_numpy(p.astype(np.int64)))
    assert psync.host_syncs == before


@pytest.mark.parametrize('indices', [(), (3,), (0, 7), (5, 1, 2 ** 31 + 9)])
def test_seed_for_bit_equal(indices):
    ref = np.asarray(jax.random.key_data(jrng.seed_for(
        jax.random.PRNGKey(SEED), *indices))).astype(np.int64)
    got = prng.seed_for(prng.PRNGKey(SEED), *indices).numpy()
    assert got.tolist() == ref.tolist()


SENSORS = {
    'thinlens': {'type': 'thinlens', 'aperture_radius': 0.1,
                 'focus_distance': 2.5, 'fov': 50.0},
    'radiancemeter': {'type': 'radiancemeter'},
    'irradiancemeter': {'type': 'irradiancemeter'},
}


@pytest.mark.parametrize('name', list(SENSORS))
def test_sensor_rays_match_reference(name):
    """Rays of the three new sensors from the same film and aperture
    samples, the sensor placed by the reference's look_at."""
    d = scenes.cornell_box(spp=1, res=8)
    d['sensor'] = dict(d['sensor'], **SENSORS[name],
                       to_world=scenes.tr.look_at((0.3, 0.2, -3.0),
                                                  (0, 0, 0), (0, 1, 0)))
    sj, mj = J.build_scene(d)
    sp, mp = P.scene_from_numpy(scene_arrays(sj), jax_meta_dict(mj),
                                device='cpu')
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1, (1024, 2)).astype(np.float32)
    ap = rng.uniform(0, 1, (1024, 2)).astype(np.float32)
    ray_j, w_j = jsensor.sample_ray(sj, mj, jnp.asarray(pos),
                                    jnp.asarray(ap))
    ray_p, w_p = psensor.sample_ray(sp, mp, torch.from_numpy(pos),
                                    torch.from_numpy(ap))
    for f in ('o', 'd', 'mint', 'maxt'):
        a, b = getattr(ray_p, f).numpy(), np.asarray(getattr(ray_j, f))
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6, err_msg=f)
    assert (w_p.numpy() == np.asarray(w_j)).all()
    if name == 'thinlens':
        # the lens spreads the origins over the aperture
        spread = np.linalg.norm(ray_p.o.numpy() - (0.3, 0.2, -3.0), axis=1)
        assert 0.09 < spread.max() <= 0.1 + 1e-6
