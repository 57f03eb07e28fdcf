"""The port's threefry stream reproduces jax.random bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.core.rng import Sampler as JSampler
from mitsuba_nlvrl_tpu_torch.core import rng

torch.set_num_threads(1)   # one intra-op thread a test worker


def _bits(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize('seed', [0, 1, 77, 123456789, 2**32 - 1])
def test_keys_match(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    assert (_bits(kj) == kt.numpy()).all()
    for data in (0, 1, 5, 0x9e3779b9, 2**32 - 1):
        assert (_bits(jax.random.fold_in(kj, data))
                == rng.fold_in(kt, data).numpy()).all()
    (aj, bj), (at, bt) = jax.random.split(kj), rng.split(kt)
    assert (_bits(aj) == at.numpy()).all()
    assert (_bits(bj) == bt.numpy()).all()


@pytest.mark.parametrize('seed', [0, 3, 2024])
@pytest.mark.parametrize('shape', [(1,), (7,), (1000, 2)])
def test_uniform_bits_match(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    kt = rng.fold_in(rng.PRNGKey(seed), 11)
    uj = np.asarray(jax.random.uniform(kj, shape, jnp.float32))
    ut = rng.uniform(kt, shape).numpy()
    assert ut.dtype == np.float32 and ut.shape == shape
    assert uj.tobytes() == ut.tobytes()
    assert (ut >= 0).all() and (ut < 1).all()


def test_sampler_stream_matches():
    N = 513
    sj = JSampler.make(jax.random.PRNGKey(9), N)
    st = rng.Sampler.make(rng.PRNGKey(9), N)
    mask = np.arange(N) % 3 == 0
    for step in range(6):
        if step % 2:
            uj, sj = sj.next_2d()
            ut, st = st.next_2d()
        else:
            uj, sj = sj.next_1d()
            ut, st = st.next_1d()
        assert np.asarray(uj).tobytes() == ut.numpy().tobytes(), step
        sj = sj.count_rays(jnp.asarray(mask))
        st = st.count_rays(torch.as_tensor(mask))
    assert float(sj.rays) == float(st.rays) == 6 * mask.sum()
    fj, ft = sj.fork(5), st.fork(5)
    uj, _ = fj.next_1d()
    ut, _ = ft.next_1d()
    assert np.asarray(uj).tobytes() == ut.numpy().tobytes()
