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


def _reference_words(key, counters):
    """The reference's threefry words of 64-bit element counters: the
    partitionable threefry hashes each counter as its (high, low) words."""
    from jax.extend.random import threefry_2x32
    c = counters.reshape(-1).astype(np.uint64)
    hi, lo = (c >> np.uint64(32)).astype(np.uint32), c.astype(np.uint32)
    k = jnp.asarray(key.numpy().astype(np.uint32))
    out = np.asarray(threefry_2x32((k[0], k[1]), jnp.concatenate(
        [jnp.asarray(hi), jnp.asarray(lo)]))).astype(np.uint64)
    return out[:c.size], out[c.size:]


def _uniform_from_words(a, b, dtype):
    """jax.random.uniform's float of an element's two threefry words."""
    if dtype == torch.float64:
        m = ((a << np.uint64(32)) | b) >> np.uint64(12)
        return (m | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
    m = ((a ^ b) >> np.uint64(9)).astype(np.uint32)
    return (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_draws_past_2_32_elements_match_threefry(dtype):
    """A draw at lanes of a wavefront whose draw holds more than 2^32
    elements ((8, 2^28, 3): counters up to 6,442,450,943) takes the
    reference's bits; below 2^32 the same words give jax's own draw."""
    total, ids = 2 ** 28, np.array([0, 1, 2 ** 28 - 1], np.int64)
    key = rng.fold_in(rng.PRNGKey(7), 3)
    got = rng.uniform(key, (8, ids.size, 3), dtype=dtype, axis=1,
                      lanes=rng.Lanes(torch.as_tensor(ids), total)).numpy()
    counters = (np.arange(8)[:, None, None] * (total * 3)
                + ids[None, :, None] * 3 + np.arange(3)[None, None])
    assert counters.max() == 24 * 2 ** 28 - 1 > 2 ** 32
    want = _uniform_from_words(*_reference_words(key, counters), dtype)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.reshape(got.shape).tobytes()
    with jax.enable_x64(dtype == torch.float64):
        small = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(5), (4, 5),
            jnp.float64 if dtype == torch.float64 else jnp.float32))
    ref = _uniform_from_words(*_reference_words(rng.PRNGKey(5),
                                                np.arange(20)), dtype)
    assert small.reshape(-1).tobytes() == ref.tobytes()
    assert rng.uniform(rng.PRNGKey(5), (4, 5), dtype=dtype).numpy() \
        .tobytes() == small.tobytes()
