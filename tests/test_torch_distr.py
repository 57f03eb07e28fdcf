"""The port's 1D distributions and hierarchical 2D warp against the
reference's.

Tolerances: the Hierarchical2D tables equal in bits (both built in
numpy); sampled indices equal; sampled positions, densities and inverted
samples 1e-5 relative with an absolute floor of 1e-5 of the largest
value, the reference's warp run op by op (eagerly: no fused
multiply-adds), except the warped positions: 1e-5 relative
on 99.9% of the lanes and 1e-4 absolute on all. Where a cell's density is
almost constant along an axis, the reference's inverse of the linear
density divides two nearly equal differences (``_interval_to_linear``),
which magnifies a last-bit difference of the interpolated corner values
a thousandfold. A reused discrete sample's mass agrees within 1e-5 of the
total (the two libraries' cumulative sums round apart)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.core import distr as jdistr
from mitsuba_nlvrl_tpu.core import distr2d as jd2
from mitsuba_nlvrl_tpu_torch.core import distr as pdistr
from mitsuba_nlvrl_tpu_torch.core import distr2d as pd2

torch.set_num_threads(1)   # one intra-op thread a test worker

RTOL = 1e-5
N = 4096


def _close(got, ref, name):
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    atol = RTOL * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=name)


def _u(seed, shape=(N,)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_discrete_distribution():
    pmf = np.random.default_rng(0).uniform(0, 1, 37).astype(np.float32)
    pmf[5] = 0.0
    dj = jdistr.DiscreteDistribution.make(jnp.asarray(pmf))
    dp = pdistr.DiscreteDistribution.make(pmf)
    u = _u(1)
    assert (dp.sample(torch.from_numpy(u)).numpy()
            == np.asarray(dj.sample(jnp.asarray(u)))).all()
    _close(dp.cdf, dj.cdf, 'cdf')
    ij, uj = dj.sample_reuse(jnp.asarray(u))
    ip, up = dp.sample_reuse(torch.from_numpy(u))
    assert (ip.numpy() == np.asarray(ij)).all()
    # the reused sample is (u * total - cdf[i - 1]) / pmf[i]: the two
    # libraries' cumulative sums round apart, so compare the mass
    # u_reuse * pmf[i], which that rounding moves by 1e-5 of the total
    w = pmf[ip.numpy()]
    np.testing.assert_allclose(up.numpy() * w, np.asarray(uj) * w, rtol=0,
                               atol=RTOL * float(pmf.sum()))
    idx = np.arange(37, dtype=np.int32)
    _close(dp.eval_pmf_normalized(torch.from_numpy(idx)),
           dj.eval_pmf_normalized(jnp.asarray(idx)), 'pmf')


@pytest.mark.parametrize('kind', ['regular', 'irregular'])
def test_continuous_distributions(kind):
    rng = np.random.default_rng(2)
    pdf = rng.uniform(0.0, 2.0, 23).astype(np.float32)
    pdf[7:9] = 0.0
    if kind == 'regular':
        dj = jdistr.ContinuousDistribution.make(jnp.asarray(pdf), 360.0,
                                                830.0)
        dp = pdistr.ContinuousDistribution.make(pdf, 360.0, 830.0)
        lo, hi = 350.0, 840.0
    else:
        nodes = np.sort(rng.uniform(0.0, 10.0, 23)).astype(np.float32)
        dj = jdistr.IrregularContinuousDistribution.make(
            jnp.asarray(nodes), jnp.asarray(pdf))
        dp = pdistr.IrregularContinuousDistribution.make(nodes, pdf)
        lo, hi = -1.0, 11.0
    u = _u(3)
    _close(dp.sample(torch.from_numpy(u)), dj.sample(jnp.asarray(u)),
           'sample')
    x = np.linspace(lo, hi, 999).astype(np.float32)
    _close(dp.eval_pdf(torch.from_numpy(x)), dj.eval_pdf(jnp.asarray(x)),
           'eval_pdf')


GRIDS = {
    'env_512x256': (256, 512),
    'odd_37x91': (37, 91),
    'tall_65x3': (65, 3),
    'row_1x9': (1, 9),
}


def _grid(shape, seed=4):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, shape) ** 3
    g[: shape[0] // 3] *= 0.01
    return (g + 1e-12).astype(np.float32)


@pytest.mark.parametrize('name', list(GRIDS))
def test_hierarchical_tables_equal_in_bits(name):
    g = _grid(GRIDS[name])
    ref = jd2.build_hierarchical(g)
    nodes, levels = pd2.build_hierarchical_np(g)
    assert nodes.tobytes() == np.asarray(ref.nodes).tobytes()
    assert len(levels) == len(ref.levels)
    for a, b in zip(levels, ref.levels):
        assert a.shape == b.shape and a.tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize('name', list(GRIDS))
def test_hierarchical_sample_eval_invert(name):
    g = _grid(GRIDS[name])
    dj = jd2.build_hierarchical(g)
    dp = pd2.build_hierarchical(g)
    u = _u(5, (N, 2))
    pos_j, pdf_j = (jd2.sample_hierarchical)(dj, jnp.asarray(u))
    pos_p, pdf_p = pd2.sample_hierarchical(dp, torch.from_numpy(u))
    got, ref = pos_p.numpy(), np.asarray(pos_j)
    near = np.abs(got - ref) <= RTOL * np.abs(ref) + RTOL
    assert near.mean() >= 0.999, near.mean()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    _close(pdf_p, pdf_j, 'pdf')
    # the density where the warp put the samples, and the inverse of the
    # warp there, at the reference's positions
    at = np.asarray(pos_j)
    _close(pd2.eval_hierarchical(dp, torch.from_numpy(at)),
           (jd2.eval_hierarchical)(dj, jnp.asarray(at)), 'eval')
    u_j, ipdf_j = (jd2.invert_hierarchical)(dj, jnp.asarray(at))
    u_p, ipdf_p = pd2.invert_hierarchical(dp, torch.from_numpy(at))
    _close(u_p, u_j, 'invert')
    _close(ipdf_p, ipdf_j, 'invert pdf')
    # the inverse undoes the warp
    np.testing.assert_allclose(u_p.numpy(), u, atol=2e-3)
