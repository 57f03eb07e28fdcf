"""The port's Marginal2D warps (continuous and discrete) against the
reference's, conditioned on up to three parameters and unconditioned.

Tolerance: equal in bits. The tables are built in numpy by both packages;
the reference's warps run op by op (eagerly: no fused multiply-adds), as
the port's do, and both search with the same fixed number of steps, so
every lane's position, density and inverted sample agree to the bit. The
grids have rows of zero density (a flat run of the marginal CDF) and
parameters outside their grids (clamped to the end slices)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.core import distr2d as jd2
from mitsuba_nlvrl_tpu_torch.core import distr2d as pd2

torch.set_num_threads(1)   # one intra-op thread a test worker

N = 4096
RES = (17, 23)

# (parameter grids, the parameters' draw range) by conditioning case
CASES = {
    'none': ((), ()),
    'one': ((np.array([0.0, 0.4, 1.0], np.float32),), ((-0.2, 1.2),)),
    'two': ((np.linspace(-1, 2, 3).astype(np.float32),
             np.array([0, 0.3, 0.5, 1.5], np.float32)),
            ((-1.2, 2.2), (-0.1, 1.6))),
    'three': ((np.array([-np.pi, np.pi], np.float32),
               np.linspace(0, 1.5, 4).astype(np.float32),
               np.array([420, 500, 580, 660], np.float32)),
              ((-3.2, 3.2), (0.0, 1.6), (400, 700))),
}
KINDS = {
    'continuous': (jd2.build, pd2.build, jd2.sample, pd2.sample, jd2.invert,
                   pd2.invert),
    'discrete': (jd2.build_discrete, pd2.build_discrete, jd2.sample_discrete,
                 pd2.sample_discrete, jd2.invert_discrete,
                 pd2.invert_discrete),
}


def _case(name, seed=0):
    pv, ranges = CASES[name]
    rng = np.random.default_rng(seed)
    shape = tuple(len(p) for p in pv) + RES
    g = rng.uniform(0, 1, shape).astype(np.float32) ** 3
    g[..., 3:5, :] = 0.0                 # two rows of zero density
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    prm = tuple(rng.uniform(lo, hi, N).astype(np.float32)
                for lo, hi in ranges)
    return g, pv, u, prm


def _eq(got, ref, what):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert got.tobytes() == ref.tobytes(), (
        what, float(np.abs(got - ref).max()))


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('name', list(CASES))
def test_marginal2d_equal_in_bits(kind, name):
    build_j, build_p, sample_j, sample_p, invert_j, invert_p = KINDS[kind]
    g, pv, u, prm = _case(name)
    dj, dp = build_j(g, pv), build_p(g, pv)
    for f in ('data', 'marg_cdf', 'cond_cdf'):
        _eq(getattr(dp, f), getattr(dj, f), f)
    pj = tuple(jnp.asarray(x) for x in prm)
    pp = tuple(torch.from_numpy(x) for x in prm)
    pos_j, pdf_j = sample_j(dj, jnp.asarray(u), pj)
    pos_p, pdf_p = sample_p(dp, torch.from_numpy(u), pp)
    _eq(pos_p, pos_j, 'sample position')
    _eq(pdf_p, pdf_j, 'sample pdf')
    at = np.array(pos_j)
    u_j, ipdf_j = invert_j(dj, jnp.asarray(at), pj)
    u_p, ipdf_p = invert_p(dp, torch.from_numpy(at), pp)
    _eq(u_p, u_j, 'inverted sample')
    _eq(ipdf_p, ipdf_j, 'inverted pdf')
    # the inverse undoes the warp
    np.testing.assert_allclose(u_p.numpy(), u, atol=2e-3)
    if kind == 'continuous':
        _eq(pd2.eval(dp, torch.from_numpy(at), pp),
            jd2.eval(dj, jnp.asarray(at), pj), 'eval')


def test_unnormalized_tables_and_float64():
    """normalize=False keeps the densities as given (the measured NDF and
    sigma); a float64 build holds the float32 tables exactly."""
    g, pv, u, prm = _case('two', seed=3)
    dj = jd2.build(g, pv, normalize=False)
    dp = pd2.build(g, pv, normalize=False)
    for f in ('data', 'marg_cdf', 'cond_cdf'):
        _eq(getattr(dp, f), getattr(dj, f), f)
    d64 = pd2.build(g, pv, normalize=False, dtype=torch.float64)
    assert d64.data.dtype == torch.float64
    assert torch.equal(d64.data.float(), dp.data)
