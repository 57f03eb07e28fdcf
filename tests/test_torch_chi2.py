"""The port's chi-square harness (``testing/chi2.py``) and the sampling it
holds to the pdfs: the warps of ``core/warp.py`` that slice 10 adds and
those the tests of the reference hold (cosine, sphere, Beckmann), the HG
phase, the rough conductor, the measured BSDF and the measured polarized
mixture.

The harness against the reference's: the same uniforms (the reference's
``jax.random.uniform(PRNGKey(seed), (count, dim))``, drawn by the port's
``core/rng``) equal in bits; on the same warped samples, the histogram
equal and the integrated pdf table within 1e-5 relative (the pdf runs
in float32 in both packages); the p-value within 1e-5 (the port's
``torch.special.gammaincc`` in float64 against the reference's
``jax.scipy.special.gammaincc`` in float32). The triangle's pdf is
integrated on a finer subgrid (its cells along the diagonal are cut by
the edge). The
samplers: the reference's significance levels (0.005, 0.002 for the rough
conductor), 400,000 samples on a 32 x 64 sphere grid, as in the
reference's tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.core import warp as jwarp
from mitsuba_nlvrl_tpu.testing import chi2 as jchi2
from mitsuba_nlvrl_tpu_torch import bsdf as pbsdf
from mitsuba_nlvrl_tpu_torch import phase as pphase
from mitsuba_nlvrl_tpu_torch.bsdf import measured as pmeas
from mitsuba_nlvrl_tpu_torch.bsdf import measured_pol as pmp
from mitsuba_nlvrl_tpu_torch.core import math as pm
from mitsuba_nlvrl_tpu_torch.core import warp as pwarp
from mitsuba_nlvrl_tpu_torch.scene import types as T
from mitsuba_nlvrl_tpu_torch.testing import chi2 as pchi2
from mitsuba_nlvrl_tpu_torch.testing import scenes as pscenes

torch.set_num_threads(1)   # one intra-op thread a test worker


def _sphere_test(sf, pf, dim=2, level=0.005):
    test = pchi2.ChiSquareTest(pchi2.SphericalDomain(), sf, pf,
                               sample_count=400_000, res=32, sample_dim=dim)
    assert test.run(level), test.messages


def _nan_unless(ok, wo):
    return torch.where(ok[:, None], wo, float('nan'))


def test_harness_tables_equal_the_reference_harness():
    """The same warped samples give the same histogram, the same pdf
    table and the same p-value in both harnesses."""
    kw = dict(sample_count=50_000, res=16, seed=3)
    tj = jchi2.ChiSquareTest(jchi2.SphericalDomain(),
                             jwarp.square_to_cosine_hemisphere,
                             jwarp.square_to_cosine_hemisphere_pdf, **kw)
    tp = pchi2.ChiSquareTest(pchi2.SphericalDomain(),
                             pwarp.square_to_cosine_hemisphere,
                             pwarp.square_to_cosine_hemisphere_pdf, **kw)
    u = tp.samples().numpy()
    assert u.tobytes() == np.asarray(jax.random.uniform(
        jax.random.PRNGKey(3), (50_000, 2))).tobytes()
    # one set of warped samples (the reference's) through both harnesses
    wo = np.asarray(jwarp.square_to_cosine_hemisphere(jnp.asarray(u)))
    tj.sample_func = lambda _: wo
    tp.sample_func = lambda _: torch.tensor(wo)
    ok_j, ok_p = tj.run(0.01), tp.run(0.01)
    assert ok_j and ok_p
    assert np.array_equal(tp.histogram, tj.histogram)
    np.testing.assert_allclose(tp.pdf, tj.pdf, rtol=1e-5)
    assert abs(tp.p_value - tj.p_value) <= 1e-5, (tp.p_value, tj.p_value)
    # the port's warp puts the reference's uniforms in the same cells
    # but where an ulp of cos/sin moves a sample across a cell edge
    tp.sample_func = pwarp.square_to_cosine_hemisphere
    tp.tabulate_histogram()
    assert np.abs(tp.histogram - tj.histogram).sum() <= 4


SPHERE_WARPS = {
    'cosine': (pwarp.square_to_cosine_hemisphere,
               pwarp.square_to_cosine_hemisphere_pdf),
    'sphere': (pwarp.square_to_uniform_sphere,
               pwarp.square_to_uniform_sphere_pdf),
    'hemisphere': (pwarp.square_to_uniform_hemisphere,
                   lambda d: torch.where(
                       d[:, 2] >= 0,
                       pwarp.square_to_uniform_hemisphere_pdf(d), 0.0)),
    'beckmann': (lambda u: pwarp.square_to_beckmann(u, 0.3),
                 lambda d: pwarp.square_to_beckmann_pdf(d, 0.3)),
    'cone': (lambda u: pwarp.square_to_uniform_cone(u, 0.6),
             lambda d: torch.where(d[:, 2] >= 0.6,
                                   pwarp.square_to_uniform_cone_pdf(d, 0.6),
                                   0.0)),
    'von_mises_fisher': (
        lambda u: pwarp.square_to_von_mises_fisher(u, 5.0),
        lambda d: pwarp.square_to_von_mises_fisher_pdf(d, 5.0)),
}


@pytest.mark.parametrize('name', list(SPHERE_WARPS))
def test_sphere_warps(name):
    sf, pf = SPHERE_WARPS[name]
    _sphere_test(sf, pf)


PLANE_WARPS = {
    'disk': (pwarp.square_to_uniform_disk, pwarp.square_to_uniform_disk_pdf,
             None),
    'disk_concentric': (pwarp.square_to_uniform_disk_concentric,
                        pwarp.square_to_uniform_disk_pdf, None),
    'triangle': (pwarp.square_to_uniform_triangle,
                 pwarp.square_to_uniform_triangle_pdf, [[0, 1], [0, 1]]),
    'tent': (pwarp.square_to_tent, pwarp.square_to_tent_pdf, None),
    'square': (pwarp.square_to_uniform_square, lambda p: torch.ones(
        p.shape[:-1]), [[0, 1], [0, 1]]),
    'linear': (lambda u: torch.stack([pwarp.interval_to_linear(
        torch.tensor(0.2), torch.tensor(1.4), u[:, 0]), u[:, 1]], -1),
        lambda p: (0.2 + 1.2 * p[:, 0]) / 0.8, [[0, 1], [0, 1]]),
}


@pytest.mark.parametrize('name', list(PLANE_WARPS))
def test_plane_warps(name):
    sf, pf, bounds = PLANE_WARPS[name]
    test = pchi2.ChiSquareTest(pchi2.PlanarDomain(bounds), sf, pf,
                               sample_count=200_000, res=32,
                               ires=32 if name == 'triangle' else 8)
    assert test.run(0.005), test.messages


def test_std_normal_warp_moments():
    """The standard normal warp has no pdf in either package: its samples'
    moments, and its values equal the reference's."""
    u = pchi2.ChiSquareTest(None, None, None, sample_count=200_000).samples()
    p = pwarp.square_to_std_normal(u).numpy()
    assert abs(p.mean()) < 0.01 and abs(p.std() - 1.0) < 0.01
    q = np.asarray(jwarp.square_to_std_normal(jnp.asarray(u.numpy())))
    np.testing.assert_allclose(p, q, rtol=1e-5, atol=1e-5)


def test_hg_phase():
    g = -0.4
    params = torch.zeros((1, T.MEDIUM_NPARAM))
    params[0, T.M_PHASE_G] = g

    class S:
        media = type('Media', (), {
            'phase_type': torch.tensor([T.PHASE_TYPES['hg']]),
            'params': params})

    class M:
        phase_types = (T.PHASE_TYPES['hg'],)

    def wi(n):
        return torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.int32)

    def ones(n):
        return torch.ones((n,), dtype=torch.bool)

    _sphere_test(
        lambda u: pphase.sample(S, M, zeros(len(u)), wi(len(u)), u,
                                ones(len(u)))[0],
        lambda d: pphase.eval(S, M, zeros(len(d)), wi(len(d)), d,
                              ones(len(d))))


def test_roughconductor():
    _, _, p = pbsdf.pack_params({'type': 'roughconductor', 'alpha': 0.3})
    P1 = torch.tensor([p], dtype=torch.float32)
    wi = pm.normalize(torch.tensor([[0.3, 0.2, 0.9]]))

    def sf(u):
        bs, _ = pbsdf._roughconductor_sample(P1.expand(len(u), -1),
                                             wi.expand(len(u), 3), None, u,
                                             0)
        return _nan_unless(bs.pdf > 0, bs.wo)

    _sphere_test(sf, lambda d: pbsdf._roughconductor_pdf(
        P1.expand(len(d), -1), wi.expand(len(d), 3), d), level=0.002)


def test_measured():
    data, mm = pmeas.load_fields(pscenes.measured_fields())
    t = 0.5
    wi = torch.tensor([[np.sin(t), 0.0, np.cos(t)]], dtype=torch.float32)

    def sf(u):
        wo, pdf, _ = pmeas.sample(data, mm, wi.expand(len(u), 3), u[:, :2])
        return _nan_unless(pdf > 0, wo)

    _sphere_test(sf, lambda d: pmeas.pdf(data, mm, wi.expand(len(d), 3), d))


def test_measured_polarized_mixture():
    data = pmp.load_fields(pscenes.measured_pol_fields())
    t = 0.6
    wi = torch.tensor([[np.sin(t), 0.0, np.cos(t)]], dtype=torch.float32)

    def params(n):
        P = torch.zeros((n, 20))
        P[:, 1], P[:, 2] = 0.3, -1.0
        return P

    def sf(u):
        n = len(u)
        wo, pdf, _ = pmp.sample(data, params(n), wi.expand(n, 3), u[:, 2],
                                u[:, :2])
        return _nan_unless(pdf > 0, wo)

    _sphere_test(sf, lambda d: pmp.pdf(params(len(d)), wi.expand(len(d), 3),
                                       d), dim=3)
