"""The port's microfacet distributions and Beckmann warp against the
reference's, on the same 4,096 random directions and samples from a numpy
seed: D, Smith G1, VNDF sampling and its pdf, for GGX and Beckmann,
isotropic and anisotropic roughness.

Tolerance: 1e-5 relative, with an absolute floor of 1e-5 of the largest
magnitude (the reference runs op by op, so XLA fuses nothing; the two
libraries' sin, cos, exp and log differ in the last bit at most, and D
spans six decades near grazing half vectors). Sampled unit vectors are
held within 4e-5 absolute: sin = sqrt(1 - cos^2) turns a one-ulp
difference of a cosine near 1 into cos / sin ulps (about 1e-5 at
sin = 0.01)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_nlvrl_tpu.core import microfacet as jmf
from mitsuba_nlvrl_tpu.core import warp as jwarp
from mitsuba_nlvrl_tpu_torch.core import microfacet as pmf
from mitsuba_nlvrl_tpu_torch.core import warp as pwarp

torch.set_num_threads(1)   # one intra-op thread a test worker

RTOL = 1e-5
DIR_ATOL = 4e-5
N = 4096
ROUGHNESS = {'isotropic': (0.3, 0.3), 'anisotropic': (0.1, 0.45)}
DISTRIBUTIONS = {'ggx': pmf.GGX, 'beckmann': pmf.BECKMANN}


def _close(got, ref, name, atol=None):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, name
    if atol is None:
        atol = RTOL * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=name)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    h = rng.normal(size=(N, 3)).astype(np.float32)
    h[:, 2] = np.abs(h[:, 2]) + 0.05
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    u = rng.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    wi = v.copy()
    wi[:, 2] = np.abs(wi[:, 2]) + 1e-3     # the samplers want wi above
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    return v, h, u, wi


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize('rough', list(ROUGHNESS))
def test_distributions_match_reference(rough):
    ax, ay = ROUGHNESS[rough]
    v, h, _, _ = _inputs(1)
    (jv, jh), (tv, th) = _both(v, h)
    _close(pmf.ggx_d(th, ax, ay), jmf.ggx_d(jh, ax, ay), 'ggx_d')
    _close(pmf.beckmann_d(th, ax, ay), jmf.beckmann_d(jh, ax, ay),
           'beckmann_d')
    for name, code in DISTRIBUTIONS.items():
        _close(pmf.smith_g1(tv, th, ax, ay, code),
               jmf.smith_g1(jv, jh, ax, ay, code), f'smith_g1 {name}')


@pytest.mark.parametrize('dist', list(DISTRIBUTIONS))
@pytest.mark.parametrize('rough', list(ROUGHNESS))
def test_vndf_sampling_matches_reference(dist, rough):
    ax, ay = ROUGHNESS[rough]
    code = DISTRIBUTIONS[dist]
    _, h, u, wi = _inputs(2)
    (jwi, jh, ju), (twi, th, tu) = _both(wi, h, u)
    ax_j, ay_j = jnp.full((N,), ax), jnp.full((N,), ay)
    ax_t, ay_t = torch.full((N,), ax), torch.full((N,), ay)
    h_ref, pdf_ref = jmf.sample_vndf(jwi, ju, ax_j, ay_j, code)
    h_got, pdf_got = pmf.sample_vndf(twi, tu, ax_t, ay_t, code)
    _close(h_got, h_ref, 'sampled h', DIR_ATOL)
    _close(pdf_got, pdf_ref, 'sampled pdf')
    assert (pdf_got.numpy() >= 0).all() and np.isfinite(pdf_got.numpy()).all()
    _close(pmf.vndf_pdf(twi, th, ax_t, ay_t, code),
           jmf.vndf_pdf(jwi, jh, ax_j, ay_j, code), 'vndf_pdf')


def test_beckmann_warp_matches_reference():
    _, h, u, _ = _inputs(3)
    (jh, ju), (th, tu) = _both(h, u)
    for alpha in (0.05, 0.3, 0.8):
        _close(pwarp.square_to_beckmann(tu, alpha),
               jwarp.square_to_beckmann(ju, alpha), f'warp {alpha}',
               DIR_ATOL)
        _close(pwarp.square_to_beckmann_pdf(th, alpha),
               jwarp.square_to_beckmann_pdf(jh, alpha), f'pdf {alpha}')
