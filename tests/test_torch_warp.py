"""The port's warps (``core/warp.py``) against the reference's, lane by
lane: the same uniforms (the reference's ``jax.random.uniform``, drawn by
the port's ``core/rng``) through each warp, and the same points (inside
and outside each domain) through each pdf, the reference compiled with
IEEE rounding.

Tolerances, absolute, measured on 4,096 lanes (the largest difference in
brackets). Equal in bits: the square, the triangle and its pdf, the tent
and its pdf, ``interval_to_linear``, and the disk, sphere, hemisphere,
cosine and cone pdfs. The others go through torch's and XLA's float32
sin, cos, log and exp, which part by an ulp on some lanes: the disk, the
concentric disk, the sphere, the hemisphere and the cone 1.2e-7 (6.0e-8,
one ulp at 1); the standard normal 1e-6 (3.6e-7); the cosine hemisphere
2e-6 (8.4e-7: z = sqrt(1 - r^2) magnifies the disk's ulp at the horizon);
Beckmann 1e-5 (5.0e-6: sin = sqrt(1 - cos^2) near the pole) and its pdf
5e-7 (2.4e-7); von Mises-Fisher 5e-7 (2.5e-7) and its pdf 2.4e-7
(1.2e-7). The von Mises-Fisher constant exp(-2 kappa), a float64 scalar
in the port and a float32 ``jnp.exp`` in the reference, rounds to the
same float32 (``test_von_mises_fisher_constant``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import ieee_jit

from mitsuba_nlvrl_tpu.core import warp as jwarp
from mitsuba_nlvrl_tpu_torch.core import rng
from mitsuba_nlvrl_tpu_torch.core import warp as pwarp

torch.set_num_threads(1)   # one intra-op thread a test worker

N = 4096


def _inputs(kind):
    """(N, 2) uniforms, (N, 2) plane points on [-1.2, 1.2]^2 or (N, 3)
    unit vectors, all float32 from the port's threefry stream."""
    if kind == 'u':
        return rng.uniform(rng.PRNGKey(7), (N, 2))
    if kind == 'plane':
        return rng.uniform(rng.PRNGKey(8), (N, 2)) * 2.4 - 1.2
    v = rng.uniform(rng.PRNGKey(9), (N, 3)) * 2.0 - 1.0
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


# name: (function name, extra argument or None, input kind, atol)
CASES = {
    'square': ('square_to_uniform_square', None, 'u', 0.0),
    'disk': ('square_to_uniform_disk', None, 'u', 1.2e-7),
    'disk_pdf': ('square_to_uniform_disk_pdf', None, 'plane', 0.0),
    'disk_concentric': ('square_to_uniform_disk_concentric', None, 'u',
                        1.2e-7),
    'triangle': ('square_to_uniform_triangle', None, 'u', 0.0),
    'triangle_pdf': ('square_to_uniform_triangle_pdf', None, 'plane', 0.0),
    'sphere': ('square_to_uniform_sphere', None, 'u', 1.2e-7),
    'sphere_pdf': ('square_to_uniform_sphere_pdf', None, 'sphere', 0.0),
    'hemisphere': ('square_to_uniform_hemisphere', None, 'u', 1.2e-7),
    'hemisphere_pdf': ('square_to_uniform_hemisphere_pdf', None, 'sphere',
                       0.0),
    'cosine': ('square_to_cosine_hemisphere', None, 'u', 2e-6),
    'cosine_pdf': ('square_to_cosine_hemisphere_pdf', None, 'sphere', 0.0),
    'cone': ('square_to_uniform_cone', 0.6, 'u', 1.2e-7),
    'cone_pdf': ('square_to_uniform_cone_pdf', 0.6, 'sphere', 0.0),
    'std_normal': ('square_to_std_normal', None, 'u', 1e-6),
    'tent': ('square_to_tent', None, 'u', 0.0),
    'tent_pdf': ('square_to_tent_pdf', None, 'plane', 0.0),
    'beckmann': ('square_to_beckmann', 0.3, 'u', 1e-5),
    'beckmann_pdf': ('square_to_beckmann_pdf', 0.3, 'sphere', 5e-7),
    'von_mises_fisher': ('square_to_von_mises_fisher', 5.0, 'u', 5e-7),
    'von_mises_fisher_pdf': ('square_to_von_mises_fisher_pdf', 5.0,
                             'sphere', 2.4e-7),
}


@pytest.mark.parametrize('name', list(CASES))
def test_warp_matches_reference(name):
    fname, arg, kind, atol = CASES[name]
    fj, fp = getattr(jwarp, fname), getattr(pwarp, fname)
    x = _inputs(kind)
    if kind == 'u':
        assert x.numpy().tobytes() == np.asarray(jax.random.uniform(
            jax.random.PRNGKey(7), (N, 2))).tobytes()
    extra = () if arg is None else (arg,)

    def reference(v):
        out = fj(v, *extra)   # a constant pdf is a Python float
        return jnp.broadcast_to(out, v.shape[:-1]) \
            if name.endswith('_pdf') else out
    ref = np.asarray(ieee_jit(reference)(jnp.asarray(x.numpy())))
    got = np.broadcast_to(np.asarray(fp(x, *extra), np.float32), ref.shape)
    assert ref.dtype == np.float32
    if atol == 0.0:
        assert got.tobytes() == ref.tobytes(), \
            float(np.abs(got - ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    if name.endswith('_pdf'):
        assert (ref > 0).any()


def test_interval_to_linear_matches_reference():
    """Endpoints on [0, 2) (some equal, one zero) through both packages:
    equal in bits."""
    ends = rng.uniform(rng.PRNGKey(10), (N, 2)) * 2.0
    ends[::5, 1] = ends[::5, 0]
    ends[::7, 0] = 0.0
    s = rng.uniform(rng.PRNGKey(7), (N, 2))[:, 0]
    ref = np.asarray(ieee_jit(jwarp.interval_to_linear)(
        *(jnp.asarray(t.numpy()) for t in (ends[:, 0], ends[:, 1], s))))
    got = pwarp.interval_to_linear(ends[:, 0], ends[:, 1], s).numpy()
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize('kappa', [0.3, 1.0, 5.0, 20.0, 80.0])
def test_von_mises_fisher_constant(kappa):
    """exp(-2 kappa): the port's float64 ``math.exp`` rounded to float32
    as a float32 tensor's scalar operand is, and the reference's float32
    ``jnp.exp``, are the same float32."""
    ref = np.asarray(ieee_jit(lambda k: jnp.exp(-2.0 * k))(
        jnp.float32(kappa)))
    x = torch.ones(4)
    assert (x * math.exp(-2.0 * kappa)).numpy()[0] == ref
    assert np.float32(math.exp(-2.0 * kappa)) == ref
