"""The port's Mueller calculus (``core/mueller.py``) against the
reference's, function by function, on seeded numpy inputs: the element
constructors, the dielectric Fresnel amplitudes and Mueller matrices
(total internal reflection and grazing lanes among them), the conductor's
(with RGB and wavelength axes) and the Stokes-frame rotations.

Tolerances: 1e-6 relative (2e-6 absolute on entries near zero) for the
constructors, the Fresnel amplitudes and matrices and the conductor's;
1e-5 relative and absolute for the Stokes-frame rotations (1e-4 for the
Mueller basis changes), where asin near 1 and chained 4x4 products
magnify an ulp of the frames (measured: 4.4e-6 and 1.2e-5 at most);
2e-3 relative on the lanes within
1e-4 of the critical angle, where the transmitted cosine is the square
root of 1 - eta^2 sin^2, a difference of nearly equal numbers (an ulp of
it is 1e-3 of the result, and the reference's compiled function rounds
it otherwise than the same expression compiled alone)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_nlvrl_tpu.core import mueller as jmu
from mitsuba_nlvrl_tpu_torch.core import mueller as pmu

from torch_parity import ieee_jit

N = 1024


def _close(a, b, rtol=1e-6, atol=2e-6, what=''):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


CRITICAL = slice(68, 132)


def _cosines(rng):
    """Signed cosines: uniform, grazing (|cos| < 1e-3), exactly 0 and 1,
    and both sides of the TIR critical angle of eta 1.5 seen from
    inside (``CRITICAL``)."""
    c = rng.uniform(-1.0, 1.0, N)
    c[:64] = rng.uniform(-1e-3, 1e-3, 64)
    c[64:68] = (0.0, -0.0, 1.0, -1.0)
    crit = np.sqrt(1.0 - 1.0 / 1.5 ** 2)
    c[CRITICAL] = -crit + rng.uniform(-1e-4, 1e-4, 64)
    return c.astype(np.float32)


def _close_away_from_critical(a, b, what):
    """1e-6 off the critical band, 2e-3 relative on it."""
    a, b = a.numpy(), np.asarray(b)
    near = np.zeros(N, bool)
    near[CRITICAL] = True
    _close(a[~near], b[~near], what=what)
    _close(a[near], b[near], 2e-3, 1e-5, what + ' (critical band)')


def _vectors(rng, n=N):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_element_constructors_match_reference():
    rng = np.random.default_rng(1)
    v = rng.uniform(0.0, 2.0, N).astype(np.float32)
    th = rng.uniform(-7.0, 7.0, N).astype(np.float32)
    M = rng.normal(size=(N, 4, 4)).astype(np.float32)
    _close(pmu.depolarizer(torch.as_tensor(v)), jmu.depolarizer(v))
    _close(pmu.absorber(torch.as_tensor(v)), jmu.absorber(v))
    _close(pmu.linear_polarizer(torch.as_tensor(v)), jmu.linear_polarizer(v))
    _close(pmu.linear_polarizer(), jmu.linear_polarizer())
    _close(pmu.linear_retarder(torch.as_tensor(th)), jmu.linear_retarder(th))
    _close(pmu.diattenuator(torch.as_tensor(v), torch.as_tensor(v[::-1]
                                                                .copy())),
           jmu.diattenuator(v, v[::-1]))
    _close(pmu.rotator(torch.as_tensor(th)), jmu.rotator(th))
    _close(pmu.rotated_element(torch.as_tensor(th), torch.as_tensor(M)),
           jmu.rotated_element(th, M))


@pytest.mark.parametrize('eta', [1.5, 1.0 / 1.33])
def test_dielectric_fresnel_matches_reference(eta):
    """The complex amplitudes and the Mueller matrices of reflection and
    transmission, total internal reflection and grazing lanes included;
    under TIR the phase delay's sign is the reference's."""
    c = _cosines(np.random.default_rng(2))
    e = np.full(N, eta, np.float32)
    got = pmu.fresnel_polarized(torch.as_tensor(c), torch.as_tensor(e))
    ref = ieee_jit(jmu.fresnel_polarized)(c, e)
    for i, (a, b) in enumerate(zip(got, ref)):
        if torch.is_complex(a):
            _close(a.real, jnp.real(b), what=f'amp {i} real')
            _close(a.imag, jnp.imag(b), what=f'amp {i} imag')
        else:
            _close(a, b, what=f'term {i}')
    tir = np.asarray(ref[2]) == 0.0
    assert tir.any()
    R_p = pmu.specular_reflection(torch.as_tensor(c), torch.as_tensor(e))
    R_j = ieee_jit(jmu.specular_reflection)(c, e)
    _close_away_from_critical(R_p, R_j, 'reflection')
    # the phase delay under TIR: S3's sign from the (2, 3) entry
    if tir.any():
        s_p = np.sign(R_p.numpy()[tir, 2, 3])
        s_j = np.sign(np.asarray(R_j)[tir, 2, 3])
        assert (s_p == s_j).all()
    T_p = pmu.specular_transmission(torch.as_tensor(c), torch.as_tensor(e))
    _close_away_from_critical(T_p, ieee_jit(jmu.specular_transmission)(c, e),
                              'transmission')


def test_conductor_reflection_matches_reference():
    """Scalar, RGB and per-wavelength complex IORs, grazing lanes too."""
    rng = np.random.default_rng(3)
    c = np.abs(_cosines(rng))
    eta = rng.uniform(0.1, 3.0, (N, 3)).astype(np.float32)
    k = rng.uniform(0.0, 5.0, (N, 3)).astype(np.float32)
    f = ieee_jit(jmu.specular_reflection_conductor)
    _close(pmu.specular_reflection_conductor(
        torch.as_tensor(c), torch.as_tensor(eta), torch.as_tensor(k)),
        f(c, eta, k), what='rgb')
    _close(pmu.specular_reflection_conductor(
        torch.as_tensor(c), torch.as_tensor(eta[:, 0]),
        torch.as_tensor(k[:, 0])),
        f(c, eta[:, 0], k[:, 0]), what='scalar')


def test_stokes_frames_match_reference():
    rng = np.random.default_rng(4)
    fwd, a, b = _vectors(rng), _vectors(rng), _vectors(rng)
    # near-parallel pairs for unit_angle (antiparallel bases are left out:
    # asin at 1 and the sign of a vanishing cross product make the
    # rotation a coin flip there in either package)
    b[:32] = a[:32] + 1e-4 * _vectors(rng, 32)
    M = rng.normal(size=(N, 4, 4)).astype(np.float32)
    T = torch.as_tensor
    _close(pmu.stokes_basis(T(fwd)), jmu.stokes_basis(fwd))
    _close(pmu.unit_angle(T(a), T(b)), jmu.unit_angle(a, b), 1e-5, 1e-5)
    _close(pmu.rotate_stokes_basis(T(fwd), T(a), T(b)),
           jmu.rotate_stokes_basis(fwd, a, b), 1e-5, 1e-5)
    _close(pmu.rotate_mueller_basis(T(M), T(fwd), T(a), T(b), T(-fwd),
                                    T(b), T(a)),
           jmu.rotate_mueller_basis(M, fwd, a, b, -fwd, b, a), 1e-4, 1e-4)
    _close(pmu.rotate_mueller_basis_collinear(T(M), T(fwd), T(a), T(b)),
           jmu.rotate_mueller_basis_collinear(M, fwd, a, b), 1e-4, 1e-4)


def test_malus_law_and_quarter_wave_plate():
    """Physics the port keeps: Malus's law through two polarizers, and a
    quarter-wave plate at 45 degrees making linear light circular."""
    S = torch.tensor([1.0, 1.0, 0.0, 0.0])
    for th in (0.0, 0.3, 1.0, np.pi / 2):
        M = pmu.rotated_element(torch.tensor(th, dtype=torch.float32),
                                pmu.linear_polarizer())
        assert abs(float((M @ S)[0]) - np.cos(th) ** 2) < 1e-6
    q = pmu.rotated_element(torch.tensor(np.pi / 4, dtype=torch.float32),
                            pmu.linear_retarder(
                                torch.tensor(np.pi / 2,
                                             dtype=torch.float32)))
    out = (q @ S).numpy()
    np.testing.assert_allclose(np.abs(out), [1, 0, 0, 1], atol=1e-6)
