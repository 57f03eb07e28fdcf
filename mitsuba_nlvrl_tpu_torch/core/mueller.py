"""Mueller/Stokes polarization calculus.

Port of ``mitsuba_nlvrl_tpu/core/mueller.py``: every constructor returns a
batched ``(..., 4, 4)`` Mueller matrix and every helper broadcasts over
leading wavefront dimensions. Stokes vectors are ``(..., 4)``, laid out
``[S0, S1, S2, S3]`` (radiance, horizontal/vertical, diagonal, circular).

The complex Fresnel amplitudes are ``torch.complex64`` tensors, divided,
measured and square-rooted as the reference's compiled XLA code does it
(``_cdiv``: Smith's algorithm; ``_cabs``: max * sqrt(1 + (min/max)^2);
``_csqrt``: from |z| and the real part), so both packages round alike;
torch's own complex division, magnitude and square root round
differently on the CPU and the card. ``_csqrt`` takes the imaginary
part's sign as the reference does, ignoring a signed zero: under total
internal reflection the transmitted cosine is the square root of a
negative real, which lies on the positive imaginary axis whatever the
zero's sign, and the sign of the phase delay follows from that.
"""
from __future__ import annotations

import torch

from . import math as m


def _t(x, like=None):
    """``x`` as a float32 tensor (on ``like``'s device)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    dev = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _cdiv(a, b):
    """a / b for complex tensors by Smith's algorithm. The ratio's branch
    that is not taken divides by 1 (the double ``where``), so that its
    zero cotangent meets no infinite factor where b is real."""
    ar, ai, c, d = a.real, a.imag, b.real, b.imag
    big = torch.abs(c) >= torch.abs(d)
    r = torch.where(big, d / torch.where(big, c, 1.0),
                    c / torch.where(big, 1.0, d))
    den = torch.where(big, c + d * r, d + c * r)
    re = torch.where(big, (ar + ai * r) / den, (ar * r + ai) / den)
    im = torch.where(big, (ai - ar * r) / den, (ai * r - ar) / den)
    return torch.complex(re, im)


def _cabs(z):
    """|z| of a complex tensor as max * sqrt(1 + (min / max)^2)."""
    x, y = torch.abs(z.real), torch.abs(z.imag)
    mx, mn = torch.maximum(x, y), torch.minimum(x, y)
    r = mn / torch.where(mx > 0, mx, 1.0)
    return torch.where(mx > 0, m.sqrt(1.0 + r * r) * mx, 0.0)


def _csqrt(z):
    """The principal square root of a complex tensor, its imaginary part's
    sign that of z's imaginary part (a signed zero counts as +)."""
    a, b = z.real, z.imag
    t = m.sqrt((torch.abs(a) + _cabs(z)) * 0.5)
    t2 = torch.where(t > 0, 2.0 * t, 1.0)
    u = torch.where(a >= 0, t, torch.abs(b) / t2)
    v = torch.where(a >= 0, b / t2, torch.where(b < 0, -t, t))
    return torch.complex(torch.where(t > 0, u, 0.0),
                         torch.where(t > 0, v, 0.0))


def _mat(rows, like):
    """A (..., 4, 4) matrix from 16 entries broadcastable to ``like``."""
    ent = [e.expand(like.shape) if isinstance(e, torch.Tensor)
           else torch.full_like(like, float(e)) for e in rows]
    return torch.stack([torch.stack(ent[i * 4:(i + 1) * 4], -1)
                        for i in range(4)], -2)


def depolarizer(value=1.0, like=None):
    """The ideal depolarizer: only S0 survives."""
    v = _t(value, like)
    out = torch.zeros(v.shape + (4, 4), dtype=torch.float32,
                      device=v.device)
    out[..., 0, 0] = v
    return out


def absorber(value, like=None):
    """A neutral absorber: scales the whole matrix."""
    v = _t(value, like)
    return v[..., None, None] * torch.eye(4, dtype=torch.float32,
                                          device=v.device)


def linear_polarizer(value=1.0, like=None):
    """A linear polarizer with a horizontal transmitting axis."""
    a = 0.5 * _t(value, like)
    return _mat([a, a, 0, 0,
                 a, a, 0, 0,
                 0, 0, 0, 0,
                 0, 0, 0, 0], a)


def linear_retarder(phase, like=None):
    """A linear retarder, fast axis horizontal."""
    p = _t(phase, like)
    s, c = torch.sin(p), torch.cos(p)
    one = torch.ones_like(p)
    return _mat([one, 0, 0, 0,
                 0, one, 0, 0,
                 0, 0, c, s,
                 0, 0, -s, c], p)


def diattenuator(x, y, like=None):
    """Attenuates the 0 and 90 degree field components by x and y."""
    x = _t(x, like)
    y = _t(y, like)
    a = 0.5 * (x + y)
    b = 0.5 * (x - y)
    c = m.safe_sqrt(x * y)
    return _mat([a, b, 0, 0,
                 b, a, 0, 0,
                 0, 0, c, 0,
                 0, 0, 0, c], a)


def rotator(theta, like=None):
    """The reference-frame rotator by theta radians counter-clockwise."""
    t = _t(theta, like)
    s, c = torch.sin(2.0 * t), torch.cos(2.0 * t)
    one = torch.ones_like(t)
    return _mat([one, 0, 0, 0,
                 0, c, s, 0,
                 0, -s, c, 0,
                 0, 0, 0, one], t)


def rotated_element(theta, M):
    """The optical element M rotated by theta: R(theta)^T M R(theta)."""
    R = rotator(theta, M)
    return R.transpose(-1, -2) @ M @ R


def fresnel_polarized(cos_theta_i, eta):
    """Complex s and p Fresnel amplitudes of a real-IOR dielectric, with
    the phase shift of total internal reflection. Returns (a_s, a_p,
    cos_theta_t, eta_it, eta_ti)."""
    ci_signed = _t(cos_theta_i)
    eta = _t(eta, ci_signed)
    outside = ci_signed >= 0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)
    ci = torch.abs(ci_signed)
    ctt_sqr = 1.0 - eta_ti * eta_ti * (1.0 - ci * ci)
    ctt = _csqrt(ctt_sqr.to(torch.complex64))  # imaginary under TIR
    a_s = _cdiv(ci - eta_it * ctt, ci + eta_it * ctt)
    a_p = _cdiv(eta_it * ci - ctt, eta_it * ci + ctt)
    cos_theta_t = -torch.sign(ci_signed) * ctt.real
    return a_s, a_p, cos_theta_t, eta_it, eta_ti


def _phase(prod, c, guard_c: bool):
    """cos and sin of the phase delay arg(prod)."""
    mag = _cabs(prod)
    cos_d = torch.where(mag > 0, prod.real / m.clip(mag, min=1e-20),
                        0.0) if guard_c else \
        prod.real / m.clip(mag, min=1e-20)
    sin_d = torch.where(mag > 0, prod.imag / m.clip(mag, min=1e-20),
                        0.0) if guard_c else \
        prod.imag / m.clip(mag, min=1e-20)
    if guard_c:
        cos_d = torch.where(c == 0, 0.0, cos_d)
        sin_d = torch.where(c == 0, 0.0, sin_d)
    return cos_d, sin_d


def specular_reflection(cos_theta_i, eta):
    """The Mueller matrix of specular reflection off a dielectric."""
    a_s, a_p, _, _, _ = fresnel_polarized(cos_theta_i, eta)
    r_s, r_p = _cabs(a_s), _cabs(a_p)
    r_s, r_p = r_s * r_s, r_p * r_p
    a = 0.5 * (r_s + r_p)
    b = 0.5 * (r_s - r_p)
    c = m.sqrt(r_s * r_p)
    # phase delay delta = arg(a_p) - arg(a_s)
    cos_d, sin_d = _phase(a_p * torch.conj(a_s), c, True)
    return _mat([a, b, 0, 0,
                 b, a, 0, 0,
                 0, 0, c * cos_d, -c * sin_d,
                 0, 0, c * sin_d, c * cos_d], a)


def specular_transmission(cos_theta_i, eta):
    """The Mueller matrix of specular transmission through a
    dielectric."""
    a_s, a_p, cos_theta_t, eta_it, eta_ti = fresnel_polarized(cos_theta_i,
                                                              eta)
    ci = _t(cos_theta_i)
    big = torch.abs(ci) > 1e-8
    factor = -eta_it * torch.where(
        big, cos_theta_t / torch.where(big, ci, 1.0), 0.0)
    a_s_r = 1.0 + a_s.real
    a_p_r = (1.0 + a_p.real) * eta_ti
    t_s = a_s_r * a_s_r
    t_p = a_p_r * a_p_r
    a = 0.5 * factor * (t_s + t_p)
    b = 0.5 * factor * (t_s - t_p)
    c = factor * m.sqrt(t_s * t_p)
    return _mat([a, b, 0, 0,
                 b, a, 0, 0,
                 0, 0, c, 0,
                 0, 0, 0, c], a)


def specular_reflection_conductor(cos_theta_i, eta, k):
    """The Mueller matrix of specular reflection off a conductor of
    complex IOR eta + i k (elementwise: eta and k may carry a trailing
    RGB or wavelength axis that cos_theta_i lacks)."""
    ci = _t(cos_theta_i)
    eta = _t(eta, ci)
    k = _t(k, ci)
    if eta.dim() > ci.dim():
        ci = ci[..., None]
    ci = torch.abs(ci)
    eta_c = torch.complex(eta, k)
    st2 = _cdiv((1.0 - ci * ci).to(torch.complex64), eta_c * eta_c)
    ct = _csqrt(1.0 - st2)
    a_s = _cdiv(ci - eta_c * ct, ci + eta_c * ct)
    a_p = _cdiv(eta_c * ci - ct, eta_c * ci + ct)
    r_s, r_p = _cabs(a_s), _cabs(a_p)
    r_s, r_p = r_s * r_s, r_p * r_p
    a = 0.5 * (r_s + r_p)
    b = 0.5 * (r_s - r_p)
    c = m.sqrt(m.clip(r_s * r_p, min=0.0))
    cos_d, sin_d = _phase(a_p * torch.conj(a_s), c, False)
    return _mat([a, b, 0, 0,
                 b, a, 0, 0,
                 0, 0, c * cos_d, -c * sin_d,
                 0, 0, c * sin_d, c * cos_d], a)


def stokes_basis(forward):
    """The horizontal basis vector of a Stokes frame around a propagation
    direction."""
    s, _ = m.coordinate_system(forward)
    return s


def unit_angle(a, b):
    """The angle between unit vectors, stable near 0 and pi."""
    return 2.0 * torch.asin(m.clip(0.5 * m.norm(b - a), 0.0, 1.0))


def rotate_stokes_basis(forward, basis_current, basis_target):
    """The rotator taking one Stokes basis to another."""
    theta = unit_angle(m.normalize(basis_current), m.normalize(basis_target))
    sign = torch.where(
        m.dot(forward, m.cross(basis_current, basis_target)) < 0, -1.0, 1.0)
    return rotator(theta * sign)


def rotate_mueller_basis(M, in_forward, in_basis_current, in_basis_target,
                         out_forward, out_basis_current, out_basis_target):
    """M re-expressed in new input and output Stokes frames."""
    R_in = rotate_stokes_basis(in_forward, in_basis_current, in_basis_target)
    R_out = rotate_stokes_basis(out_forward, out_basis_current,
                                out_basis_target)
    return R_out @ M @ R_in.transpose(-1, -2)


def rotate_mueller_basis_collinear(M, forward, basis_current, basis_target):
    """The same rotation on the input and the output frame."""
    R = rotate_stokes_basis(forward, basis_current, basis_target)
    return R @ M @ R.transpose(-1, -2)
