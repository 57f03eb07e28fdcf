"""Fresnel equations for dielectrics and conductors.

Port of ``mitsuba_nlvrl_tpu/core/fresnel.py``; elementwise over wavefront
dims.
"""
from __future__ import annotations

import torch

from . import math as m


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance at a dielectric boundary.

    Returns (F, cos_theta_t, eta_it, eta_ti): reflectance, signed
    transmitted cosine, relative IOR for the refracted ray, its reciprocal.
    """
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cti_abs = torch.abs(cos_theta_i)
    sin2_t = eta_ti * eta_ti * m.clip(1.0 - cti_abs * cti_abs, min=0.0)
    tir = sin2_t > 1.0
    cos_t_abs = m.safe_sqrt(1.0 - sin2_t)

    a_s = m.safe_div(cti_abs - eta_it * cos_t_abs,
                     cti_abs + eta_it * cos_t_abs)
    a_p = m.safe_div(eta_it * cti_abs - cos_t_abs,
                     eta_it * cti_abs + cos_t_abs)
    F = 0.5 * (a_s * a_s + a_p * a_p)
    F = torch.where(tir, 1.0, F)
    F = torch.where(eta == 1.0, 0.0, F)

    cos_theta_t = torch.where(tir, 0.0,
                              -torch.sign(cos_theta_i) * cos_t_abs)
    # degenerate eta == 1
    cos_theta_t = torch.where(eta == 1.0, -cos_theta_i, cos_theta_t)
    return F, cos_theta_t, eta_it, eta_ti


def refract_local(wi, cos_theta_t, eta_ti):
    """Refract a LOCAL-frame direction (wi points away from the surface)."""
    z = cos_theta_t[..., None]
    return torch.cat(
        [-eta_ti[..., None] * wi[..., 0:1],
         -eta_ti[..., None] * wi[..., 1:2],
         z], dim=-1)


def reflect_local(wi):
    """Mirror reflection in the local frame (z = normal)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized Fresnel reflectance of a conductor with complex IOR
    eta + i*k (eta/k may be (..., 3) RGB)."""
    c2 = cos_theta_i * cos_theta_i
    s2 = 1.0 - c2
    if eta.dim() > cos_theta_i.dim():
        c2 = c2[..., None]
        s2 = s2[..., None]
        cti = cos_theta_i[..., None]
    else:
        cti = cos_theta_i
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = m.safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = m.safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * cti
    Rs = (t1 - t2) / (t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    Rp = Rs * (t3 - t4) / (t3 + t4)
    return 0.5 * (Rp + Rs)
