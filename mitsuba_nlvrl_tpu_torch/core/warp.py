"""Sampling warps: [0,1)^2 -> distributions on disks, spheres, hemispheres,
cones and triangles.

Port of the warps of ``mitsuba_nlvrl_tpu/core/warp.py`` that the
integrators and the BSDFs use (the Beckmann warp serves
``core/microfacet.py``). Elementwise over leading dims; sample is
(..., 2).
"""
from __future__ import annotations

import torch

from . import math as m


def square_to_uniform_disk_concentric(sample):
    """Concentric (Shirley) disk mapping."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = torch.abs(x) > torch.abs(y)
    r = torch.where(quadrant_x, x, y)
    rp = torch.where(quadrant_x, y, x)
    phi = 0.25 * m.Pi * rp / torch.where(r == 0.0, 1.0, r)
    phi = torch.where(quadrant_x, phi, 0.5 * m.Pi - phi)
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_triangle(sample):
    t = m.safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], dim=-1)


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 0]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * m.Pi * sample[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf(_):
    return m.InvFourPi


def square_to_cosine_hemisphere(sample):
    p = square_to_uniform_disk_concentric(sample)
    z = m.safe_sqrt(1.0 - m.squared_norm(p))
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v):
    return m.clip(v[..., 2], min=0.0) * m.InvPi


def square_to_beckmann(sample, alpha):
    """A Beckmann-distributed normal around +z."""
    phi = 2.0 * m.Pi * sample[..., 1]
    log_s = torch.log(m.clip(1.0 - sample[..., 0], min=1e-38))
    tan2 = -alpha * alpha * log_s
    cos_theta = 1.0 / m.safe_sqrt(1.0 + tan2)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def square_to_beckmann_pdf(v, alpha):
    ct = v[..., 2]
    tan2 = (1.0 - ct * ct) / m.clip(ct * ct, min=1e-20)
    pdf = torch.exp(-tan2 / (alpha * alpha)) / (m.Pi * alpha * alpha * ct ** 3)
    return torch.where(ct > 1e-9, pdf, 0.0)


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in a cone around +z with cos(angle) >=
    cos_cutoff."""
    cos_theta = (1.0 - sample[..., 0]) + sample[..., 0] * cos_cutoff
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * m.Pi * sample[..., 1]
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)
