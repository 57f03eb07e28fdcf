"""Sampling warps: [0,1)^2 -> distributions on disks, spheres, hemispheres
and triangles.

Port of the warps of ``mitsuba_nlvrl_tpu/core/warp.py`` that the path
integrator uses. Elementwise over leading dims; sample is (..., 2).
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
    return torch.clamp(v[..., 2], min=0.0) * m.InvPi
