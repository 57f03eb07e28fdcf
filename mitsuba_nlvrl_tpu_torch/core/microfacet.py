"""Microfacet distributions (GGX and Beckmann).

Port of ``mitsuba_nlvrl_tpu/core/microfacet.py``: isotropic and
anisotropic roughness, Smith shadowing and visible-normal (VNDF)
sampling. Local frame: z is the shading normal.
"""
from __future__ import annotations

import torch

from . import math as m
from . import frame as fr
from . import warp

GGX = 0
BECKMANN = 1


def ggx_d(h, ax, ay):
    """The GGX normal distribution D(h). Below the horizon t is replaced
    before the division (the double ``where``): those lanes are dropped,
    and t may be 0 there (h = 0), whose infinite derivative would meet
    their zero cotangent."""
    x, y, z = h[..., 0], h[..., 1], h[..., 2]
    up = z > 0
    t = torch.where(up, m.sqr(x / ax) + m.sqr(y / ay) + m.sqr(z), 1.0)
    d = 1.0 / (m.Pi * ax * ay * m.sqr(t))
    return torch.where(up, d, 0.0)


def beckmann_d(h, ax, ay):
    x, y, z = h[..., 0], h[..., 1], h[..., 2]
    z2 = m.sqr(z)
    e = torch.exp(-(m.sqr(x / ax) + m.sqr(y / ay)) / m.clip(z2, min=1e-12))
    up = z > 1e-6
    d = e / (m.Pi * ax * ay * m.sqr(torch.where(up, z2, 1.0)))
    return torch.where(up, d, 0.0)


def smith_g1(v, h, ax, ay, dist_type=GGX):
    """Smith masking G1 of direction v with half vector h."""
    xy_alpha2 = m.sqr(ax * v[..., 0]) + m.sqr(ay * v[..., 1])
    tan2 = xy_alpha2 / m.clip(m.sqr(v[..., 2]), min=1e-12)
    if dist_type == GGX:
        g = 2.0 / (1.0 + m.sqrt(1.0 + tan2))
    else:
        a = 1.0 / m.clip(m.sqrt(tan2), min=1e-12)
        # Beckmann's rational approximation
        g = torch.where(a >= 1.6, 1.0,
                        (3.535 * a + 2.181 * a * a)
                        / (1.0 + 2.276 * a + 2.577 * a * a))
    # v and h must lie in the same hemisphere
    back = m.dot(v, h) * v[..., 2] <= 0.0
    return torch.where(back, 0.0, g)


def sample_vndf(wi, sample2, ax, ay, dist_type=GGX):
    """Sample the visible normals (Heitz 2018 for GGX; Beckmann samples
    the plain distribution of normals). Returns (h, pdf)."""
    if dist_type == BECKMANN:
        alpha = m.sqrt(ax * ay)
        h = warp.square_to_beckmann(sample2, alpha)
        return h, warp.square_to_beckmann_pdf(h, alpha)

    # stretch
    v = m.normalize(torch.stack(
        [ax * wi[..., 0], ay * wi[..., 1], wi[..., 2]], dim=-1))
    # orthonormal basis around v
    lensq = m.sqr(v[..., 0]) + m.sqr(v[..., 1])
    inv = m.safe_rsqrt(m.clip(lensq, min=1e-12))
    t1 = torch.where((lensq > 1e-12)[..., None],
                     torch.stack([-v[..., 1] * inv, v[..., 0] * inv,
                                  torch.zeros_like(inv)], dim=-1),
                     torch.tensor([1.0, 0.0, 0.0], device=v.device))
    t2 = m.cross(v, t1)
    # parabolic sample
    r = m.safe_sqrt(sample2[..., 0])
    phi = 2.0 * m.Pi * sample2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = m.safe_sqrt(m.clip(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    # unstretch
    h = m.normalize(torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1], m.clip(nh[..., 2], min=1e-9)],
        dim=-1))
    return h, vndf_pdf(wi, h, ax, ay, dist_type)


def vndf_pdf(wi, h, ax, ay, dist_type=GGX):
    """The pdf of visible-normal sampling: G1(wi) D(h) |wi.h| / |cos_i|."""
    if dist_type == BECKMANN:
        return warp.square_to_beckmann_pdf(h, m.sqrt(ax * ay))
    d = ggx_d(h, ax, ay)
    g1 = smith_g1(wi, h, ax, ay, dist_type)
    return g1 * torch.abs(m.dot(wi, h)) * d \
        / m.clip(torch.abs(fr.cos_theta(wi)), min=1e-9)
