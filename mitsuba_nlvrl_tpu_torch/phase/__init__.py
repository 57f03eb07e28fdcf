"""Phase functions: isotropic and Henyey-Greenstein.

Port of ``mitsuba_nlvrl_tpu/phase/__init__.py`` with masked per-medium
dispatch. ``wi`` is the reversed incident direction (mi.wi = -ray.d, world
space); ``eval`` returns the phase value, which is also its sampling pdf;
``sample`` draws wo in world space around the propagation direction -wi.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import math as m
from ..core.frame import Frame
from ..scene.types import PHASE_TYPES, M_PHASE_G

P_ISO = PHASE_TYPES['isotropic']
P_HG = PHASE_TYPES['hg']


def _rows(scene, medium_idx):
    midx = m.clip(medium_idx, min=0).long()
    return (scene.media.phase_type[midx],
            scene.media.params[midx][:, M_PHASE_G])


def _hg_eval(g, cos_theta):
    temp = 1.0 + g * g + 2.0 * g * cos_theta
    return m.InvFourPi * (1.0 - g * g) / m.clip(
        temp * m.safe_sqrt(temp), min=1e-12)


def eval(scene, meta, medium_idx, wi, wo, active):
    """Phase value p(wi -> wo) per lane (== pdf: both phases are sampled
    exactly). wi, wo world space; wi = -incident direction."""
    ptype, g = _rows(scene, medium_idx)
    out = torch.zeros(wi.shape[:-1], device=wi.device)
    cos_theta = m.dot(wo, wi)
    for code in meta.phase_types:
        if code == P_ISO:
            val = torch.full_like(out, m.InvFourPi)
        elif code == P_HG:
            val = _hg_eval(g, cos_theta)
        else:
            continue
        out = torch.where(ptype == code, val, out)
    return torch.where(active, out, 0.0)


def sample(scene, meta, medium_idx, wi, u2, active
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample wo (world) and its pdf. The local frame is built around the
    propagation direction -wi."""
    ptype, g = _rows(scene, medium_idx)
    # HG: cos_theta around the propagation direction; |g| < 1e-4 is
    # sampled as isotropic (the HG inversion divides by g)
    gg = torch.where(torch.abs(g) < 1e-4, 1e-4, g)
    sqr_term = (1.0 - gg * gg) / (1.0 - gg + 2.0 * gg * u2[:, 0])
    cos_hg = (1.0 + gg * gg - sqr_term * sqr_term) / (2.0 * gg)
    cos_iso = 1.0 - 2.0 * u2[:, 0]
    use_hg = (ptype == P_HG) & (torch.abs(g) >= 1e-4)
    cos_theta = torch.where(use_hg, cos_hg, cos_iso)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * m.Pi * u2[:, 1]
    local = torch.stack([sin_theta * torch.cos(phi),
                         sin_theta * torch.sin(phi), cos_theta], dim=-1)
    frame = Frame.from_normal(m.normalize(-wi))
    wo = frame.to_world(local)
    return wo, eval(scene, meta, medium_idx, wi, wo, active)
