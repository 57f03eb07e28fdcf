"""Rays as structure-of-arrays tensors.

Port of ``mitsuba_nlvrl_tpu/core/ray.py``: mint/maxt are carried per lane
so masked wavefront loops can clamp segments.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as m


class Ray(NamedTuple):
    o: torch.Tensor        # (..., 3) origin
    d: torch.Tensor        # (..., 3) direction (unit unless noted)
    mint: torch.Tensor     # (...,)
    maxt: torch.Tensor     # (...,)

    @staticmethod
    def make(o, d, mint=None, maxt=None) -> "Ray":
        batch = torch.broadcast_shapes(o.shape[:-1], d.shape[:-1])
        kw = dict(dtype=o.dtype, device=o.device)
        # a scalar bound becomes a full tensor, not a stride-0 view: the
        # intersection kernel takes contiguous rays only
        mint = m.RayEpsilon if mint is None else mint
        maxt = m.Infinity if maxt is None else maxt
        if isinstance(mint, (int, float)):
            mint = torch.full(batch, mint, **kw)
        else:
            mint = torch.broadcast_to(torch.as_tensor(mint, **kw), batch)
        if isinstance(maxt, (int, float)):
            maxt = torch.full(batch, maxt, **kw)
        else:
            maxt = torch.broadcast_to(torch.as_tensor(maxt, **kw), batch)
        return Ray(o=torch.broadcast_to(o, batch + (3,)),
                   d=torch.broadcast_to(d, batch + (3,)), mint=mint,
                   maxt=maxt)

    def at(self, t) -> torch.Tensor:
        return self.o + self.d * t[..., None]


def spawn_ray(p: torch.Tensor, d: torch.Tensor, maxt=None) -> Ray:
    """Offset-origin secondary ray (reference Interaction::spawn_ray)."""
    return Ray.make(p, d, mint=m.RayEpsilon, maxt=maxt)
