"""Rays as structure-of-arrays tensors.

Port of ``mitsuba_nlvrl_tpu/core/ray.py``: mint/maxt are carried per lane
so masked wavefront loops can clamp segments; axis-aligned boxes and the
slab test.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

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


class BBox(NamedTuple):
    lo: torch.Tensor  # (..., 3)
    hi: torch.Tensor  # (..., 3)

    def center(self):
        return 0.5 * (self.lo + self.hi)

    def extents(self):
        return self.hi - self.lo

    def contains(self, p, eps=0.0):
        return ((p >= self.lo - eps) & (p <= self.hi + eps)).all(dim=-1)

    def expand(self, other: "BBox") -> "BBox":
        return BBox(torch.minimum(self.lo, other.lo),
                    torch.maximum(self.hi, other.hi))

    def surface_area(self):
        e = self.extents()
        return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                      + e[..., 2] * e[..., 0])


def ray_bbox_intersect(ray: Ray, box: BBox
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab test: (hit, near t, far t), not clamped by mint/maxt. A zero
    direction component divides to +-inf, which the min/max handle."""
    inv_d = 1.0 / ray.d
    t0 = (box.lo - ray.o) * inv_d
    t1 = (box.hi - ray.o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return near <= far, near, far
