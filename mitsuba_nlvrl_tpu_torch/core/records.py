"""Interaction and sampling records.

Port of ``mitsuba_nlvrl_tpu/core/records.py``: every field is a wavefront
tensor with leading batch dims; an explicit ``valid`` mask replaces the
sentinel-t test, and integer fields index the SoA scene tables (BSDF,
emitter and medium rows; -1 where there is none).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as m
from .frame import Frame


class SurfaceInteraction(NamedTuple):
    valid: torch.Tensor        # (...,) bool — hit anything
    t: torch.Tensor            # (...,) hit distance (inf if miss)
    p: torch.Tensor            # (..., 3) hit position
    n: torch.Tensor            # (..., 3) geometric normal
    sh_frame: Frame            # shading frame
    uv: torch.Tensor           # (..., 2)
    wi: torch.Tensor           # (..., 3) incident dir in LOCAL shading frame
    prim_index: torch.Tensor   # (...,) int32 triangle/prim id
    shape_idx: torch.Tensor    # (...,) int32 shape id
    bsdf_idx: torch.Tensor     # (...,) int32 index into scene bsdf table
    emitter_idx: torch.Tensor  # (...,) int32 emitter table index (-1 none)
    int_medium: torch.Tensor   # (...,) int32 interior medium id (-1 none)
    ext_medium: torch.Tensor   # (...,) int32 exterior medium id (-1 none)

    def to_world(self, v):
        return self.sh_frame.to_world(v)

    def to_local(self, v):
        return self.sh_frame.to_local(v)

    def target_medium(self, d_world):
        """Medium on the side of the geometric normal that ``d_world``
        points to."""
        cos = m.dot(d_world, self.n)
        return torch.where(cos > 0, self.ext_medium, self.int_medium)

    def is_medium_transition(self):
        return (self.int_medium >= 0) | (self.ext_medium >= 0)

    @staticmethod
    def invalid(batch_shape, device=None) -> "SurfaceInteraction":
        z3 = torch.zeros(batch_shape + (3,), device=device)
        z2 = torch.zeros(batch_shape + (2,), device=device)
        zi = torch.full(batch_shape, -1, dtype=torch.int32, device=device)
        return SurfaceInteraction(
            valid=torch.zeros(batch_shape, dtype=torch.bool, device=device),
            t=torch.full(batch_shape, m.Infinity, device=device),
            p=z3, n=z3, sh_frame=Frame(z3, z3, z3), uv=z2, wi=z3,
            prim_index=zi, shape_idx=zi,
            bsdf_idx=torch.zeros(batch_shape, dtype=torch.int32,
                                 device=device),
            emitter_idx=zi, int_medium=zi, ext_medium=zi)


class MediumInteraction(NamedTuple):
    valid: torch.Tensor        # (...,) bool — scattered inside the medium
    t: torch.Tensor            # (...,) distance along the ray
    p: torch.Tensor            # (..., 3)
    wi: torch.Tensor           # (..., 3) world incident direction (-ray.d)
    medium_idx: torch.Tensor   # (...,) int32
    sigma_s: torch.Tensor      # (..., 3)
    sigma_n: torch.Tensor      # (..., 3)
    sigma_t: torch.Tensor      # (..., 3)
    combined_extinction: torch.Tensor  # (..., 3) majorant


class PositionSample(NamedTuple):
    """An area-measure sample of a point on a shape or emitter."""
    p: torch.Tensor            # (..., 3)
    n: torch.Tensor            # (..., 3)
    uv: torch.Tensor           # (..., 2)
    pdf: torch.Tensor          # (...,) area-measure pdf
    delta: torch.Tensor        # (...,) bool


class DirectionSample(NamedTuple):
    """Solid-angle emitter sample toward a reference point."""
    p: torch.Tensor            # (..., 3) point on emitter
    n: torch.Tensor            # (..., 3) normal at emitter point
    uv: torch.Tensor           # (..., 2)
    d: torch.Tensor            # (..., 3) unit dir from ref point to emitter
    dist: torch.Tensor         # (...,)
    pdf: torch.Tensor          # (...,) solid-angle pdf
    delta: torch.Tensor        # (...,) bool (point emitters)
    emitter_idx: torch.Tensor  # (...,) int32
