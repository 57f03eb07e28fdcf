"""Interaction and sampling records.

Port of ``mitsuba_nlvrl_tpu/core/records.py``: every field is a wavefront
tensor with leading batch dims; an explicit ``valid`` mask replaces the
sentinel-t test, and integer fields index the SoA scene tables.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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

    def to_world(self, v):
        return self.sh_frame.to_world(v)

    def to_local(self, v):
        return self.sh_frame.to_local(v)


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
