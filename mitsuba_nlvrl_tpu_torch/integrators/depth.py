"""The depth AOV: the camera ray's hit distance in every channel (0 on a
miss). Port of ``mitsuba_nlvrl_tpu/integrators/depth.py``."""
from __future__ import annotations

import torch

from ..core.ray import Ray
from ..core.rng import Sampler
from ..ops import intersect as isect


def sample(scene, meta, sampler: Sampler, ray: Ray, active=None,
           diff: bool = False, aux=None):
    si = isect.ray_intersect(scene, ray)
    d = torch.where(si.valid, si.t, 0.0)
    return d[:, None].repeat(1, 3), si.valid, sampler
