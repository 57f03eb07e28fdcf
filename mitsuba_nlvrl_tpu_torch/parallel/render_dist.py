"""Rendering a wavefront of film positions.

Port of ``render_wavefront`` from ``mitsuba_nlvrl_tpu/parallel/
render_dist.py``: a pure function of (scene, positions, key), which the
differentiable render (``autodiff.py``) calls once a pass. The rest of
the reference's module (the device mesh and the sharded render) comes
with the multi-GPU port.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import rng
from ..core.rng import Sampler
from .. import sensor as sensor_mod
from ..integrators import get_integrator


def render_wavefront(scene, meta, pos, key, integrator: Optional[str] = None,
                     diff: bool = False):
    """Radiance (N, 3) of the film positions ``pos`` (N, 2 pixel
    coordinates). The sensor's sample takes ``fold_in(key, 1)`` and the
    sampler ``fold_in(key, 2)``, as in the reference; ``diff=True`` selects
    the integrators' differentiable bounce loops."""
    integ = get_integrator(integrator or meta.integrator)
    W, H = meta.film.width, meta.film.height
    dev = pos.device
    scale = torch.tensor([1.0 / W, 1.0 / H], dtype=torch.float32,
                         device=dev)
    N = pos.shape[0]
    ray, sensor_weight = sensor_mod.sample_ray(
        scene, meta, pos * scale, rng.uniform(rng.fold_in(key, 1), (N, 2),
                                              dev))
    sampler = Sampler.make(rng.fold_in(key, 2), N, dev)
    L, valid, _ = integ(scene, meta, sampler, ray, diff=diff)
    return torch.where(torch.isfinite(L), L, 0.0) * sensor_weight
