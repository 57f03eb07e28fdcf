"""Direct illumination: one emitter sample and one BSDF sample a pixel,
combined with the power heuristic.

Port of ``mitsuba_nlvrl_tpu/integrators/direct.py``: one intersection,
then an emitter sample with its shadow ray and a BSDF sample with its
ray to whatever emitter it reaches. Like the reference, it counts no
rays.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.ray import Ray, spawn_ray
from ..core.rng import Sampler
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from ..ops import intersect as isect
from .common import initial_active, mis_weight


def sample(scene, meta, sampler: Sampler, ray: Ray, active=None,
           diff: bool = False, aux=None):
    N = ray.o.shape[0]
    dev = ray.o.device
    active = initial_active(active, N, dev)
    si = isect.ray_intersect(scene, ray)

    result = emitter_mod.eval_hit(scene, meta, si, active & si.valid)
    result = result + emitter_mod.eval_env(scene, meta, ray.d,
                                           active & ~si.valid)
    act = active & si.valid

    # emitter sampling
    u_sel, sampler = sampler.next_1d()
    u2, sampler = sampler.next_2d()
    ds, em_weight = emitter_mod.sample_direction(scene, meta, si.p, u_sel,
                                                 u2, act)
    sh_ray = spawn_ray(si.p, ds.d, maxt=ds.dist * (1.0 - m.ShadowEpsilon))
    occluded = isect.ray_test(scene, sh_ray)
    wo_local = si.to_local(ds.d)
    f_val = bsdf_mod.eval(scene, meta, si, wo_local)
    b_pdf = bsdf_mod.pdf(scene, meta, si, wo_local)
    w = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, b_pdf))
    ok = act & (ds.pdf > 0) & ~occluded
    result = result + torch.where(ok[:, None],
                                  f_val * em_weight * w[:, None], 0.0)

    # bsdf sampling
    u1b, sampler = sampler.next_1d()
    u2b, sampler = sampler.next_2d()
    bs, b_weight = bsdf_mod.sample(scene, meta, si, u1b, u2b)
    ray2 = spawn_ray(si.p, si.to_world(bs.wo))
    si2 = isect.ray_intersect(scene, ray2)
    le2 = emitter_mod.eval_hit(scene, meta, si2, act & si2.valid)
    le2 = le2 + emitter_mod.eval_env(scene, meta, ray2.d, act & ~si2.valid)
    em_pdf2 = torch.where(
        si2.valid, emitter_mod.pdf_direction(scene, meta, si.p, si2, act),
        emitter_mod.pdf_env_direction(scene, meta, act, ray2.d))
    w2 = torch.where(bs.delta, 1.0, mis_weight(bs.pdf, em_pdf2))
    result = result + torch.where((act & (bs.pdf > 0))[:, None],
                                  b_weight * le2 * w2[:, None], 0.0)
    return result, torch.ones((N,), dtype=torch.bool, device=dev), sampler
