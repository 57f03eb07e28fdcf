"""Wavefront path tracer with NEE + MIS.

Port of ``mitsuba_nlvrl_tpu/integrators/path.py``. Each bounce of the
whole ray wavefront: intersect, MIS-weighted emitter-hit accounting,
next-event estimation with one shadow ray, BSDF sampling, Russian
roulette. Dirac lobes are tracked with masks.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core.ray import Ray, spawn_ray
from ..core.rng import Sampler
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from ..ops import intersect as isect
from .common import (bounce_loop, initial_active, mis_weight,
                     russian_roulette)


class PathState(NamedTuple):
    sampler: Sampler
    ray: Ray
    throughput: torch.Tensor
    result: torch.Tensor
    eta: torch.Tensor
    depth: torch.Tensor          # (N,) int32 per-lane bounce count
    active: torch.Tensor
    prev_pdf: torch.Tensor       # bsdf pdf of previous bounce
    prev_delta: torch.Tensor     # previous bounce sampled a delta lobe
    prev_p: torch.Tensor         # previous path vertex (for emitter pdf)


def _max_depth(meta) -> int:
    max_depth = meta.iprop('max_depth', -1)
    if max_depth is None or max_depth < 0:
        max_depth = 64
    return int(max_depth)


def make_body(scene, meta, N: int):
    """One bounce as a PathState -> PathState function."""
    max_depth = _max_depth(meta)
    rr_depth = meta.iprop('rr_depth', 5)

    def body(st: PathState) -> PathState:
        si = isect.ray_intersect(scene, st.ray)
        smp0 = st.sampler.count_rays(st.active)   # primary/bounce rays

        # --- hit emitter / environment accounting (MIS vs prev NEE) ---
        le = emitter_mod.eval_hit(scene, meta, si, st.active & si.valid)
        em_pdf = emitter_mod.pdf_direction(scene, meta, st.prev_p, si,
                                           st.active & si.valid)
        escaped = st.active & ~si.valid
        le_env = emitter_mod.eval_env(scene, meta, st.ray.d, escaped)
        env_pdf = emitter_mod.pdf_env_direction(scene, meta, escaped,
                                                st.ray.d)
        # delta previous bounce (or first ray): no NEE at prev vertex
        w_hit = torch.where(st.prev_delta, 1.0,
                            mis_weight(st.prev_pdf, em_pdf))
        w_env = torch.where(st.prev_delta, 1.0,
                            mis_weight(st.prev_pdf, env_pdf))
        result = st.result + st.throughput * le * w_hit[:, None] \
            + st.throughput * le_env * w_env[:, None]

        active = st.active & si.valid & (st.depth + 1 < max_depth)

        smp = smp0
        # --- next event estimation -------------------------------------
        u_sel, smp = smp.next_1d()
        u2, smp = smp.next_2d()
        ds, em_weight = emitter_mod.sample_direction(
            scene, meta, si.p, u_sel, u2, active)
        nee_active = active & (ds.pdf > 0)
        smp = smp.count_rays(nee_active)          # shadow rays
        sh_ray = spawn_ray(si.p, ds.d,
                           maxt=ds.dist * (1.0 - m.ShadowEpsilon))
        occluded = isect.ray_test(scene, sh_ray)
        wo_local = si.to_local(ds.d)
        f_val = bsdf_mod.eval(scene, meta, si, wo_local)
        b_pdf = bsdf_mod.pdf(scene, meta, si, wo_local)
        w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, b_pdf))
        contrib = st.throughput * f_val * em_weight * w_nee[:, None]
        result = result + torch.where((nee_active & ~occluded)[:, None],
                                      contrib, 0.0)

        # --- bsdf sampling ---------------------------------------------
        u1b, smp = smp.next_1d()
        u2b, smp = smp.next_2d()
        bs, b_weight = bsdf_mod.sample(scene, meta, si, u1b, u2b)
        throughput = st.throughput * b_weight
        eta = st.eta * bs.eta
        wo_world = si.to_world(bs.wo)
        new_ray = spawn_ray(si.p, wo_world)
        active = active & (bs.pdf > 0) & (throughput > 0).any(dim=-1)

        # --- russian roulette ------------------------------------------
        u_rr, smp = smp.next_1d()
        survive, throughput = russian_roulette(throughput, eta, st.depth,
                                               rr_depth, u_rr)
        active = active & survive

        return PathState(
            sampler=smp,
            ray=Ray(o=torch.where(active[:, None], new_ray.o, st.ray.o),
                    d=torch.where(active[:, None], new_ray.d, st.ray.d),
                    mint=new_ray.mint, maxt=new_ray.maxt),
            throughput=throughput, result=result, eta=eta,
            depth=torch.where(st.active, st.depth + 1, st.depth),
            active=active,
            prev_pdf=torch.where(active, bs.pdf, st.prev_pdf),
            prev_delta=torch.where(active, bs.delta, st.prev_delta),
            prev_p=torch.where(active[:, None], si.p, st.prev_p))

    return body


def sample(scene, meta, sampler: Sampler, ray: Ray, active=None,
           diff: bool = False, aux=None):
    """Estimate incident radiance along each camera ray. Returns (L, valid,
    sampler). A spectral scene takes the hero-wavelength variant
    (``path_spectral``), as in the reference. ``diff=True`` runs each
    bounce under a checkpoint for reverse-mode autograd, at most
    ``max_depth`` bounces (``common.bounce_loop``)."""
    if meta.spectral:
        from . import path_spectral
        return path_spectral.sample(scene, meta, sampler, ray, active,
                                    diff=diff, aux=aux)
    N = ray.o.shape[0]
    dev = ray.o.device
    st = PathState(
        sampler=sampler, ray=ray,
        throughput=torch.ones((N, 3), device=dev),
        result=torch.zeros((N, 3), device=dev),
        eta=torch.ones((N,), device=dev),
        depth=torch.zeros((N,), dtype=torch.int32, device=dev),
        active=initial_active(active, N, dev),
        prev_pdf=torch.ones((N,), device=dev),
        prev_delta=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_p=ray.o)
    body = make_body(scene, meta, N)
    # The reference's lax.while_loop becomes a host loop. Its condition
    # reads `active.any()` back from the device: one host sync per bounce.
    # Its depth test ends every lane within max_depth bounces; the primal
    # loop has no other bound.
    st = bounce_loop(body, st, _max_depth(meta) if diff else math.inf, diff)
    return st.result, torch.ones((N,), dtype=torch.bool, device=dev), \
        st.sampler
