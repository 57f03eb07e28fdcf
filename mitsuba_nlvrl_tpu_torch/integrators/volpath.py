"""Wavefront volumetric path tracer with null-collision (delta) tracking.

Port of ``mitsuba_nlvrl_tpu/integrators/volpath.py`` (primal estimator;
``trace_emission`` and the ``diff`` branches come with the autodiff
slice): spectral MIS delta tracking with a per-path hero channel, the
real/null event split resolved inside ``medium.sample_real_interaction``,
NEE through media by ratio-tracked transmittance and null-BSDF
pass-through. One transmittance walk a bounce serves both medium and
surface vertices, and emitter hits along a sampled ray are weighted by
carried MIS state instead of a separate walk. ``volpathmis`` adds MIS
between phase sampling and NEE at medium vertices.

Each ``lax.while_loop`` or ``lax.cond`` of the reference becomes a host
loop or branch that reads one ``any`` back from the device
(``core/sync.py`` counts them); every lane stays in place and masked.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core.ray import Ray
from ..core.records import SurfaceInteraction
from ..core.rng import Sampler
from ..core.sync import any_on_host
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from .. import medium as medium_mod
from .. import phase as phase_mod
from ..ops import intersect as isect
from ..scene.types import BSDF_TYPES, F_SMOOTH, MEDIUM_TYPES
from .common import mis_weight

MAX_WAVEFRONT_ITERS = 192
SURFACE_WALK_ITERS = 16       # null-boundary crossings per shadow walk
# the reference gates its single-segment NEE to scenes below its
# dense-sweep crossover; the port keeps the gate so both packages take the
# same estimator
_CLUSTER_MIN_TRIS = 262144


def _where_tree(mask, new, old):
    """``torch.where(mask, new, old)`` over the tensors of a record."""
    if isinstance(new, tuple):
        return type(new)(*(_where_tree(mask, a, b)
                           for a, b in zip(new, old)))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _masked_intersect(scene, ray, si_cached, needs):
    """Intersect only if some lane needs it; merge with the cache."""
    if not any_on_host(needs):
        return si_cached
    return _where_tree(needs, isect.ray_intersect(scene, ray), si_cached)


def transmittance_to_point(scene, meta, sampler, p_ref, d, dist, medium_idx,
                           channel, active, on_medium):
    """Transmittance from p_ref along d over dist, through null BSDFs and
    media: a loop over surface crossings, each medium segment by
    ``medium.segment_tr``. Returns (transmittance (N, 3), sampler)."""
    N = p_ref.shape[0]
    dev = p_ref.device
    o = p_ref
    transmittance = torch.ones((N, 3), device=dev)
    total_dist = torch.zeros((N,), device=dev)
    walking = active
    smp = sampler
    mint = torch.where(on_medium, 0.0, m.RayEpsilon)
    it = 0
    while it < SURFACE_WALK_ITERS and any_on_host(walking):
        if it:
            mint = torch.full((N,), m.RayEpsilon, device=dev)
        remaining = dist * (1.0 - m.ShadowEpsilon) - total_dist
        act = walking & (remaining > 0)
        si = isect.ray_intersect(scene, Ray(o, d, mint, remaining))
        seg_end = torch.minimum(torch.where(si.valid, si.t, m.Infinity),
                                remaining)
        tr_seg, smp = medium_mod.segment_tr(scene, meta, smp, o, d, seg_end,
                                            medium_idx, channel,
                                            act & (medium_idx >= 0))
        smp = smp.count_rays(act)                 # shadow-walk rays
        transmittance = transmittance * tr_seg
        # a surface on the way: pass through null BSDFs only
        hit = act & si.valid
        null_tr = bsdf_mod.eval_null_transmission(scene, meta, si)
        transmittance = torch.where(hit[:, None], transmittance * null_tr,
                                    transmittance)
        medium_idx = torch.where(hit & si.is_medium_transition(),
                                 si.target_medium(d), medium_idx)
        total_dist = total_dist + torch.where(hit, si.t, remaining)
        o = torch.where(hit[:, None], si.p, o)
        walking = hit & (transmittance > 0).any(dim=-1)
        it += 1
    tr_out = torch.where(walking[:, None], 0.0, transmittance)
    return torch.where(active[:, None], tr_out, 1.0), smp


def _nee_single_segment(meta) -> bool:
    """Gate of the single-segment NEE fast path: exactly one medium,
    heterogeneous (its extent is its grid bbox, so clipping to it
    reproduces the shell crossings), no ``mask`` BSDF (every null boundary
    transmits 1), and the scene below the reference's dense-sweep
    crossover."""
    return (len(meta.medium_types) == 1
            and meta.medium_types[0] == MEDIUM_TYPES['heterogeneous']
            and BSDF_TYPES['mask'] not in meta.bsdf_types
            and meta.n_tris < _CLUSTER_MIN_TRIS)


def transmittance_to_point_single(scene, meta, sampler, p_ref, d, dist,
                                  channel, active):
    """Single-segment NEE transmittance (gated by
    ``_nee_single_segment``): one any hit against the occluders (null
    shells skipped, through the kernel) and one ratio-tracked segment
    over the bbox-clipped span, where the general walk pays a scene
    intersection and a walk start-up per shell crossing. The same
    expectation."""
    N = p_ref.shape[0]
    dev = p_ref.device
    seg = torch.clamp(dist * (1.0 - m.ShadowEpsilon), min=0.0)
    ray = Ray(p_ref, d, torch.full((N,), m.RayEpsilon, device=dev), seg)
    occ = isect.ray_test_occluders(scene, ray, seg)
    smp = sampler.count_rays(active)
    midx0 = torch.zeros((N,), dtype=torch.int32, device=dev)
    tr, smp = medium_mod.segment_tr(scene, meta, smp, p_ref, d, seg, midx0,
                                    channel, active & ~occ)
    tr = torch.where(occ[:, None], 0.0, tr)
    return torch.where(active[:, None], tr, 1.0), smp


class VolpathState(NamedTuple):
    sampler: Sampler
    ray: Ray
    throughput: torch.Tensor
    result: torch.Tensor
    eta: torch.Tensor
    depth: torch.Tensor
    active: torch.Tensor
    medium_idx: torch.Tensor
    channel: torch.Tensor
    si: SurfaceInteraction      # cached surface interaction
    needs_isect: torch.Tensor
    # carried MIS state for emitter hits along the current ray:
    # em_full: hits count with weight 1 (camera ray / specular chain)
    # prev_pdf: solid-angle pdf of the strategy that sampled ray.d
    #           (0: NEE-only at the previous vertex, hits count 0)
    # p_prev: the previous scattering vertex (MIS emitter-pdf reference)
    em_full: torch.Tensor
    prev_pdf: torch.Tensor
    p_prev: torch.Tensor


def _opts(meta):
    """(max_depth, rr_depth, phase_mis, nee_fast) of the estimator."""
    max_depth = meta.iprop('max_depth', -1)
    if max_depth is None or max_depth < 0:
        max_depth = 64
    rr_depth = meta.iprop('rr_depth', 5)
    return (int(max_depth), rr_depth, meta.integrator == 'volpathmis',
            _nee_single_segment(meta))


def make_body(scene, meta, N: int):
    """One iteration of the volumetric bounce loop, VolpathState ->
    VolpathState."""
    max_depth, rr_depth, phase_mis, nee_fast = _opts(meta)

    def body(st: VolpathState) -> VolpathState:
        smp = st.sampler
        result = st.result
        throughput = st.throughput
        dev = throughput.device
        ch = st.channel

        # --- russian roulette ------------------------------------------
        active = st.active & (throughput != 0.0).any(dim=-1)
        q = torch.clamp(throughput.amax(dim=-1) * m.sqr(st.eta), max=0.95)
        perform_rr = st.depth > rr_depth
        u_rr, smp = smp.next_1d()
        active = active & ((u_rr < q) | ~perform_rr)
        throughput = torch.where(perform_rr[:, None],
                                 throughput * m.safe_rcp(q)[:, None],
                                 throughput)
        active = active & (st.depth < max_depth)

        active_medium = active & (st.medium_idx >= 0)
        active_surface = active & ~active_medium

        # --- (cached) scene intersection -------------------------------
        inf = torch.full((N,), m.Infinity, device=dev)
        iray = Ray(st.ray.o, st.ray.d, st.ray.mint, inf)
        si = _masked_intersect(scene, iray, st.si, st.needs_isect & active)
        smp = smp.count_rays(st.needs_isect & active)
        needs_isect = st.needs_isect & ~active

        # --- medium free flight to the next real collision -------------
        mray = Ray(st.ray.o, st.ray.d, st.ray.mint,
                   torch.where(si.valid, si.t, inf))
        mi, w_med, smp = medium_mod.sample_real_interaction(
            scene, meta, mray, smp, ch, st.medium_idx, active_medium)
        throughput = torch.where(active_medium[:, None],
                                 throughput * w_med, throughput)
        escaped_medium = active_medium & ~mi.valid
        active_medium = active_medium & mi.valid

        act_real = active_medium
        depth = torch.where(act_real, st.depth + 1, st.depth)
        active = active & (depth < max_depth)
        act_real = act_real & active
        throughput = torch.where(
            act_real[:, None],
            throughput * mi.sigma_s
            * medium_mod._ch(mi.combined_extinction, ch)[:, None]
            / torch.clamp(medium_mod._ch(mi.sigma_t, ch),
                          min=1e-30)[:, None],
            throughput)

        # --- emitter hits along the current ray (carried-MIS arm) ------
        active_surface = active_surface | escaped_medium
        hit_em = active_surface & (si.emitter_idx >= 0) & si.valid
        le = emitter_mod.eval_hit(scene, meta, si, hit_em)
        em_pdf = emitter_mod.pdf_direction(scene, meta, st.p_prev, si,
                                           hit_em & ~st.em_full)
        w_hit = torch.where(st.em_full, 1.0, mis_weight(st.prev_pdf, em_pdf))
        esc = active_surface & ~si.valid
        env = emitter_mod.eval_env(scene, meta, st.ray.d, esc)
        env_pdf = emitter_mod.pdf_env_direction(scene, meta,
                                                esc & ~st.em_full, st.ray.d)
        w_env = torch.where(st.em_full, 1.0,
                            mis_weight(st.prev_pdf, env_pdf))
        result = result + torch.where(
            hit_em[:, None], throughput * le * w_hit[:, None], 0.0)
        result = result + torch.where(
            esc[:, None], throughput * env * w_env[:, None], 0.0)
        active_surface = active_surface & si.valid

        is_smooth = (bsdf_mod.flags_of(scene, si) & F_SMOOTH) > 0

        # --- NEE: medium vertices and smooth-surface vertices share one
        # transmittance walk (a lane is at one or the other) ------------
        active_es = active_surface & is_smooth & (depth + 1 < max_depth)
        nee_act = act_real | active_es
        p_ref = torch.where(act_real[:, None], mi.p, si.p)
        u_sel, smp = smp.next_1d()
        u2, smp = smp.next_2d()
        ds, em_weight = emitter_mod.sample_direction(
            scene, meta, p_ref, u_sel, u2, nee_act)
        nee_ok = nee_act & (ds.pdf > 0)
        if nee_fast:
            tr_nee, smp = transmittance_to_point_single(
                scene, meta, smp, p_ref, ds.d, ds.dist, ch, nee_ok)
        else:
            tr_nee, smp = transmittance_to_point(
                scene, meta, smp, p_ref, ds.d, ds.dist, st.medium_idx, ch,
                nee_ok, act_real)
        # medium arm: the phase function (NEE only, weight 1, unless
        # volpathmis)
        phase_val = phase_mod.eval(scene, meta, st.medium_idx, mi.wi, ds.d,
                                   act_real)
        w_med_nee = (mis_weight(ds.pdf, torch.where(ds.delta, 0.0,
                                                    phase_val))
                     if phase_mis else torch.ones((N,), device=dev))
        # surface arm: BSDF eval/pdf MIS
        wo_l = si.to_local(ds.d)
        f_val = bsdf_mod.eval(scene, meta, si, wo_l)
        b_pdf = bsdf_mod.pdf(scene, meta, si, wo_l)
        w_surf_nee = mis_weight(ds.pdf, torch.where(ds.delta, 0.0, b_pdf))
        contrib = torch.where(act_real[:, None],
                              (phase_val * w_med_nee)[:, None],
                              f_val * w_surf_nee[:, None])
        result = result + torch.where(
            nee_ok[:, None], throughput * contrib * tr_nee * em_weight, 0.0)

        # --- phase sampling --------------------------------------------
        u2p, smp = smp.next_2d()
        wo_med, phase_pdf = phase_mod.sample(scene, meta, st.medium_idx,
                                             mi.wi, u2p, act_real)

        # --- BSDF sampling ---------------------------------------------
        u1b, smp = smp.next_1d()
        u2b, smp = smp.next_2d()
        bs, b_weight = bsdf_mod.sample(scene, meta, si, u1b, u2b)
        throughput = torch.where(active_surface[:, None],
                                 throughput * b_weight, throughput)
        eta = torch.where(active_surface, st.eta * bs.eta, st.eta)
        wo_world = si.to_world(bs.wo)
        non_null = active_surface & ~bs.null
        depth = torch.where(non_null, depth + 1, depth)
        new_medium = torch.where(
            active_surface & si.is_medium_transition(),
            si.target_medium(wo_world), st.medium_idx)

        # --- carried MIS state for the sampled continuation ------------
        # medium scatter: NEE only (prev_pdf 0) unless volpathmis; smooth
        # surface bounce: MIS with bs.pdf; delta bounce: full; null
        # bounce: unchanged
        smooth_b = active_surface & ~bs.delta & ~bs.null
        delta_b = active_surface & bs.delta & ~bs.null
        em_full = torch.where(act_real | smooth_b, False,
                              torch.where(delta_b, True, st.em_full))
        prev_pdf = torch.where(
            act_real,
            phase_pdf if phase_mis else torch.zeros((N,), device=dev),
            torch.where(smooth_b, bs.pdf, st.prev_pdf))
        p_prev = torch.where(act_real[:, None], mi.p,
                             torch.where(non_null[:, None], si.p, st.p_prev))

        # --- next ray ---------------------------------------------------
        o_next = torch.where(act_real[:, None], mi.p,
                             torch.where(active_surface[:, None], si.p,
                                         st.ray.o))
        d_next = torch.where(act_real[:, None], wo_med,
                             torch.where(active_surface[:, None], wo_world,
                                         st.ray.d))
        mint_next = torch.where(active_surface, m.RayEpsilon, 0.0)
        alive = (active_medium | active_surface) & active
        alive = alive & (throughput != 0.0).any(dim=-1)
        alive = alive & ((active_surface & (bs.pdf > 0)) | active_medium)

        return VolpathState(
            sampler=smp, ray=Ray(o_next, d_next, mint_next, inf),
            throughput=throughput, result=result, eta=eta, depth=depth,
            active=alive, medium_idx=new_medium, channel=ch, si=si,
            needs_isect=needs_isect | act_real | active_surface,
            em_full=em_full, prev_pdf=prev_pdf, p_prev=p_prev)

    return body


def sample(scene, meta, sampler: Sampler, ray: Ray, aux=None):
    """Volumetric path tracing of each camera ray. Returns (L, valid,
    sampler)."""
    N = ray.o.shape[0]
    dev = ray.o.device
    u_ch, sampler = sampler.next_1d()
    channel = torch.clamp((u_ch * 3).to(torch.int32), max=2)
    st = VolpathState(
        sampler=sampler, ray=ray,
        throughput=torch.ones((N, 3), device=dev),
        result=torch.zeros((N, 3), device=dev),
        eta=torch.ones((N,), device=dev),
        depth=torch.zeros((N,), dtype=torch.int32, device=dev),
        active=torch.ones((N,), dtype=torch.bool, device=dev),
        medium_idx=torch.full((N,), meta.camera_medium, dtype=torch.int32,
                              device=dev),
        channel=channel, si=SurfaceInteraction.invalid((N,), dev),
        needs_isect=torch.ones((N,), dtype=torch.bool, device=dev),
        em_full=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_pdf=torch.zeros((N,), device=dev), p_prev=ray.o)
    body = make_body(scene, meta, N)
    # the reference's while_loop: a host loop reading any(active) a trip
    it = 0
    while it < MAX_WAVEFRONT_ITERS and any_on_host(st.active):
        st = body(st)
        it += 1
    return st.result, torch.ones((N,), dtype=torch.bool, device=dev), \
        st.sampler
