"""Wavefront volumetric path tracer with null-collision (delta) tracking.

Port of ``mitsuba_nlvrl_tpu/integrators/volpath.py``: spectral MIS delta
tracking with a per-path hero channel, the real/null event split
resolved inside ``medium.sample_real_interaction``, NEE through media by
ratio-tracked transmittance and null-BSDF pass-through. One
transmittance walk a bounce serves both medium and surface vertices, and
emitter hits along a sampled ray are weighted by carried MIS state
instead of a separate walk. ``volpathmis`` adds MIS between phase
sampling and NEE at medium vertices.

``diff=True`` (the differentiable render) keeps the reference's diff
estimator: the carried-MIS arm's transmittance lives in a detached
tracking event and has no pathwise derivative, so emitter hits count on
specular chains only and the BSDF (and, under ``volpathmis``, phase)
arms are explicit ``trace_emission`` walks; NEE takes the general walk;
the bounce loop is bounded at ``min(192, max(8, 3 * max_depth))`` trips
and the surface walks at ``SURFACE_WALK_ITERS``, each trip checkpointed
(``core/remat.py``).

Each ``lax.while_loop`` or ``lax.cond`` of the reference becomes a host
loop or branch that reads one ``any`` back from the device
(``core/sync.py`` counts them); every lane stays in place and masked.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core import remat
from ..core.ray import Ray, spawn_ray
from ..core.records import SurfaceInteraction
from ..core.rng import Sampler
from ..core.sync import any_on_host
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from .. import medium as medium_mod
from .. import phase as phase_mod
from ..ops import intersect as isect
from ..scene.types import BSDF_TYPES, F_NULL, F_SMOOTH, MEDIUM_TYPES
from .common import bounce_loop, initial_active, mis_weight

MAX_WAVEFRONT_ITERS = 192
SURFACE_WALK_ITERS = 16       # null-boundary crossings per surface walk
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


def _surface_walk(trip, st, meta, diff: bool):
    """The reference's walk over null-surface crossings (``_run_walk``):
    its while_loop, at most ``SURFACE_WALK_ITERS`` trips with one host read
    a trip, or under ``diff`` its scan of ``SURFACE_WALK_ITERS``
    checkpointed trips. A trip with no lane walking changes nothing but
    the sampler: its ``segment_tr`` draws one dimension in a scene with a
    heterogeneous medium. So the diff loop stops at the first such trip
    and the sampler skips the draws of the trips left, which keeps every
    later draw on the reference's dimension."""
    it = 0
    while it < SURFACE_WALK_ITERS and any_on_host(st.active):
        st = remat.checkpoint(trip, st, it) if diff else trip(st, it)
        it += 1
    if diff and MEDIUM_TYPES['heterogeneous'] in meta.medium_types:
        smp = st.sampler
        st = st._replace(sampler=smp._replace(
            dim=smp.dim + SURFACE_WALK_ITERS - it))
    return st


class _TrWalk(NamedTuple):
    sampler: Sampler
    o: torch.Tensor
    transmittance: torch.Tensor
    total_dist: torch.Tensor
    medium_idx: torch.Tensor
    active: torch.Tensor


def transmittance_to_point(scene, meta, sampler, p_ref, d, dist, medium_idx,
                           channel, active, on_medium, diff: bool = False):
    """Transmittance from p_ref along d over dist, through null BSDFs and
    media: a loop over surface crossings, each medium segment by
    ``medium.segment_tr``. Returns (transmittance (N, 3), sampler)."""
    N = p_ref.shape[0]
    dev = p_ref.device
    first_mint = torch.where(on_medium, 0.0, m.RayEpsilon)
    eps_mint = torch.full((N,), m.RayEpsilon, device=dev)

    def trip(st: _TrWalk, it: int) -> _TrWalk:
        remaining = dist * (1.0 - m.ShadowEpsilon) - st.total_dist
        act = st.active & (remaining > 0)
        si = isect.ray_intersect(scene, Ray(st.o, d, eps_mint if it
                                            else first_mint, remaining))
        seg_end = torch.minimum(torch.where(si.valid, si.t, m.Infinity),
                                remaining)
        tr_seg, smp = medium_mod.segment_tr(
            scene, meta, st.sampler, st.o, d, seg_end, st.medium_idx,
            channel, act & (st.medium_idx >= 0), diff=diff)
        smp = smp.count_rays(act)                 # shadow-walk rays
        transmittance = st.transmittance * tr_seg
        # a surface on the way: pass through null BSDFs only
        hit = act & si.valid
        null_tr = bsdf_mod.eval_null_transmission(scene, meta, si)
        transmittance = torch.where(hit[:, None], transmittance * null_tr,
                                    transmittance)
        return _TrWalk(
            sampler=smp, o=torch.where(hit[:, None], si.p, st.o),
            transmittance=transmittance,
            total_dist=st.total_dist + torch.where(hit, si.t, remaining),
            medium_idx=torch.where(hit & si.is_medium_transition(),
                                   si.target_medium(d), st.medium_idx),
            active=hit & (transmittance > 0).any(dim=-1))

    st = _surface_walk(trip, _TrWalk(
        sampler=sampler, o=p_ref, transmittance=torch.ones((N, 3),
                                                            device=dev),
        total_dist=torch.zeros((N,), device=dev), medium_idx=medium_idx,
        active=active), meta, diff)
    tr_out = torch.where(st.active[:, None], 0.0, st.transmittance)
    return torch.where(active[:, None], tr_out, 1.0), st.sampler


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
    seg = m.clip(dist * (1.0 - m.ShadowEpsilon), min=0.0)
    ray = Ray(p_ref, d, torch.full((N,), m.RayEpsilon, device=dev), seg)
    occ = isect.ray_test_occluders(scene, ray, seg)
    smp = sampler.count_rays(active)
    midx0 = torch.zeros((N,), dtype=torch.int32, device=dev)
    tr, smp = medium_mod.segment_tr(scene, meta, smp, p_ref, d, seg, midx0,
                                    channel, active & ~occ)
    tr = torch.where(occ[:, None], 0.0, tr)
    return torch.where(active[:, None], tr, 1.0), smp


class _EmWalk(NamedTuple):
    sampler: Sampler
    o: torch.Tensor
    transmittance: torch.Tensor
    medium_idx: torch.Tensor
    active: torch.Tensor
    emitted: torch.Tensor
    emitter_pdf: torch.Tensor


def trace_emission(scene, meta, sampler, ray_in: Ray, medium_idx, p_ref,
                   channel, active, diff: bool = False):
    """Follow a sampled ray to the first emissive or non-null surface, or
    to the environment, accumulating transmittance (the reference's
    ``evaluate_direct_light`` walk). Only the diff bounce runs it: the
    primal bounce folds this arm into the next bounce through carried MIS
    state. Returns (emitted (N, 3), emitter pdf (N,), sampler)."""
    N = p_ref.shape[0]
    dev = p_ref.device
    d = ray_in.d
    eps_mint = torch.full((N,), m.RayEpsilon, device=dev)
    inf = torch.full((N,), m.Infinity, device=dev)

    def trip(st: _EmWalk, it: int) -> _EmWalk:
        si = isect.ray_intersect(scene, Ray(st.o, d, eps_mint, inf))
        seg_end = torch.where(si.valid, si.t, m.Infinity)
        act = st.active
        seg_for_tr = torch.minimum(seg_end, 4.0 * scene.bsphere_r)
        tr_seg, smp = medium_mod.segment_tr(
            scene, meta, st.sampler, st.o, d, seg_for_tr, st.medium_idx,
            channel, act & (st.medium_idx >= 0), diff=diff)
        smp = smp.count_rays(act)
        transmittance = st.transmittance * tr_seg

        escaped = act & ~si.valid
        env = emitter_mod.eval_env(scene, meta, d, escaped)
        emitted = st.emitted + transmittance * env
        env_pdf = emitter_mod.pdf_env_direction(scene, meta, escaped, d)
        emitter_pdf = torch.where(escaped, env_pdf, st.emitter_pdf)

        hit = act & si.valid
        hit_em = hit & (si.emitter_idx >= 0)
        le = emitter_mod.eval_hit(scene, meta, si, hit_em)
        emitted = emitted + transmittance * le
        em_pdf = emitter_mod.pdf_direction(scene, meta, p_ref, si, hit_em)
        emitter_pdf = torch.where(hit_em, em_pdf, emitter_pdf)

        flags = bsdf_mod.flags_of(scene, si)
        cont = hit & ((flags & F_NULL) > 0) & ~hit_em
        null_tr = bsdf_mod.eval_null_transmission(scene, meta, si)
        transmittance = torch.where(cont[:, None], transmittance * null_tr,
                                    transmittance)
        return _EmWalk(
            sampler=smp, o=torch.where(cont[:, None], si.p, st.o),
            transmittance=transmittance,
            medium_idx=torch.where(cont & si.is_medium_transition(),
                                   si.target_medium(d), st.medium_idx),
            active=cont & (transmittance > 0).any(dim=-1),
            emitted=emitted, emitter_pdf=emitter_pdf)

    st = _surface_walk(trip, _EmWalk(
        sampler=sampler, o=ray_in.o,
        transmittance=torch.ones((N, 3), device=dev),
        medium_idx=medium_idx, active=active,
        emitted=torch.zeros((N, 3), device=dev),
        emitter_pdf=torch.zeros((N,), device=dev)), meta, diff)
    return st.emitted, st.emitter_pdf, st.sampler


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


def _opts(meta, diff: bool = False):
    """(max_depth, rr_depth, phase_mis, nee_fast) of the estimator; the
    single-segment NEE is off under ``diff``."""
    max_depth = meta.iprop('max_depth', -1)
    if max_depth is None or max_depth < 0:
        max_depth = 64
    rr_depth = meta.iprop('rr_depth', 5)
    return (int(max_depth), rr_depth, meta.integrator == 'volpathmis',
            (not diff) and _nee_single_segment(meta))


def make_body(scene, meta, N: int, diff: bool = False):
    """One iteration of the volumetric bounce loop, VolpathState ->
    VolpathState; ``diff`` selects the reference's diff estimator."""
    max_depth, rr_depth, phase_mis, nee_fast = _opts(meta, diff)

    def body(st: VolpathState) -> VolpathState:
        smp = st.sampler
        result = st.result
        throughput = st.throughput
        dev = throughput.device
        ch = st.channel

        # --- russian roulette ------------------------------------------
        active = st.active & (throughput != 0.0).any(dim=-1)
        q = m.clip((throughput.amax(dim=-1) * m.sqr(st.eta)).detach(),
                        max=0.95)
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
            scene, meta, mray, smp, ch, st.medium_idx, active_medium,
            diff=diff)
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
            / m.clip(medium_mod._ch(mi.sigma_t, ch),
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
        if diff:
            # the reference's diff estimator: emitter hits count on
            # specular chains only; the BSDF and phase arms are explicit
            # trace_emission walks below, whose transmittance carries the
            # derivative that the carried arm's detached escape event
            # cannot
            w_hit = torch.where(st.em_full, 1.0, 0.0)
            w_env = torch.where(st.em_full, 1.0, 0.0)
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
                nee_ok, act_real, diff=diff)
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

        if diff:
            # the explicit MIS arms of the reference's diff estimator
            if phase_mis:
                ph_ray = Ray(mi.p, wo_med, torch.zeros((N,), device=dev),
                             inf)
                ph_emitted, ph_em_pdf, smp = trace_emission(
                    scene, meta, smp, ph_ray, st.medium_idx, mi.p, ch,
                    act_real & (phase_pdf > 0), diff=True)
                result = result + torch.where(
                    act_real[:, None],
                    mis_weight(phase_pdf, ph_em_pdf)[:, None] * throughput
                    * ph_emitted, 0.0)
            add_emitter = active_surface & ~bs.delta & ~bs.null \
                & (depth < max_depth) & (throughput > 0).any(dim=-1)
            emitted_d, em_pdf2, smp = trace_emission(
                scene, meta, smp, spawn_ray(si.p, wo_world), new_medium,
                si.p, ch, add_emitter, diff=True)
            result = result + torch.where(
                add_emitter[:, None],
                mis_weight(bs.pdf, em_pdf2)[:, None] * throughput
                * emitted_d, 0.0)

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


def sample(scene, meta, sampler: Sampler, ray: Ray, active=None,
           diff: bool = False, aux=None):
    """Volumetric path tracing of each camera ray. Returns (L, valid,
    sampler). Under ``diff`` the bounce loop is the reference's scan of
    ``min(192, max(8, 3 * max_depth))`` checkpointed bounces."""
    N = ray.o.shape[0]
    dev = ray.o.device
    u_ch, sampler = sampler.next_1d()
    channel = m.clip((u_ch * 3).to(torch.int32), max=2)
    st = VolpathState(
        sampler=sampler, ray=ray,
        throughput=torch.ones((N, 3), device=dev),
        result=torch.zeros((N, 3), device=dev),
        eta=torch.ones((N,), device=dev),
        depth=torch.zeros((N,), dtype=torch.int32, device=dev),
        active=initial_active(active, N, dev),
        medium_idx=torch.full((N,), meta.camera_medium, dtype=torch.int32,
                              device=dev),
        channel=channel, si=SurfaceInteraction.invalid((N,), dev),
        needs_isect=torch.ones((N,), dtype=torch.bool, device=dev),
        em_full=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_pdf=torch.zeros((N,), device=dev), p_prev=ray.o)
    body = make_body(scene, meta, N, diff)
    # the reference's while_loop: a host loop reading any(active) a trip
    trips = MAX_WAVEFRONT_ITERS
    if diff:
        trips = min(MAX_WAVEFRONT_ITERS, max(8, 3 * _opts(meta)[0]))
    st = bounce_loop(body, st, trips, diff)
    return st.result, torch.ones((N,), dtype=torch.bool, device=dev), \
        st.sampler
