"""Polarized wavefront path tracer: a Mueller-matrix throughput.

Port of ``mitsuba_nlvrl_tpu/integrators/path_polarized.py``, the path
integrator of the polarized variants: a lane's throughput is a world
Stokes-frame Mueller matrix ``(N, 3, 4, 4)``, emitters contribute
unpolarized Stokes vectors through its first column, and the NEE and BSDF
weights come from the polarized BSDF layer (``bsdf/polarized.py``). The
random stream is the scalar path tracer's, so on a scene without
polarization-aware BSDFs S0 is the unpolarized render.

The Stokes vectors accumulate in the implicit frame
``stokes_basis(-ray.d)`` of each camera ray; ``sample_full`` rotates them
into the sensor's horizontal/vertical frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core import mueller as mu
from ..core.ray import Ray, spawn_ray
from ..core.rng import Sampler
from ..bsdf import polarized as bpol
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from ..ops import intersect as isect
from .common import bounce_loop, initial_active, mis_weight
from .path import _max_depth


class PolPathState(NamedTuple):
    sampler: Sampler
    ray: Ray
    throughput: torch.Tensor     # (N, C, 4, 4) Mueller
    result: torch.Tensor         # (N, C, 4) Stokes a channel
    eta: torch.Tensor
    depth: torch.Tensor          # (N,) int32
    active: torch.Tensor
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    prev_p: torch.Tensor


def emit(throughput, le):
    """The Stokes contribution of an unpolarized emitter seen through a
    Mueller throughput: T @ [Le, 0, 0, 0] = Le times T's first column."""
    return le[..., None] * throughput[..., :, 0]


def emitted_rgb(scene, meta, si, st):
    """(radiance at hits, escaped radiance), each (N, 3) and MIS-weighted
    against the previous bounce's NEE."""
    le = emitter_mod.eval_hit(scene, meta, si, st.active & si.valid)
    em_pdf = emitter_mod.pdf_direction(scene, meta, st.prev_p, si,
                                       st.active & si.valid)
    escaped = st.active & ~si.valid
    le_env = emitter_mod.eval_env(scene, meta, st.ray.d, escaped)
    env_pdf = emitter_mod.pdf_env_direction(scene, meta, escaped, st.ray.d)
    w_hit = torch.where(st.prev_delta, 1.0, mis_weight(st.prev_pdf, em_pdf))
    w_env = torch.where(st.prev_delta, 1.0, mis_weight(st.prev_pdf, env_pdf))
    return le * w_hit[:, None], le_env * w_env[:, None]


def roulette(throughput, eta, depth, rr_depth, u_rr):
    """Russian roulette on the depolarized power: (survive, throughput);
    the survival probability is detached, as in the reference."""
    tp_unpol = throughput[..., 0, 0]
    do_rr = depth >= rr_depth
    q = m.clip((tp_unpol.amax(dim=-1) * m.sqr(eta)).detach(), max=0.95)
    survive = torch.where(do_rr, u_rr < q, True)
    throughput = torch.where(
        (do_rr & survive)[:, None, None, None],
        throughput * m.safe_rcp(q)[:, None, None, None], throughput)
    return survive, throughput


def make_body(scene, meta, spectral_terms=None):
    """One bounce of the polarized path tracer. ``spectral_terms(si, wo,
    M, lam, null)`` turns an RGB Mueller weight into the state's channels
    (the spectral polarized variant); without it the channels are RGB."""
    max_depth = _max_depth(meta)
    rr_depth = meta.iprop('rr_depth', 5)

    def body(st, lam=None, emitted=None):
        si = isect.ray_intersect(scene, st.ray)
        smp = st.sampler.count_rays(st.active)
        if emitted is None:
            le, le_env = emitted_rgb(scene, meta, si, st)
            result = st.result + emit(st.throughput, le) \
                + emit(st.throughput, le_env)
        else:
            result = st.result + emit(st.throughput,
                                      emitted(scene, meta, si, st, lam))
        active = st.active & si.valid & (st.depth + 1 < max_depth)

        # --- next event estimation -------------------------------------
        u_sel, smp = smp.next_1d()
        u2, smp = smp.next_2d()
        ds, em_weight = emitter_mod.sample_direction(
            scene, meta, si.p, u_sel, u2, active)
        nee_active = active & (ds.pdf > 0)
        smp = smp.count_rays(nee_active)
        sh_ray = spawn_ray(si.p, ds.d,
                           maxt=ds.dist * (1.0 - m.ShadowEpsilon))
        occluded = isect.ray_test(scene, sh_ray)
        wo_local = si.to_local(ds.d)
        M_nee = bpol.eval_pol(scene, meta, si, wo_local)
        if spectral_terms is not None:
            M_nee = spectral_terms(si, wo_local, M_nee, lam, None)
            em_weight = emitter_mod.spectral_radiance(
                scene, em_weight, ds.emitter_idx, lam)
        b_pdf = bsdf_mod.pdf(scene, meta, si, wo_local)
        w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, b_pdf))
        contrib = emit(st.throughput @ M_nee, em_weight * w_nee[:, None])
        result = result + torch.where((nee_active & ~occluded)
                                      [:, None, None], contrib, 0.0)

        # --- bsdf sampling ---------------------------------------------
        u1b, smp = smp.next_1d()
        u2b, smp = smp.next_2d()
        bs, M_w = bpol.sample_pol(scene, meta, si, u1b, u2b)
        if spectral_terms is not None:
            M_w = spectral_terms(si, bs.wo, M_w, lam, bs.null)
        throughput = st.throughput @ M_w
        eta = st.eta * bs.eta
        new_ray = spawn_ray(si.p, si.to_world(bs.wo))
        active = active & (bs.pdf > 0) \
            & (throughput[..., 0, 0] > 0).any(dim=-1)

        # --- russian roulette on the depolarized power -------------------
        u_rr, smp = smp.next_1d()
        survive, throughput = roulette(throughput, eta, st.depth, rr_depth,
                                       u_rr)
        active = active & survive

        return st._replace(
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

    return body, max_depth


def initial_fields(ray: Ray, C: int, active=None) -> dict:
    """The fields every polarized state starts a camera path with."""
    N = ray.o.shape[0]
    dev = ray.o.device
    return dict(
        throughput=torch.eye(4, device=dev).expand(N, C, 4, 4),
        result=torch.zeros((N, C, 4), device=dev),
        eta=torch.ones((N,), device=dev),
        depth=torch.zeros((N,), dtype=torch.int32, device=dev),
        active=initial_active(active, N, dev),
        prev_pdf=torch.ones((N,), device=dev),
        prev_delta=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_p=ray.o)


def sample_stokes_vec(scene, meta, sampler: Sampler, ray: Ray, active=None,
                      diff: bool = False, aux=None):
    """The polarized L_i estimate: (Stokes (N, 3, 4), valid, sampler) in
    the implicit Stokes frame of each camera ray. The reference's loop
    counter equals every live lane's depth: at most ``max_depth``
    bounces, each checkpointed under ``diff``."""
    body, max_depth = make_body(scene, meta)
    st = PolPathState(sampler=sampler, ray=ray,
                      **initial_fields(ray, 3, active))
    st = bounce_loop(body, st, max_depth, diff)
    return st.result, torch.ones_like(st.active), st.sampler


def sensor_frame_rotation(scene, ray: Ray):
    """The rotator taking each camera ray's implicit Stokes frame to the
    sensor's horizontal axis: the target basis is ``cross(ray.d, up)``
    with up the sensor-to-world image of (0, 1, 0)."""
    up = scene.sensor.to_world.apply_vector(
        torch.tensor([[0.0, 1.0, 0.0]], device=ray.d.device))   # (1, 3)
    fwd = -ray.d
    current = mu.stokes_basis(fwd)
    target = m.cross(ray.d, up.expand(ray.d.shape))
    tn = m.norm(target)
    target = torch.where((tn > 1e-6)[:, None],
                         target / m.clip(tn, min=1e-12)[:, None],
                         current)
    return mu.rotate_stokes_basis(fwd, current, target)


def sample_full(scene, meta, sampler: Sampler, ray: Ray, active=None,
                diff: bool = False, aux=None):
    """The sensor-frame Stokes estimate: (Stokes (N, 3, 4), valid,
    sampler)."""
    stokes, valid, sampler = sample_stokes_vec(scene, meta, sampler, ray,
                                               active, diff=diff, aux=aux)
    R = sensor_frame_rotation(scene, ray)          # (N, 4, 4)
    stokes = torch.einsum('nij,ncj->nci', R, stokes)
    return stokes, valid, sampler
