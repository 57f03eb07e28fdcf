"""Hero-wavelength spectral path tracer.

Port of ``mitsuba_nlvrl_tpu/integrators/path_spectral.py``, the
``*_spectral`` variant of the path integrator: each lane carries 4
stratified hero wavelengths drawn from the RGB camera's importance
distribution, the throughput is an (N, 4) spectral vector, and every
RGB-packed scene quantity is upsampled on the fly (``core/spectral.py``):

  * BSDF weights through ``upsample_weight``; named conductors with
    tabulated eta/k curves swap the upsampled RGB Fresnel for the
    per-wavelength one (``bsdf.spectral_fresnel_ratio``);
  * RGB emitters through ``emitter_spectrum`` (upsampled chroma times
    D65); blackbody and tabulated emitters evaluate their SPD
    (``emitter.spectral_radiance``).

The estimate is integrated against the CIE curves and converted to linear
sRGB here, so the film is unchanged. Sampling decisions (NEE, lobe choice,
Russian roulette) use the RGB dispatch and do not depend on the
wavelength.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core import spectral as sp
from ..core.ray import Ray, spawn_ray
from ..core.rng import Sampler
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from ..ops import intersect as isect
from .common import (bounce_loop, initial_active, mis_weight,
                     russian_roulette)
from .path import _max_depth

# the golden ratio's fractional part: the wavelength sequence's step
_GOLDEN = 0.6180339887498949


class SpecPathState(NamedTuple):
    sampler: Sampler
    ray: Ray
    throughput: torch.Tensor     # (N, 4) spectral
    result: torch.Tensor         # (N, 4) spectral radiance
    eta: torch.Tensor
    depth: torch.Tensor          # (N,) int32
    active: torch.Tensor
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    prev_p: torch.Tensor
    lam: torch.Tensor            # (N, 4) hero wavelengths


def hero_wavelengths(sampler: Sampler, N: int):
    """(wavelengths (N, 4), inverse pdfs (N, 4), sampler): a golden-ratio
    sequence over the wavefront with one rotation a pass, uniform for
    each lane and nearly stratified across the film."""
    u_r, sampler = sampler.next_1d()
    idx = torch.arange(N, dtype=torch.float32, device=u_r.device)
    u_lam = torch.remainder(m.fma(idx, _GOLDEN, u_r[0].expand(N)), 1.0)
    lam, inv_pdf = sp.sample_hero_wavelengths(u_lam)
    return lam, inv_pdf, sampler


def emitted(scene, meta, si, st, lam):
    """The spectral radiance (N, 4) reaching the lanes from emitters they
    hit and from the environment, MIS-weighted against the previous
    bounce's NEE."""
    le = emitter_mod.eval_hit(scene, meta, si, st.active & si.valid)
    em_pdf = emitter_mod.pdf_direction(scene, meta, st.prev_p, si,
                                       st.active & si.valid)
    escaped = st.active & ~si.valid
    le_env = emitter_mod.eval_env(scene, meta, st.ray.d, escaped)
    env_pdf = emitter_mod.pdf_env_direction(scene, meta, escaped, st.ray.d)
    w_hit = torch.where(st.prev_delta, 1.0, mis_weight(st.prev_pdf, em_pdf))
    w_env = torch.where(st.prev_delta, 1.0, mis_weight(st.prev_pdf, env_pdf))
    le_s = emitter_mod.spectral_radiance(scene, le * w_hit[:, None],
                                         si.emitter_idx, lam)
    le_env_rgb = le_env * w_env[:, None]
    if emitter_mod.E_CONSTANT in meta.emitter_types:
        e_env = emitter_mod.env_emitter_idx(scene, meta).expand(
            le_env.shape[:1]).to(torch.int32)
        le_env_s = emitter_mod.spectral_radiance(scene, le_env_rgb, e_env,
                                                 lam)
    else:
        le_env_s = sp.emitter_spectrum(le_env_rgb, lam)
    return le_s + le_env_s


def sample(scene, meta, sampler: Sampler, ray: Ray, active=None,
           diff: bool = False, aux=None):
    """The spectral L_i estimate developed to linear sRGB: (rgb, valid,
    sampler). ``diff=True`` checkpoints each bounce, as ``path`` does."""
    N = ray.o.shape[0]
    dev = ray.o.device
    max_depth = _max_depth(meta)
    rr_depth = meta.iprop('rr_depth', 5)
    lam, inv_pdf, sampler = hero_wavelengths(sampler, N)

    st = SpecPathState(
        sampler=sampler, ray=ray,
        throughput=torch.ones((N, sp.N_HERO), device=dev),
        result=torch.zeros((N, sp.N_HERO), device=dev),
        eta=torch.ones((N,), device=dev),
        depth=torch.zeros((N,), dtype=torch.int32, device=dev),
        active=initial_active(active, N, dev),
        prev_pdf=torch.ones((N,), device=dev),
        prev_delta=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_p=ray.o, lam=lam)

    def body(st: SpecPathState) -> SpecPathState:
        si = isect.ray_intersect(scene, st.ray)
        smp = st.sampler.count_rays(st.active)
        result = st.result + st.throughput * emitted(scene, meta, si, st,
                                                     st.lam)
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
        f_val = bsdf_mod.eval(scene, meta, si, wo_local)
        b_pdf = bsdf_mod.pdf(scene, meta, si, wo_local)
        w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, b_pdf))
        em_weight_s = emitter_mod.spectral_radiance(scene, em_weight,
                                                    ds.emitter_idx, st.lam)
        f_s = sp.upsample_weight(f_val, st.lam)
        fr_nee = bsdf_mod.spectral_fresnel_ratio(scene, meta, si, wo_local,
                                                 st.lam)
        if fr_nee is not None:
            f_s = f_s * fr_nee
        contrib = st.throughput * f_s * em_weight_s * w_nee[:, None]
        result = result + torch.where((nee_active & ~occluded)[:, None],
                                      contrib, 0.0)

        # --- bsdf sampling ---------------------------------------------
        u1b, smp = smp.next_1d()
        u2b, smp = smp.next_2d()
        bs, b_weight = bsdf_mod.sample(scene, meta, si, u1b, u2b)
        w_s = sp.upsample_weight(b_weight, st.lam)
        fr_b = bsdf_mod.spectral_fresnel_ratio(scene, meta, si, bs.wo,
                                               st.lam)
        if fr_b is not None:
            w_s = w_s * fr_b
        throughput = st.throughput * w_s
        eta = st.eta * bs.eta
        new_ray = spawn_ray(si.p, si.to_world(bs.wo))
        active = active & (bs.pdf > 0) & (throughput > 0).any(dim=-1)

        # --- russian roulette ------------------------------------------
        u_rr, smp = smp.next_1d()
        survive, throughput = russian_roulette(throughput, eta, st.depth,
                                               rr_depth, u_rr)
        active = active & survive

        return SpecPathState(
            sampler=smp,
            ray=Ray(o=torch.where(active[:, None], new_ray.o, st.ray.o),
                    d=torch.where(active[:, None], new_ray.d, st.ray.d),
                    mint=new_ray.mint, maxt=new_ray.maxt),
            throughput=throughput, result=result, eta=eta,
            depth=torch.where(st.active, st.depth + 1, st.depth),
            active=active,
            prev_pdf=torch.where(active, bs.pdf, st.prev_pdf),
            prev_delta=torch.where(active, bs.delta, st.prev_delta),
            prev_p=torch.where(active[:, None], si.p, st.prev_p),
            lam=st.lam)

    # the reference's loop counter equals every live lane's depth
    st = bounce_loop(body, st, max_depth, diff)
    rgb = sp.spectral_to_srgb(st.result, lam, inv_pdf)
    return rgb, torch.ones((N,), dtype=torch.bool, device=dev), st.sampler
