"""BSDF evaluation and sampling with masked type dispatch.

Port of ``mitsuba_nlvrl_tpu/bsdf/__init__.py`` for ``diffuse``,
``conductor``, ``dielectric`` and ``null`` (the pass-through boundary of
a medium). Parameters live in a packed
(B, BSDF_NPARAM) table with the reference's layout; each lane gathers its
row, and every type present in the scene (``SceneMeta.bsdf_types``) is
evaluated masked over the whole wavefront, then selected.

Directions are in the local shading frame (z = normal); ``eval`` returns
f * |cos_theta_o| and ``sample`` returns (record, f * cos / pdf).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import math as m
from ..core import frame as fr
from ..core import warp
from ..core.fresnel import (fresnel_dielectric, fresnel_conductor,
                            reflect_local, refract_local)
from ..scene.ior_data import conductor_rgb, lookup_ior
from ..scene.types import (BSDF_TYPES, F_DELTA, F_NULL, F_TRANSMISSION,
                           F_SMOOTH, BSDF_NPARAM, SLICE_BSDFS, not_in_slice)

RADIANCE = 0
IMPORTANCE = 1


class BSDFSample(NamedTuple):
    wo: torch.Tensor      # (N, 3) sampled outgoing dir, local frame
    pdf: torch.Tensor     # (N,)
    eta: torch.Tensor     # (N,) relative IOR of the sampled event
    delta: torch.Tensor   # (N,) bool — sampled a Dirac lobe
    null: torch.Tensor    # (N,) bool — sampled the null pass-through lobe


# --- parameter packing (host side, used by the scene builder) ---------------

def pack_params(props: dict) -> Tuple[int, int, list]:
    """Return (type_code, flags, params[BSDF_NPARAM]) for a bsdf dict."""
    t = props['type']
    if t not in SLICE_BSDFS:
        raise not_in_slice(f"bsdf type '{t}'", "item 7 (materials)")
    p = [0.0] * BSDF_NPARAM

    def value(v):
        if isinstance(v, dict) or (isinstance(v, str) and t != 'dielectric'):
            raise not_in_slice(f"textured, spectral or named parameter "
                               f"{v!r}", "item 7 (textures)")
        return v

    def rgb(key, default):
        v = value(props.get(key, default))
        if isinstance(v, (int, float)):
            return [float(v)] * 3
        return [float(x) for x in v]

    if t == 'diffuse':
        p[0:3] = rgb('reflectance', 0.5)
        p[15] = -1.0     # no reflectance texture
        return BSDF_TYPES[t], F_SMOOTH, p
    if t == 'conductor':
        p[0:3], p[3:6] = rgb('eta', 0.0), rgb('k', 1.0)
        mat = props.get('material')
        if isinstance(mat, str):
            # a named material's tabulated eta/k, integrated to RGB
            pair = conductor_rgb(mat)
            if pair is None:
                print(f"warning: conductor material {mat!r} has no "
                      f".spd data; keeping eta/k defaults")
            else:
                p[0:3], p[3:6] = list(pair[0]), list(pair[1])
        p[6:9] = rgb('specular_reflectance', 1.0)
        return BSDF_TYPES[t], F_DELTA, p
    if t == 'null':
        return BSDF_TYPES[t], F_DELTA | F_NULL | F_TRANSMISSION, p
    # dielectric
    p[0] = lookup_ior(value(props.get('int_ior', 1.5046)))    # bk7
    p[1] = lookup_ior(value(props.get('ext_ior', 1.000277)))  # air
    p[2:5] = rgb('specular_reflectance', 1.0)
    p[5:8] = rgb('specular_transmittance', 1.0)
    return BSDF_TYPES[t], F_DELTA | F_TRANSMISSION, p


# --- per-type implementations ----------------------------------------------
# Each takes gathered per-lane params P: (N, BSDF_NPARAM), local wi/wo.

def _diffuse_eval(P, wi, wo):
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    val = P[:, 0:3] * (m.InvPi * fr.cos_theta(wo))[:, None]
    return torch.where(act[:, None], val, 0.0)


def _diffuse_pdf(P, wi, wo):
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    return torch.where(act, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _diffuse_sample(P, wi, u1, u2, mode):
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    act = fr.cos_theta(wi) > 0
    weight = torch.where(act[:, None], P[:, 0:3], 0.0)
    bs = BSDFSample(wo=wo, pdf=torch.where(act, pdf, 0.0),
                    eta=torch.ones_like(pdf), delta=torch.zeros_like(act),
                    null=torch.zeros_like(act))
    return bs, weight


def _conductor_sample(P, wi, u1, u2, mode):
    cos_i = fr.cos_theta(wi)
    act = cos_i > 0
    wo = reflect_local(wi)
    F = fresnel_conductor(cos_i, P[:, 0:3], P[:, 3:6])
    weight = torch.where(act[:, None], P[:, 6:9] * F, 0.0)
    bs = BSDFSample(wo=wo, pdf=torch.where(act, 1.0, 0.0),
                    eta=torch.ones_like(cos_i), delta=act,
                    null=torch.zeros_like(act))
    return bs, weight


def _dielectric_sample(P, wi, u1, u2, mode):
    cos_i = fr.cos_theta(wi)
    eta = P[:, 0] / P[:, 1]
    F, cos_t, eta_it, eta_ti = fresnel_dielectric(cos_i, eta)
    sel_r = u1 <= F
    wo = torch.where(sel_r[:, None], reflect_local(wi),
                     refract_local(wi, cos_t, eta_ti))
    pdf = torch.where(sel_r, F, 1.0 - F)
    factor = eta_ti if mode == RADIANCE else torch.ones_like(eta_ti)
    w_r = P[:, 2:5]
    w_t = P[:, 5:8] * m.sqr(factor)[:, None]
    weight = torch.where(sel_r[:, None], w_r, w_t)
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.where(sel_r, 1.0, eta_it),
                    delta=torch.ones_like(sel_r),
                    null=torch.zeros_like(sel_r))
    return bs, weight


def _null_sample(P, wi, u1, u2, mode):
    N = wi.shape[0]
    one = torch.ones((N,), dtype=wi.dtype, device=wi.device)
    tru = torch.ones((N,), dtype=torch.bool, device=wi.device)
    bs = BSDFSample(wo=-wi, pdf=one, eta=one, delta=tru, null=tru)
    return bs, torch.ones((N, 3), dtype=wi.dtype, device=wi.device)


# conductor, dielectric and null are pure Dirac lobes: eval and pdf are zero
_EVAL = {BSDF_TYPES['diffuse']: _diffuse_eval}
_PDF = {BSDF_TYPES['diffuse']: _diffuse_pdf}
_SAMPLE = {
    BSDF_TYPES['diffuse']: _diffuse_sample,
    BSDF_TYPES['conductor']: _conductor_sample,
    BSDF_TYPES['dielectric']: _dielectric_sample,
    BSDF_TYPES['null']: _null_sample,
}


def _rows(scene, si):
    b = si.bsdf_idx.long()
    return scene.bsdfs.type[b], scene.bsdfs.params[b]


def eval(scene, meta, si, wo, mode=RADIANCE):
    """f(wi, wo) * |cos_theta_o| for each lane (zero for pure-delta lanes)."""
    btype, P = _rows(scene, si)
    out = torch.zeros(wo.shape[:-1] + (3,), device=wo.device)
    for code in meta.bsdf_types:
        fn = _EVAL.get(code)
        if fn is not None:
            out = torch.where((btype == code)[:, None], fn(P, si.wi, wo), out)
    return out


def pdf(scene, meta, si, wo):
    btype, P = _rows(scene, si)
    out = torch.zeros(wo.shape[:-1], device=wo.device)
    for code in meta.bsdf_types:
        fn = _PDF.get(code)
        if fn is not None:
            out = torch.where(btype == code, fn(P, si.wi, wo), out)
    return out


def sample(scene, meta, si, u1, u2, mode=RADIANCE):
    btype, P = _rows(scene, si)
    wi = si.wi
    N = wi.shape[0]
    dev = wi.device
    bs = BSDFSample(wo=torch.zeros((N, 3), device=dev),
                    pdf=torch.zeros((N,), device=dev),
                    eta=torch.ones((N,), device=dev),
                    delta=torch.zeros((N,), dtype=torch.bool, device=dev),
                    null=torch.zeros((N,), dtype=torch.bool, device=dev))
    weight = torch.zeros((N, 3), device=dev)
    for code in meta.bsdf_types:
        bs_c, w_c = _SAMPLE[code](P, wi, u1, u2, mode)
        sel = btype == code
        bs = BSDFSample(
            wo=torch.where(sel[:, None], bs_c.wo, bs.wo),
            pdf=torch.where(sel, bs_c.pdf, bs.pdf),
            eta=torch.where(sel, bs_c.eta, bs.eta),
            delta=torch.where(sel, bs_c.delta, bs.delta),
            null=torch.where(sel, bs_c.null, bs.null))
        weight = torch.where(sel[:, None], w_c, weight)
    return bs, weight


def flags_of(scene, si):
    return scene.bsdfs.flags[si.bsdf_idx.long()]


def eval_null_transmission(scene, meta, si):
    """Transmittance of straight-through rays: 1 for null BSDFs, 0 for
    the other types of this slice (``mask`` and the polarizing elements
    come with items 7 and 10)."""
    is_null = (flags_of(scene, si) & F_NULL) > 0
    return torch.where(is_null[:, None], 1.0,
                       torch.zeros((si.wi.shape[0], 3), device=si.wi.device))
