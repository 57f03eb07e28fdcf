"""BSDF evaluation and sampling with masked type dispatch.

Port of ``mitsuba_nlvrl_tpu/bsdf/__init__.py`` for ``diffuse``,
``conductor``, ``dielectric``, ``thindielectric``, ``null`` (the
pass-through boundary of a medium), the microfacet ``roughconductor`` and
``roughdielectric``, the ``plastic``, ``roughplastic`` and ``pplastic``
family, and ``twosided`` (the nested BSDF's row with ``F_TWOSIDED``:
backfaces mirror to the upper hemisphere). Parameters live in a packed
(B, BSDF_NPARAM) table with the reference's layout; each lane gathers its
row, and every type present in the scene (``SceneMeta.bsdf_types``) is
evaluated masked over the whole wavefront, then selected. The rough
lobes use GGX whatever ``distribution`` says, as the reference does.

Directions are in the local shading frame (z = normal); ``eval`` returns
f * |cos_theta_o| and ``sample`` returns (record, f * cos / pdf).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import math as m
from ..core import frame as fr
from ..core import microfacet as mf
from ..core import warp
from ..core.fresnel import (fresnel_dielectric, fresnel_conductor,
                            reflect_local, refract_local)
from ..scene.ior_data import conductor_rgb, lookup_ior
from ..scene.types import (BSDF_TYPES, F_DELTA, F_NULL, F_TRANSMISSION,
                           F_SMOOTH, F_TWOSIDED, BSDF_NPARAM, SLICE_BSDFS,
                           not_in_slice)

RADIANCE = 0
IMPORTANCE = 1


class BSDFSample(NamedTuple):
    wo: torch.Tensor      # (N, 3) sampled outgoing dir, local frame
    pdf: torch.Tensor     # (N,)
    eta: torch.Tensor     # (N,) relative IOR of the sampled event
    delta: torch.Tensor   # (N,) bool — sampled a Dirac lobe
    null: torch.Tensor    # (N,) bool — sampled the null pass-through lobe


# --- parameter packing (host side, used by the scene builder) ---------------

_IOR_KEYS = ('int_ior', 'ext_ior')


def pack_params(props: dict) -> Tuple[int, int, list]:
    """Return (type_code, flags, params[BSDF_NPARAM]) for a bsdf dict."""
    t = props['type']
    if t not in SLICE_BSDFS:
        raise not_in_slice(f"bsdf type '{t}'", "item 7 (materials)")
    if t == 'twosided':
        # the nested BSDF's row, flagged: backfaces mirror to the front
        code, flags, p = pack_params(props.get('bsdf', {'type': 'diffuse'}))
        return code, flags | F_TWOSIDED, p
    p = [0.0] * BSDF_NPARAM

    def value(key, default):
        v = props.get(key, default)
        if isinstance(v, dict) or (isinstance(v, str)
                                   and key not in _IOR_KEYS):
            raise not_in_slice(f"textured, spectral or named parameter "
                               f"{key}={v!r}", "item 7 (textures)")
        return v

    def rgb(key, default):
        v = value(key, default)
        if isinstance(v, (int, float)):
            return [float(v)] * 3
        return [float(x) for x in v]

    def scalar(key, default):
        return float(value(key, default))

    def ior(key, default):
        return lookup_ior(value(key, default))

    def conductor_eta_k():
        mat = props.get('material')
        if isinstance(mat, str):
            # a named material's tabulated eta/k, integrated to RGB
            pair = conductor_rgb(mat)
            if pair is not None:
                return list(pair[0]), list(pair[1])
            print(f"warning: conductor material {mat!r} has no "
                  f".spd data; keeping eta/k defaults")
        return rgb('eta', 0.0), rgb('k', 1.0)

    def alphas():
        a = scalar('alpha', 0.1)
        return scalar('alpha_u', a), scalar('alpha_v', a)

    if t == 'diffuse':
        p[0:3] = rgb('reflectance', 0.5)
        p[15] = -1.0     # no reflectance texture
        return BSDF_TYPES[t], F_SMOOTH, p
    if t in ('conductor', 'roughconductor'):
        p[0:3], p[3:6] = conductor_eta_k()
        p[6:9] = rgb('specular_reflectance', 1.0)
        if t == 'conductor':
            return BSDF_TYPES[t], F_DELTA, p
        p[9], p[10] = alphas()
        p[11] = 0.0 if props.get('distribution', 'ggx') == 'ggx' else 1.0
        return BSDF_TYPES[t], F_SMOOTH, p
    if t == 'null':
        return BSDF_TYPES[t], F_DELTA | F_NULL | F_TRANSMISSION, p
    if t in ('dielectric', 'thindielectric', 'roughdielectric'):
        p[0] = ior('int_ior', 1.5046)     # bk7
        p[1] = ior('ext_ior', 1.000277)   # air
        p[2:5] = rgb('specular_reflectance', 1.0)
        p[5:8] = rgb('specular_transmittance', 1.0)
        if t != 'roughdielectric':
            return BSDF_TYPES[t], F_DELTA | F_TRANSMISSION, p
        p[9], p[10] = alphas()
        return BSDF_TYPES[t], F_SMOOTH | F_TRANSMISSION, p
    # plastic, roughplastic, pplastic
    p[0:3] = rgb('diffuse_reflectance', 0.5)
    p[3] = ior('int_ior', 1.49)
    p[4] = ior('ext_ior', 1.000277)
    p[5] = 1.0 if props.get('nonlinear', False) else 0.0
    p[6:9] = rgb('specular_reflectance', 1.0)
    p[9] = scalar('alpha', 0.1 if t != 'pplastic' else 0.06)
    p[15] = -1.0     # no diffuse_reflectance texture
    if t == 'pplastic':
        # the specular lobe's sampling weight s_mean / (d_mean + s_mean)
        d_mean = sum(p[0:3]) / 3.0
        s_mean = sum(p[6:9]) / 3.0
        p[12] = s_mean / max(d_mean + s_mean, 1e-6)
        return BSDF_TYPES[t], F_SMOOTH, p
    return BSDF_TYPES[t], F_SMOOTH | (F_DELTA if t == 'plastic' else 0), p


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


def _thindielectric_sample(P, wi, u1, u2, mode):
    eta = P[:, 0] / P[:, 1]
    R, _, _, _ = fresnel_dielectric(torch.abs(fr.cos_theta(wi)), eta)
    # the internal bounces: R' = 2R / (1 + R)
    R = torch.where(R < 1.0, R * 2.0 / (1.0 + R), R)
    sel_r = u1 <= R
    wo = torch.where(sel_r[:, None], reflect_local(wi), -wi)
    pdf = torch.where(sel_r, R, 1.0 - R)
    weight = torch.where(sel_r[:, None], P[:, 2:5], P[:, 5:8])
    bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                    delta=torch.ones_like(sel_r),
                    null=torch.zeros_like(sel_r))
    return bs, weight


def _reflect_about(wi, h):
    return 2.0 * m.dot(wi, h, keepdims=True) * h - wi


def _spec_pdf(wi, wo, h, ax, ay):
    """The pdf of a VNDF-sampled reflection: pdf_h / (4 |wo.h|)."""
    return mf.vndf_pdf(wi, h, ax, ay) \
        / (4.0 * torch.clamp(torch.abs(m.dot(wo, h)), min=1e-9))


def _roughconductor_eval(P, wi, wo):
    cos_i, cos_o = fr.cos_theta(wi), fr.cos_theta(wo)
    act = (cos_i > 0) & (cos_o > 0)
    h = m.normalize(wi + wo)
    ax, ay = P[:, 9], P[:, 10]
    D = mf.ggx_d(h, ax, ay)
    G = mf.smith_g1(wi, h, ax, ay) * mf.smith_g1(wo, h, ax, ay)
    F = fresnel_conductor(m.dot(wi, h), P[:, 0:3], P[:, 3:6])
    val = P[:, 6:9] * F \
        * (D * G / (4.0 * torch.clamp(cos_i, min=1e-9)))[:, None]
    return torch.where(act[:, None], val, 0.0)


def _roughconductor_pdf(P, wi, wo):
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    h = m.normalize(wi + wo)
    return torch.where(act, _spec_pdf(wi, wo, h, P[:, 9], P[:, 10]), 0.0)


def _roughconductor_sample(P, wi, u1, u2, mode):
    ax, ay = P[:, 9], P[:, 10]
    h, pdf_h = mf.sample_vndf(wi, u2, ax, ay)
    wo = _reflect_about(wi, h)
    pdf = pdf_h / (4.0 * torch.clamp(torch.abs(m.dot(wo, h)), min=1e-9))
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0) & (pdf > 0)
    f = _roughconductor_eval(P, wi, wo)
    weight = torch.where(act[:, None],
                         f / torch.clamp(pdf, min=1e-20)[:, None], 0.0)
    return _smooth_sample(wo, torch.where(act, pdf, 0.0), act), weight


def _smooth_sample(wo, pdf, act, eta=None):
    no = torch.zeros_like(act)
    return BSDFSample(wo=wo, pdf=pdf,
                      eta=torch.ones_like(pdf) if eta is None else eta,
                      delta=no, null=no)


def _roughdielectric_h(wi, wo, eta):
    """(half vector in the upper hemisphere, cos_i, cos_o, reflection
    case, eta along the path) of Walter et al.'s model."""
    cos_i, cos_o = fr.cos_theta(wi), fr.cos_theta(wo)
    reflect_case = cos_i * cos_o > 0
    eta_path = torch.where(cos_i > 0, eta, 1.0 / eta)
    h = torch.where(reflect_case[:, None], m.normalize(wi + wo),
                    m.normalize(wi + wo * eta_path[:, None]))
    h = h * torch.sign(fr.cos_theta(h))[:, None]
    return h, cos_i, cos_o, reflect_case, eta_path


def _roughdielectric_eval(P, wi, wo):
    """Walter et al. 2007 microfacet refraction."""
    eta = P[:, 0] / P[:, 1]
    h, cos_i, cos_o, reflect_case, eta_path = _roughdielectric_h(wi, wo, eta)
    ax, ay = P[:, 9], P[:, 10]
    D = mf.ggx_d(h, ax, ay)
    wi_h = m.dot(wi, h)
    wo_h = m.dot(wo, h)
    F, _, _, _ = fresnel_dielectric(wi_h, eta)
    G = mf.smith_g1(wi * torch.sign(cos_i)[:, None], h, ax, ay) \
        * mf.smith_g1(wo * torch.sign(cos_o)[:, None], h, ax, ay)
    # reflection: F D G / (4 |cos_i|), the cosine of wo included
    val_r = P[:, 2:5] * (F * D * G / (4.0 * torch.clamp(torch.abs(cos_i),
                                                        min=1e-9)))[:, None]
    denom = wi_h + eta_path * wo_h
    jac = torch.abs(wi_h * wo_h) / torch.clamp(
        torch.abs(cos_i) * m.sqr(denom), min=1e-12)
    val_t = P[:, 5:8] * ((1.0 - F) * D * G * m.sqr(eta_path) * jac
                         / torch.clamp(m.sqr(eta_path), min=1e-12))[:, None]
    val = torch.where(reflect_case[:, None], val_r, val_t)
    ok = (torch.abs(cos_i) > 1e-6) & (D > 0)
    return torch.where(ok[:, None], val, 0.0)


def _roughdielectric_pdf(P, wi, wo):
    eta = P[:, 0] / P[:, 1]
    h, cos_i, _, reflect_case, eta_path = _roughdielectric_h(wi, wo, eta)
    ax, ay = P[:, 9], P[:, 10]
    pdf_h = mf.vndf_pdf(wi * torch.sign(cos_i)[:, None], h, ax, ay)
    wi_h = m.dot(wi, h)
    wo_h = m.dot(wo, h)
    F, _, _, _ = fresnel_dielectric(wi_h, eta)
    prob = torch.where(reflect_case, F, 1.0 - F)
    dwh_refl = 1.0 / (4.0 * torch.clamp(torch.abs(wo_h), min=1e-9))
    denom = wi_h + eta_path * wo_h
    dwh_refr = m.sqr(eta_path) * torch.abs(wo_h) \
        / torch.clamp(m.sqr(denom), min=1e-12)
    jac = torch.where(reflect_case, dwh_refl, dwh_refr)
    return torch.clamp(prob * pdf_h * jac, min=0.0)


def _roughdielectric_sample(P, wi, u1, u2, mode):
    eta = P[:, 0] / P[:, 1]
    cos_i = fr.cos_theta(wi)
    ax, ay = P[:, 9], P[:, 10]
    side = torch.sign(cos_i)[:, None]
    h_up, pdf_h = mf.sample_vndf(wi * side, u2, ax, ay)
    h = h_up * side                     # on the side of wi
    wi_h = m.dot(wi, h)
    F, cos_t, eta_it, eta_ti = fresnel_dielectric(wi_h, eta)
    sel_r = u1 <= F
    wo_r = 2.0 * wi_h[:, None] * h - wi
    # refraction about h
    wo_t = m.normalize(eta_ti[:, None] * (wi_h[:, None] * h - wi)
                       + cos_t[:, None] * h)
    wo = torch.where(sel_r[:, None], wo_r, wo_t)
    cos_o = fr.cos_theta(wo)
    ok = torch.where(sel_r, cos_i * cos_o > 0, cos_i * cos_o < 0) \
        & (torch.abs(cos_i) > 1e-6) & (pdf_h > 0)
    f = _roughdielectric_eval(P, wi, wo)
    pdf = _roughdielectric_pdf(P, wi, wo)
    factor = torch.where(~sel_r, eta_ti, 1.0) if mode == RADIANCE \
        else torch.ones_like(eta_ti)
    weight = torch.where(ok[:, None], f * m.safe_rcp(pdf)[:, None]
                         * m.sqr(factor)[:, None], 0.0)
    return _smooth_sample(wo, torch.where(ok, pdf, 0.0), ok,
                          eta=torch.where(sel_r, 1.0, eta_it)), weight


def _plastic_fdr(eta):
    """The average Fresnel diffuse reflectance (d'Eon and Irving's fit)."""
    inv_eta = 1.0 / eta
    return torch.where(
        eta < 1.0,
        -0.4399 + 0.7099 * inv_eta - 0.3319 * m.sqr(inv_eta)
        + 0.0636 * inv_eta * m.sqr(inv_eta),
        ((((-0.0001 * eta + 0.0213) * eta - 0.1568) * eta + 0.4212) * eta
         - 0.8747) * eta + 0.9574
        + (-1.8725 / eta + (0.1257 / m.sqr(eta)) + 0.9196) * 0.0)


def _plastic_sample(P, wi, u1, u2, mode):
    """Smooth plastic: a specular Dirac lobe chosen with probability F(wi)
    and a Fresnel-attenuated diffuse lobe."""
    cos_i = fr.cos_theta(wi)
    eta = P[:, 3] / P[:, 4]
    Fi, _, _, _ = fresnel_dielectric(cos_i, eta)
    prob_spec = Fi
    sel_spec = u1 < prob_spec
    wo = torch.where(sel_spec[:, None], reflect_local(wi),
                     warp.square_to_cosine_hemisphere(u2))
    Fo, _, _, _ = fresnel_dielectric(fr.cos_theta(wo), eta)
    refl = P[:, 0:3]
    diff = refl / torch.clamp(1.0 - refl * _plastic_fdr(1.0 / eta)[:, None],
                              min=1e-6) \
        * (1.0 / m.sqr(eta) * (1.0 - Fi) * (1.0 - Fo))[:, None]
    w_diff = diff / torch.clamp(1.0 - prob_spec, min=1e-6)[:, None]
    act = cos_i > 0
    weight = torch.where(sel_spec[:, None], P[:, 6:9], w_diff)
    weight = torch.where(act[:, None], weight, 0.0)
    pdf = torch.where(sel_spec, prob_spec, (1.0 - prob_spec)
                      * warp.square_to_cosine_hemisphere_pdf(wo))
    bs = BSDFSample(wo=wo, pdf=torch.where(act, pdf, 0.0),
                    eta=torch.ones_like(pdf), delta=sel_spec,
                    null=torch.zeros_like(sel_spec))
    return bs, weight


def _plastic_eval(P, wi, wo):
    cos_i, cos_o = fr.cos_theta(wi), fr.cos_theta(wo)
    act = (cos_i > 0) & (cos_o > 0)
    eta = P[:, 3] / P[:, 4]
    Fi, _, _, _ = fresnel_dielectric(cos_i, eta)
    Fo, _, _, _ = fresnel_dielectric(cos_o, eta)
    refl = P[:, 0:3]
    fdr = _plastic_fdr(1.0 / eta)
    inv_eta2 = 1.0 / m.sqr(eta)
    val = refl / torch.clamp(1.0 - refl * fdr[:, None], min=1e-6) \
        * (m.InvPi * cos_o * inv_eta2 * (1.0 - Fi) * (1.0 - Fo))[:, None]
    return torch.where(act[:, None], val, 0.0)


def _plastic_pdf(P, wi, wo):
    cos_i, cos_o = fr.cos_theta(wi), fr.cos_theta(wo)
    act = (cos_i > 0) & (cos_o > 0)
    Fi, _, _, _ = fresnel_dielectric(cos_i, P[:, 3] / P[:, 4])
    return torch.where(act, (1.0 - Fi)
                       * warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _ggx_spec(P, wi, wo, eta):
    """The GGX specular lobe of the rough plastics: F(wi.h) D G / (4
    cos_i) times the specular reflectance."""
    ax = ay = P[:, 9]
    h = m.normalize(wi + wo)
    D = mf.ggx_d(h, ax, ay)
    G = mf.smith_g1(wi, h, ax, ay) * mf.smith_g1(wo, h, ax, ay)
    Fh, _, _, _ = fresnel_dielectric(m.dot(wi, h), eta)
    return P[:, 6:9] * (Fh * D * G / (4.0 * torch.clamp(fr.cos_theta(wi),
                                                        min=1e-9)))[:, None]


def _roughplastic_eval(P, wi, wo):
    """GGX specular plus Fresnel-attenuated diffuse."""
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    spec = _ggx_spec(P, wi, wo, P[:, 3] / P[:, 4])
    return torch.where(act[:, None], spec + _plastic_eval(P, wi, wo), 0.0)


def _roughplastic_pdf(P, wi, wo):
    cos_i = fr.cos_theta(wi)
    act = (cos_i > 0) & (fr.cos_theta(wo) > 0)
    Fi, _, _, _ = fresnel_dielectric(cos_i, P[:, 3] / P[:, 4])
    h = m.normalize(wi + wo)
    pdf_spec = _spec_pdf(wi, wo, h, P[:, 9], P[:, 9])
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(act, Fi * pdf_spec + (1.0 - Fi) * pdf_diff, 0.0)


def _mixture_sample(P, wi, u1, u2, prob_spec, eval_fn, pdf_fn):
    """Choose the VNDF-sampled specular lobe with probability
    ``prob_spec``, else the cosine-weighted diffuse lobe (u2 serves both);
    weight f / pdf of the mixture."""
    cos_i = fr.cos_theta(wi)
    sel_spec = u1 < prob_spec
    h, _ = mf.sample_vndf(wi, u2, P[:, 9], P[:, 9])
    wo = torch.where(sel_spec[:, None], _reflect_about(wi, h),
                     warp.square_to_cosine_hemisphere(u2))
    pdf = pdf_fn(P, wi, wo)
    f = eval_fn(P, wi, wo)
    act = (cos_i > 0) & (fr.cos_theta(wo) > 0) & (pdf > 1e-12)
    weight = torch.where(act[:, None], f * m.safe_rcp(pdf)[:, None], 0.0)
    return _smooth_sample(wo, torch.where(act, pdf, 0.0), act), weight


def _roughplastic_sample(P, wi, u1, u2, mode):
    Fi, _, _, _ = fresnel_dielectric(fr.cos_theta(wi), P[:, 3] / P[:, 4])
    return _mixture_sample(P, wi, u1, u2, Fi, _roughplastic_eval,
                           _roughplastic_pdf)


def _pplastic_eval(P, wi, wo):
    """The polarized plastic's unpolarized arm: GGX specular reflection
    plus a Fresnel-attenuated Lambertian lobe (refract in, scatter,
    refract out; no internal-scattering series)."""
    cos_i, cos_o = fr.cos_theta(wi), fr.cos_theta(wo)
    act = (cos_i > 0) & (cos_o > 0)
    eta = P[:, 3] / P[:, 4]
    spec = _ggx_spec(P, wi, wo, eta)
    Fi, _, _, _ = fresnel_dielectric(cos_i, eta)
    Fo, _, _, _ = fresnel_dielectric(cos_o, eta)
    diff = P[:, 0:3] * ((1.0 - Fo) * (1.0 - Fi) * m.InvPi * cos_o)[:, None]
    return torch.where(act[:, None], spec + diff, 0.0)


def _pplastic_pdf(P, wi, wo):
    """The mixture pdf with the static specular weight (slot 12)."""
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    prob_spec = P[:, 12]
    h = m.normalize(wi + wo)
    p_spec = _spec_pdf(wi, wo, h, P[:, 9], P[:, 9])
    p_spec = torch.where((m.dot(wi, h) > 0) & (m.dot(wo, h) > 0), p_spec, 0.0)
    p_diff = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(act, prob_spec * p_spec + (1.0 - prob_spec) * p_diff,
                       0.0)


def _pplastic_sample(P, wi, u1, u2, mode):
    return _mixture_sample(P, wi, u1, u2, P[:, 12], _pplastic_eval,
                           _pplastic_pdf)


# conductor, dielectric, thindielectric and null are pure Dirac lobes:
# eval and pdf are zero
_EVAL = {
    BSDF_TYPES['diffuse']: _diffuse_eval,
    BSDF_TYPES['roughconductor']: _roughconductor_eval,
    BSDF_TYPES['roughdielectric']: _roughdielectric_eval,
    BSDF_TYPES['plastic']: _plastic_eval,
    BSDF_TYPES['roughplastic']: _roughplastic_eval,
    BSDF_TYPES['pplastic']: _pplastic_eval,
}
_PDF = {
    BSDF_TYPES['diffuse']: _diffuse_pdf,
    BSDF_TYPES['roughconductor']: _roughconductor_pdf,
    BSDF_TYPES['roughdielectric']: _roughdielectric_pdf,
    BSDF_TYPES['plastic']: _plastic_pdf,
    BSDF_TYPES['roughplastic']: _roughplastic_pdf,
    BSDF_TYPES['pplastic']: _pplastic_pdf,
}
_SAMPLE = {
    BSDF_TYPES['diffuse']: _diffuse_sample,
    BSDF_TYPES['conductor']: _conductor_sample,
    BSDF_TYPES['dielectric']: _dielectric_sample,
    BSDF_TYPES['thindielectric']: _thindielectric_sample,
    BSDF_TYPES['null']: _null_sample,
    BSDF_TYPES['roughconductor']: _roughconductor_sample,
    BSDF_TYPES['roughdielectric']: _roughdielectric_sample,
    BSDF_TYPES['plastic']: _plastic_sample,
    BSDF_TYPES['roughplastic']: _roughplastic_sample,
    BSDF_TYPES['pplastic']: _pplastic_sample,
}


def _rows(scene, si):
    b = si.bsdf_idx.long()
    return scene.bsdfs.type[b], scene.bsdfs.flags[b], scene.bsdfs.params[b]


def _flip_of(flags, wi):
    """Twosided rows whose wi arrives from below: their local directions
    mirror to the upper hemisphere."""
    return ((flags & F_TWOSIDED) > 0) & (fr.cos_theta(wi) < 0)


def _maybe_flip(flags, wi, *others):
    fv = torch.where(_flip_of(flags, wi)[:, None],
                     torch.tensor([1.0, 1.0, -1.0], device=wi.device), 1.0)
    return (wi * fv,) + tuple(o * fv for o in others)


def eval(scene, meta, si, wo, mode=RADIANCE):
    """f(wi, wo) * |cos_theta_o| for each lane (zero for pure-delta lanes)."""
    btype, flags, P = _rows(scene, si)
    wi, wo = _maybe_flip(flags, si.wi, wo)
    out = torch.zeros(wo.shape[:-1] + (3,), device=wo.device)
    for code in meta.bsdf_types:
        fn = _EVAL.get(code)
        if fn is not None:
            out = torch.where((btype == code)[:, None], fn(P, wi, wo), out)
    return out


def pdf(scene, meta, si, wo):
    btype, flags, P = _rows(scene, si)
    wi, wo = _maybe_flip(flags, si.wi, wo)
    out = torch.zeros(wo.shape[:-1], device=wo.device)
    for code in meta.bsdf_types:
        fn = _PDF.get(code)
        if fn is not None:
            out = torch.where(btype == code, fn(P, wi, wo), out)
    return out


def sample(scene, meta, si, u1, u2, mode=RADIANCE):
    btype, flags, P = _rows(scene, si)
    (wi,) = _maybe_flip(flags, si.wi)
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
    # the sampled direction of a flipped twosided lane goes back below
    flip = _flip_of(flags, si.wi)[:, None]
    wo = torch.where(flip, bs.wo * torch.tensor([1.0, 1.0, -1.0], device=dev),
                     bs.wo)
    return bs._replace(wo=wo), weight


def flags_of(scene, si):
    return scene.bsdfs.flags[si.bsdf_idx.long()]


def eval_null_transmission(scene, meta, si):
    """Transmittance of straight-through rays: 1 for null BSDFs, 0 for
    the other types of this slice (``mask`` and the polarizing elements
    come with items 7 and 10)."""
    is_null = (flags_of(scene, si) & F_NULL) > 0
    return torch.where(is_null[:, None], 1.0,
                       torch.zeros((si.wi.shape[0], 3), device=si.wi.device))
