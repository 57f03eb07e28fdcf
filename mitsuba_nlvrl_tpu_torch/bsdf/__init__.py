"""BSDF evaluation and sampling with masked type dispatch.

Port of ``mitsuba_nlvrl_tpu/bsdf/__init__.py``: ``diffuse``,
``conductor``, ``dielectric``, ``thindielectric``, ``null`` (the
pass-through boundary of a medium), the microfacet ``roughconductor`` and
``roughdielectric``, the ``plastic``, ``roughplastic`` and ``pplastic``
family, and the wrappers: ``twosided`` and ``mask`` (the nested BSDF's
row with ``F_TWOSIDED`` or ``F_MASK``: backfaces mirror to the upper
hemisphere; a mask passes rays through with probability 1 - opacity),
``blendbsdf`` (a row naming two sub-rows and a weight), ``normalmap`` and
``bumpmap`` (a row naming the nested row and the texture that tilts the
shading frame), and the measured ``measured`` and ``measured_polarized``
(a row naming its material's tables in ``SceneData.measured`` or
``measured_pol``; ``bsdf/measured.py``, ``bsdf/measured_pol.py``).
Parameters live in a packed (B, BSDF_NPARAM) table with
the reference's layout; each lane gathers its row, and every type present
in the scene (``SceneMeta.bsdf_types``) is evaluated masked over the
whole wavefront, then selected. Textured parameters are texture ids in
slots 15-19 of a row (diffuse reflectance, alpha, specular reflectance,
opacity, blend weight), looked up per lane. The rough lobes use GGX
whatever ``distribution`` says, as the reference does.

Directions are in the local shading frame (z = normal); ``eval`` returns
f * |cos_theta_o| and ``sample`` returns (record, f * cos / pdf).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from ..core import math as m
from ..core import frame as fr
from ..core import microfacet as mf
from ..core import warp
from ..core.fresnel import (fresnel_dielectric, fresnel_conductor,
                            reflect_local, refract_local)
from ..scene.ior_data import conductor_rgb, conductor_spd_id, lookup_ior
from ..scene.types import (BSDF_TYPES, F_DELTA, F_NULL, F_TRANSMISSION,
                           F_SMOOTH, F_TWOSIDED, F_MASK, BSDF_NPARAM,
                           SLICE_BSDFS)

RADIANCE = 0
IMPORTANCE = 1


class BSDFSample(NamedTuple):
    wo: torch.Tensor      # (N, 3) sampled outgoing dir, local frame
    pdf: torch.Tensor     # (N,)
    eta: torch.Tensor     # (N,) relative IOR of the sampled event
    delta: torch.Tensor   # (N,) bool — sampled a Dirac lobe
    null: torch.Tensor    # (N,) bool — sampled the null pass-through lobe


# --- parameter packing (host side, used by the scene builder) ---------------

_BUILDER_ROWS = ('blendbsdf', 'normalmap', 'bumpmap', 'measured',
                 'measured_polarized')


def pack_params(props: dict) -> Tuple[int, int, list]:
    """Return (type_code, flags, params[BSDF_NPARAM]) for a bsdf dict.

    A textured parameter packs an untextured fallback (0.5 grey, or the
    scalar's default); the builder registers its texture and passes the
    id in ``_texture_id``, ``_alpha_tex``, ``_spec_tex`` or
    ``_opacity_tex``. The BSDF nested in ``twosided`` or ``mask`` packs
    here too, without such ids: its own textures are not registered, as
    in the reference. ``blendbsdf``, ``normalmap`` and ``bumpmap`` rows
    name other rows, so the builder packs them."""
    t = props['type']
    # the rows that name other rows or tables are packed by the builder;
    # nested in ``twosided`` or ``mask`` they raise here, as in the
    # reference
    if t not in SLICE_BSDFS or t in _BUILDER_ROWS:
        raise NotImplementedError(f"bsdf type {t}")
    if t == 'twosided':
        # the nested BSDF's row, flagged: backfaces mirror to the front
        code, flags, p = pack_params(props.get('bsdf', {'type': 'diffuse'}))
        return code, flags | F_TWOSIDED, p
    if t == 'mask':
        # the nested BSDF's row with the opacity in slot 14; a textured
        # opacity rides slot 18 as id + 1 and rewrites slot 14 per lane
        code, flags, p = pack_params(props.get('bsdf', {'type': 'diffuse'}))
        op = props.get('opacity', 0.5)
        if isinstance(op, dict):
            p[14] = 0.5
        else:
            p[14] = float(op if isinstance(op, (int, float)) else
                          sum(op) / len(op))
        p[18] = float(props.get('_opacity_tex', -1)) + 1.0
        return code, flags | F_MASK | F_NULL | F_TRANSMISSION, p
    p = [0.0] * BSDF_NPARAM
    # textured alpha and specular reflectance: id + 1 (0 = untextured)
    p[16] = float(props.get('_alpha_tex', -1)) + 1.0
    p[17] = float(props.get('_spec_tex', -1)) + 1.0

    def rgb(key, default):
        v = props.get(key, default)
        if isinstance(v, dict):
            return [0.5, 0.5, 0.5]      # textured: the fallback
        if isinstance(v, (int, float)):
            return [float(v)] * 3
        return [float(x) for x in v]

    def scalar(key, default):
        v = props.get(key, default)
        return float(default) if isinstance(v, dict) else float(v)

    def ior(key, default):
        return lookup_ior(props.get(key, default))

    def conductor_eta_k():
        mat = props.get('material')
        if isinstance(mat, str):
            # a named material's tabulated eta/k, integrated to RGB; its
            # curves are registered for the spectral variants (slot 13 =
            # curve id + 1; 0 = RGB only)
            pair = conductor_rgb(mat)
            if pair is not None:
                sid = conductor_spd_id(mat)
                if sid is not None:
                    p[13] = float(sid + 1)
                return list(pair[0]), list(pair[1])
            print(f"warning: conductor material {mat!r} has no "
                  f".spd data; keeping eta/k defaults")
        return rgb('eta', 0.0), rgb('k', 1.0)

    def alphas():
        a = scalar('alpha', 0.1)
        return scalar('alpha_u', a), scalar('alpha_v', a)

    if t == 'diffuse':
        p[0:3] = rgb('reflectance', 0.5)
        p[15] = float(props.get('_texture_id', -1))
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
    if t in ('polarizer', 'retarder', 'circular'):
        # optical elements. Unpolarized transport reduces them to null
        # pass-through attenuators, weight 0.5 T / T / 0.5 T (slots 0:3);
        # the polarized layer (bsdf/polarized.py) reads the element's
        # rotation theta in radians (slot 3), the retarder's phase delay
        # in radians or the circular element's handedness +1/-1 (slot 4)
        # and the raw transmittance (5:8)
        fac = 1.0 if t == 'retarder' else 0.5
        tr_rgb = rgb('transmittance', 1.0)
        p[0:3] = [fac * c for c in tr_rgb]
        p[3] = float(props.get('theta', 0.0)) * math.pi / 180.0
        if t == 'retarder':
            p[4] = float(props.get('delta', 90.0)) * math.pi / 180.0
        elif t == 'circular':
            p[4] = -1.0 if props.get('left_handed', False) else 1.0
        p[5:8] = tr_rgb
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
    p[15] = float(props.get('_texture_id', -1))
    if t == 'pplastic':
        # the specular lobe's sampling weight s_mean / (d_mean + s_mean)
        d_mean = sum(p[0:3]) / 3.0
        s_mean = sum(p[6:9]) / 3.0
        p[12] = s_mean / max(d_mean + s_mean, 1e-6)
        return BSDF_TYPES[t], F_SMOOTH, p
    return BSDF_TYPES[t], F_SMOOTH | (F_DELTA if t == 'plastic' else 0), p


# --- per-type implementations ----------------------------------------------
# Each takes gathered per-lane params P: (N, BSDF_NPARAM), local wi/wo.

# A parameter row, and a direction, on which every lobe of this module is
# finite: iors 1.5 and 1 (slots 0, 1 and 3, 4), alpha and every other
# slot 0.5; and the normal.
_FINITE_ROW = (1.5, 1.0, 0.5, 1.5, 1.0) + (0.5,) * (BSDF_NPARAM - 5)


@functools.lru_cache(maxsize=16)
def _finite_consts(dtype, device):
    return (torch.tensor(_FINITE_ROW, dtype=dtype, device=device),
            torch.tensor((0.0, 0.0, 1.0), dtype=dtype, device=device))


def _finite_lanes(keep, P, *dirs):
    """The double-``where`` idiom for lanes whose result the caller drops:
    outside ``keep`` the row P becomes ``_FINITE_ROW`` and each direction
    the normal, so that every factor computed there is finite. The
    caller's select sends those lanes a zero cotangent, which must not
    meet an infinite factor (0 * inf is NaN, and the NaN would reach every
    parameter through the row gather). Kept lanes compute as before, to
    the bit; without autograd nothing is replaced."""
    if not torch.is_grad_enabled() or not any(
            x.requires_grad for x in (P,) + dirs):
        return (P,) + dirs
    k = keep[:, None]
    row = _finite_consts(P.dtype, P.device)[0]
    up = _finite_consts(dirs[0].dtype, dirs[0].device)[1]
    return (torch.where(k, P, row),) + tuple(torch.where(k, d, up)
                                             for d in dirs)


def _diffuse_eval(P, wi, wo, textured_refl=None):
    refl = textured_refl if textured_refl is not None else P[:, 0:3]
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    val = refl * (m.InvPi * fr.cos_theta(wo))[:, None]
    return torch.where(act[:, None], val, 0.0)


def _diffuse_pdf(P, wi, wo):
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    return torch.where(act, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _diffuse_sample(P, wi, u1, u2, mode, textured_refl=None):
    refl = textured_refl if textured_refl is not None else P[:, 0:3]
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    act = fr.cos_theta(wi) > 0
    weight = torch.where(act[:, None], refl, 0.0)
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


def _attenuator_sample(P, wi, u1, u2, mode):
    """Null pass-through attenuated by slots 0:3: the unpolarized
    reduction of ``polarizer``, ``retarder`` and ``circular``."""
    bs, _ = _null_sample(P, wi, u1, u2, mode)
    return bs, P[:, 0:3]


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
        / (4.0 * m.clip(torch.abs(m.dot(wo, h)), min=1e-9))


def _roughconductor_eval(P, wi, wo):
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    P, wi, wo = _finite_lanes(act, P, wi, wo)
    cos_i = fr.cos_theta(wi)
    h = m.normalize(wi + wo)
    ax, ay = P[:, 9], P[:, 10]
    D = mf.ggx_d(h, ax, ay)
    G = mf.smith_g1(wi, h, ax, ay) * mf.smith_g1(wo, h, ax, ay)
    F = fresnel_conductor(m.dot(wi, h), P[:, 0:3], P[:, 3:6])
    val = P[:, 6:9] * F \
        * (D * G / (4.0 * m.clip(cos_i, min=1e-9)))[:, None]
    return torch.where(act[:, None], val, 0.0)


def _roughconductor_pdf(P, wi, wo):
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    P, wi, wo = _finite_lanes(act, P, wi, wo)
    h = m.normalize(wi + wo)
    return torch.where(act, _spec_pdf(wi, wo, h, P[:, 9], P[:, 10]), 0.0)


def _roughconductor_sample(P, wi, u1, u2, mode):
    ax, ay = P[:, 9], P[:, 10]
    h, pdf_h = mf.sample_vndf(wi, u2, ax, ay)
    wo = _reflect_about(wi, h)
    pdf = pdf_h / (4.0 * m.clip(torch.abs(m.dot(wo, h)), min=1e-9))
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0) & (pdf > 0)
    f = _roughconductor_eval(P, wi, wo)
    weight = torch.where(act[:, None],
                         f / m.clip(pdf, min=1e-20)[:, None], 0.0)
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
    grazing = torch.abs(fr.cos_theta(wi)) <= 1e-6     # dropped below
    P, wi, wo = _finite_lanes(~grazing, P, wi, wo)
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
    val_r = P[:, 2:5] * (F * D * G / (4.0 * m.clip(torch.abs(cos_i),
                                                        min=1e-9)))[:, None]
    denom = wi_h + eta_path * wo_h
    jac = torch.abs(wi_h * wo_h) / m.clip(
        torch.abs(cos_i) * m.sqr(denom), min=1e-12)
    val_t = P[:, 5:8] * ((1.0 - F) * D * G * m.sqr(eta_path) * jac
                         / m.clip(m.sqr(eta_path), min=1e-12))[:, None]
    val = torch.where(reflect_case[:, None], val_r, val_t)
    ok = ~grazing & (D > 0)
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
    dwh_refl = 1.0 / (4.0 * m.clip(torch.abs(wo_h), min=1e-9))
    denom = wi_h + eta_path * wo_h
    dwh_refr = m.sqr(eta_path) * torch.abs(wo_h) \
        / m.clip(m.sqr(denom), min=1e-12)
    jac = torch.where(reflect_case, dwh_refl, dwh_refr)
    return m.clip(prob * pdf_h * jac, min=0.0)


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
    diff = refl / m.clip(1.0 - refl * _plastic_fdr(1.0 / eta)[:, None],
                              min=1e-6) \
        * (1.0 / m.sqr(eta) * (1.0 - Fi) * (1.0 - Fo))[:, None]
    w_diff = diff / m.clip(1.0 - prob_spec, min=1e-6)[:, None]
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
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    P, wi, wo = _finite_lanes(act, P, wi, wo)
    cos_i, cos_o = fr.cos_theta(wi), fr.cos_theta(wo)
    eta = P[:, 3] / P[:, 4]
    Fi, _, _, _ = fresnel_dielectric(cos_i, eta)
    Fo, _, _, _ = fresnel_dielectric(cos_o, eta)
    refl = P[:, 0:3]
    fdr = _plastic_fdr(1.0 / eta)
    inv_eta2 = 1.0 / m.sqr(eta)
    val = refl / m.clip(1.0 - refl * fdr[:, None], min=1e-6) \
        * (m.InvPi * cos_o * inv_eta2 * (1.0 - Fi) * (1.0 - Fo))[:, None]
    return torch.where(act[:, None], val, 0.0)


def _plastic_pdf(P, wi, wo):
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    P, wi, wo = _finite_lanes(act, P, wi, wo)
    Fi, _, _, _ = fresnel_dielectric(fr.cos_theta(wi), P[:, 3] / P[:, 4])
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
    return P[:, 6:9] * (Fh * D * G / (4.0 * m.clip(fr.cos_theta(wi),
                                                        min=1e-9)))[:, None]


def _roughplastic_eval(P, wi, wo):
    """GGX specular plus Fresnel-attenuated diffuse."""
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    P, wi, wo = _finite_lanes(act, P, wi, wo)
    spec = _ggx_spec(P, wi, wo, P[:, 3] / P[:, 4])
    return torch.where(act[:, None], spec + _plastic_eval(P, wi, wo), 0.0)


def _roughplastic_pdf(P, wi, wo):
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    P, wi, wo = _finite_lanes(act, P, wi, wo)
    Fi, _, _, _ = fresnel_dielectric(fr.cos_theta(wi), P[:, 3] / P[:, 4])
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
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    P, wi, wo = _finite_lanes(act, P, wi, wo)
    cos_i, cos_o = fr.cos_theta(wi), fr.cos_theta(wo)
    eta = P[:, 3] / P[:, 4]
    spec = _ggx_spec(P, wi, wo, eta)
    Fi, _, _, _ = fresnel_dielectric(cos_i, eta)
    Fo, _, _, _ = fresnel_dielectric(cos_o, eta)
    diff = P[:, 0:3] * ((1.0 - Fo) * (1.0 - Fi) * m.InvPi * cos_o)[:, None]
    return torch.where(act[:, None], spec + diff, 0.0)


def _pplastic_pdf(P, wi, wo):
    """The mixture pdf with the static specular weight (slot 12)."""
    act = (fr.cos_theta(wi) > 0) & (fr.cos_theta(wo) > 0)
    P, wi, wo = _finite_lanes(act, P, wi, wo)
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
    BSDF_TYPES['polarizer']: _attenuator_sample,
    BSDF_TYPES['retarder']: _attenuator_sample,
    BSDF_TYPES['circular']: _attenuator_sample,
    BSDF_TYPES['pplastic']: _pplastic_sample,
}
_ATTENUATORS = tuple(BSDF_TYPES[t]
                     for t in ('polarizer', 'retarder', 'circular'))


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


# --- textured parameters and the wrappers ------------------------------------

def _texture_kw(scene, meta, si) -> dict:
    """The hit point and vertex colour, where the scene's textures read
    them."""
    from .. import texture as tex_mod
    kw = {}
    if getattr(meta, 'has_3d_textures', False):
        kw['p_world'] = si.p
    if getattr(meta, 'has_attr_textures', False):
        kw['attr'] = tex_mod.vertex_attr(scene, si)
    return kw


def _textured_reflectance(scene, meta, si, P):
    """Diffuse reflectance with its texture (slot 15 = texture id), or
    None in a scene without textures."""
    if not getattr(meta, 'has_textures', False):
        return None
    from .. import texture as tex_mod
    tex_id = P[:, 15].to(torch.int32)
    tex = tex_mod.eval(scene, tex_id, si.uv, **_texture_kw(scene, meta, si))
    return torch.where((tex_id >= 0)[:, None], tex, P[:, 0:3])


def _apply_param_textures(scene, meta, si, P, btype):
    """Rewrite the gathered rows with their textured values: slot 16
    (alpha texture id + 1, channel 0) -> alpha_u/v in slots 9 and 10;
    slot 17 (specular reflectance id + 1) -> slots 6:9, or 2:5 for the
    dielectric family; slot 15 (the plastic family's diffuse texture
    id) -> 0:3; slot 18 (mask opacity id + 1, channel 0) -> slot 14."""
    if not getattr(meta, 'has_param_textures', False):
        return P
    from .. import texture as tex_mod
    P = P.clone()
    a_id = P[:, 16].to(torch.int32) - 1
    tex_a = tex_mod.eval(scene, a_id, si.uv)[:, 0]
    alpha_ok = a_id >= 0
    P[:, 9] = torch.where(alpha_ok, tex_a, P[:, 9])
    P[:, 10] = torch.where(alpha_ok, tex_a, P[:, 10])
    s_id = P[:, 17].to(torch.int32) - 1
    tex_s = tex_mod.eval(scene, s_id, si.uv)
    diel = ((btype == BSDF_TYPES['dielectric'])
            | (btype == BSDF_TYPES['thindielectric'])
            | (btype == BSDF_TYPES['roughdielectric']))
    P[:, 6:9] = torch.where(((s_id >= 0) & ~diel)[:, None], tex_s,
                            P[:, 6:9])
    P[:, 2:5] = torch.where(((s_id >= 0) & diel)[:, None], tex_s, P[:, 2:5])
    plas = ((btype == BSDF_TYPES['plastic'])
            | (btype == BSDF_TYPES['roughplastic'])
            | (btype == BSDF_TYPES['pplastic']))
    d_id = torch.where(plas, P[:, 15].to(torch.int32), -1)
    tex_d = tex_mod.eval(scene, d_id, si.uv)
    P[:, 0:3] = torch.where((d_id >= 0)[:, None], tex_d, P[:, 0:3])
    o_id = P[:, 18].to(torch.int32) - 1
    tex_o = tex_mod.eval(scene, m.clip(o_id, min=0), si.uv)[:, 0]
    P[:, 14] = torch.where(o_id >= 0, tex_o, P[:, 14])
    return P


_BLEND = BSDF_TYPES['blendbsdf']
_NORMALMAP = BSDF_TYPES['normalmap']
_BUMPMAP = BSDF_TYPES['bumpmap']
# the bump map's central-difference step in uv
_BUMP_EPS = 5e-4


def _has_perturb(meta):
    return _NORMALMAP in meta.bsdf_types or _BUMPMAP in meta.bsdf_types


def _perturb_si(scene, meta, si):
    """Resolve the normalmap and bumpmap rows: tilt the shading frame by
    the row's texture and forward to the nested row. normalmap: the
    tangent-space normal 2 rgb - 1. bumpmap: central differences of the
    height texture in uv tilt the normal by -scale (dh/du, dh/dv) (uv
    differences, not the surface partials dp_du: the hit record carries
    unit tangents, as in the reference). The new tangent is the old one
    made orthogonal to the new normal. Every lane's frame is rebuilt
    this way, unperturbed lanes about their own normal."""
    from .. import texture as tex_mod
    from ..core.frame import Frame
    btype, _, P = _rows(scene, si)
    is_nm = btype == _NORMALMAP
    is_bm = btype == _BUMPMAP
    is_pert = is_nm | is_bm
    tex_id = torch.where(is_pert, P[:, 1].to(torch.int32), -1)
    N = btype.shape[0]
    dev = si.uv.device
    n_local = torch.cat([torch.zeros((N, 2), device=dev),
                         torch.ones((N, 1), device=dev)], -1)
    if _NORMALMAP in meta.bsdf_types:
        rgb = tex_mod.eval(scene, tex_id, si.uv)
        n_local = torch.where(is_nm[:, None], 2.0 * rgb - 1.0, n_local)
    if _BUMPMAP in meta.bsdf_types:
        scale = P[:, 2]
        du = torch.tensor([_BUMP_EPS, 0.0], device=dev)
        dv = torch.tensor([0.0, _BUMP_EPS], device=dev)

        def h(uv):
            return tex_mod.eval(scene, tex_id, uv)[:, 0]

        dh_du = (h(si.uv + du) - h(si.uv - du)) / (2.0 * _BUMP_EPS)
        dh_dv = (h(si.uv + dv) - h(si.uv - dv)) / (2.0 * _BUMP_EPS)
        n_bm = torch.stack([-scale * dh_du, -scale * dh_dv,
                            torch.ones_like(dh_du)], -1)
        n_local = torch.where(is_bm[:, None], n_bm, n_local)
    f = si.sh_frame
    n_w = m.normalize(f.to_world(m.normalize(n_local)))
    n_w = torch.where(is_pert[:, None], n_w, f.n)
    s = m.normalize(f.s - n_w * m.dot(n_w, f.s)[:, None])
    newf = Frame(s, m.cross(n_w, s), n_w)
    nested = torch.where(is_pert, P[:, 0].to(torch.int32), si.bsdf_idx)
    return si._replace(bsdf_idx=nested, sh_frame=newf,
                       wi=newf.to_local(f.to_world(si.wi)))


def _blend_weight(scene, meta, si, P):
    """Per-lane blend weight: slot 2, or the mean of the slot-19 texture
    (id + 1)."""
    w = P[:, 2]
    if not getattr(meta, 'has_textures', False):
        return w
    from .. import texture as tex_mod
    t_id = P[:, 19].to(torch.int32) - 1
    tex = tex_mod.eval(scene, m.clip(t_id, min=0), si.uv,
                       **_texture_kw(scene, meta, si))
    return torch.where(t_id >= 0, tex.mean(-1), w)


def _blend_sub(scene, si, P, which):
    """The hit with its BSDF row replaced by the blend's sub-row
    ``which``. Every lane reads slots 0 and 1 of its row, rows that are
    not blends too (their slots hold IORs and colours); such lanes are
    clamped into the table (the reference relies on JAX clamping) and
    their result is discarded."""
    row = m.clip(P[:, which].to(torch.int32), 0,
                      scene.bsdfs.type.shape[0] - 1)
    return si._replace(bsdf_idx=row)


def _unperturb_wo(f_orig, si, bs):
    """A sampled direction from the perturbed shading frame back into the
    caller's frame."""
    if f_orig is None:
        return bs
    return bs._replace(wo=f_orig.to_local(si.sh_frame.to_world(bs.wo)))


def eval(scene, meta, si, wo, mode=RADIANCE, textures=None,
         _depth: int = 0):
    """f(wi, wo) * |cos_theta_o| for each lane (zero for pure-delta lanes).
    ``_depth`` 1 evaluates a blend's sub-rows (no second perturbation or
    blend)."""
    if _depth == 0 and _has_perturb(meta):
        f0 = si.sh_frame
        si = _perturb_si(scene, meta, si)
        wo = si.sh_frame.to_local(f0.to_world(wo))
    btype, flags, P = _rows(scene, si)
    P = _apply_param_textures(scene, meta, si, P, btype)
    if textures is None:
        textures = _textured_reflectance(scene, meta, si, P)
    if _BLEND in meta.bsdf_types and _depth == 0:
        w = _blend_weight(scene, meta, si, P)
        fa = eval(scene, meta, _blend_sub(scene, si, P, 0), wo, mode, None, 1)
        fb = eval(scene, meta, _blend_sub(scene, si, P, 1), wo, mode, None, 1)
        blend_val = (1.0 - w)[:, None] * fa + w[:, None] * fb
        base = eval(scene, meta, si, wo, mode, textures, 1)
        return torch.where((btype == _BLEND)[:, None], blend_val, base)
    wi, wo = _maybe_flip(flags, si.wi, wo)
    out = torch.zeros(wo.shape[:-1] + (3,), device=wo.device)
    for code in meta.bsdf_types:
        fn = _EVAL.get(code)
        if fn is None:
            continue
        kw = {}
        if code == BSDF_TYPES['diffuse'] and textures is not None:
            kw['textured_refl'] = textures
        sel = btype == code
        out = torch.where(sel[:, None],
                          fn(*_finite_lanes(sel, P, wi, wo), **kw), out)
    for sel, data, mm, mod in _measured_slots(scene, meta, btype, P):
        val = (mod.eval(data, mm, wi, wo) if mm is not None
               else mod.eval(data, P, wi, wo))
        out = torch.where(sel[:, None], val, out)
    # a masked row's surface lobe is attenuated by its opacity
    return torch.where(((flags & F_MASK) > 0)[:, None], out * P[:, 14:15],
                       out)


def pdf(scene, meta, si, wo, _depth: int = 0):
    if _depth == 0 and _has_perturb(meta):
        f0 = si.sh_frame
        si = _perturb_si(scene, meta, si)
        wo = si.sh_frame.to_local(f0.to_world(wo))
    btype, flags, P = _rows(scene, si)
    P = _apply_param_textures(scene, meta, si, P, btype)
    if _BLEND in meta.bsdf_types and _depth == 0:
        w = _blend_weight(scene, meta, si, P)
        pa = pdf(scene, meta, _blend_sub(scene, si, P, 0), wo, 1)
        pb = pdf(scene, meta, _blend_sub(scene, si, P, 1), wo, 1)
        base = pdf(scene, meta, si, wo, 1)
        return torch.where(btype == _BLEND, (1.0 - w) * pa + w * pb, base)
    wi, wo = _maybe_flip(flags, si.wi, wo)
    out = torch.zeros(wo.shape[:-1], device=wo.device)
    for code in meta.bsdf_types:
        fn = _PDF.get(code)
        if fn is not None:
            sel = btype == code
            out = torch.where(sel, fn(*_finite_lanes(sel, P, wi, wo)), out)
    for sel, data, mm, mod in _measured_slots(scene, meta, btype, P):
        val = (mod.pdf(data, mm, wi, wo) if mm is not None
               else mod.pdf(P, wi, wo))
        out = torch.where(sel, val, out)
    return torch.where((flags & F_MASK) > 0, out * P[:, 14], out)


def sample(scene, meta, si, u1, u2, mode=RADIANCE, textures=None,
           _depth: int = 0):
    f_orig = None
    if _depth == 0 and _has_perturb(meta):
        f_orig = si.sh_frame
        si = _perturb_si(scene, meta, si)
    btype, flags, P = _rows(scene, si)
    P = _apply_param_textures(scene, meta, si, P, btype)
    if textures is None:
        textures = _textured_reflectance(scene, meta, si, P)
    if _BLEND in meta.bsdf_types and _depth == 0:
        # pick a sub-row by the blend weight and reuse its sample, the pdf
        # scaled by the pick's probability
        is_b = btype == _BLEND
        w = _blend_weight(scene, meta, si, P)
        pick_b = u1 < w
        sub_row = torch.where(pick_b, P[:, 1], P[:, 0]).to(torch.int32)
        si_sub = si._replace(bsdf_idx=torch.where(is_b, sub_row,
                                                  si.bsdf_idx))
        u1r = torch.where(is_b, torch.where(
            pick_b, u1 / m.clip(w, min=1e-6),
            (u1 - w) / m.clip(1.0 - w, min=1e-6)), u1)
        bs, weight = sample(scene, meta, si_sub, u1r, u2, mode, None, 1)
        prob = torch.where(is_b, torch.where(pick_b, w, 1.0 - w), 1.0)
        bs = bs._replace(pdf=bs.pdf * prob)
        return _unperturb_wo(f_orig, si, bs), weight
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
        fn = _SAMPLE.get(code)
        if fn is None:
            continue
        kw = {}
        if code == BSDF_TYPES['diffuse'] and textures is not None:
            kw['textured_refl'] = textures
        sel = btype == code
        P_c, wi_c = _finite_lanes(sel, P, wi)
        bs_c, w_c = fn(P_c, wi_c, u1, u2, mode, **kw)
        bs = BSDFSample(
            wo=torch.where(sel[:, None], bs_c.wo, bs.wo),
            pdf=torch.where(sel, bs_c.pdf, bs.pdf),
            eta=torch.where(sel, bs_c.eta, bs.eta),
            delta=torch.where(sel, bs_c.delta, bs.delta),
            null=torch.where(sel, bs_c.null, bs.null))
        weight = torch.where(sel[:, None], w_c, weight)
    for sel, data, mm, mod in _measured_slots(scene, meta, btype, P):
        wo_k, pdf_k, w_k = (mod.sample(data, mm, wi, u2) if mm is not None
                            else mod.sample(data, P, wi, u1, u2))
        bs = BSDFSample(
            wo=torch.where(sel[:, None], wo_k, bs.wo),
            pdf=torch.where(sel, pdf_k, bs.pdf),
            eta=torch.where(sel, 1.0, bs.eta),
            delta=bs.delta & ~sel, null=bs.null & ~sel)
        weight = torch.where(sel[:, None], w_k, weight)
    # the sampled direction of a flipped twosided lane goes back below
    flip = _flip_of(flags, si.wi)[:, None]
    bs = bs._replace(wo=torch.where(
        flip, bs.wo * torch.tensor([1.0, 1.0, -1.0], device=dev), bs.wo))
    # a masked row passes straight through with probability 1 - opacity
    # (u1 is reused by the nested lobe, as in the reference)
    opacity = P[:, 14]
    thru = ((flags & F_MASK) > 0) & (u1 >= opacity)
    bs = BSDFSample(
        wo=torch.where(thru[:, None], -wi, bs.wo),
        pdf=torch.where(thru, 1.0 - opacity, bs.pdf),
        eta=torch.where(thru, 1.0, bs.eta),
        delta=bs.delta | thru, null=bs.null | thru)
    weight = torch.where(thru[:, None], 1.0, weight)
    return _unperturb_wo(f_orig, si, bs), weight


def _measured_slots(scene, meta, btype, P):
    """(lane mask, tables, MeasuredMeta or None, module) of each measured
    material of the scene, one masked call a material as the reference
    loops over them: ``measured`` rows with their meta, then
    ``measured_polarized`` rows (meta None)."""
    out = []
    slot = P[:, 0].to(torch.int64)
    if BSDF_TYPES['measured'] in meta.bsdf_types:
        from . import measured as mod
        is_m = btype == BSDF_TYPES['measured']
        out += [(is_m & (slot == k), scene.measured[k], mm, mod)
                for k, mm in enumerate(meta.measured_meta)]
    if BSDF_TYPES['measured_polarized'] in meta.bsdf_types:
        from . import measured_pol as mod
        is_m = btype == BSDF_TYPES['measured_polarized']
        out += [(is_m & (slot == k), data, None, mod)
                for k, data in enumerate(scene.measured_pol)]
    return out


def flags_of(scene, si):
    return scene.bsdfs.flags[si.bsdf_idx.long()]


def eval_null_transmission(scene, meta, si):
    """Transmittance of straight-through rays: 1 for null BSDFs, 1 -
    opacity for masked ones, 0 otherwise."""
    btype, flags, P = _rows(scene, si)
    P = _apply_param_textures(scene, meta, si, P, btype)
    is_mask = (flags & F_MASK) > 0
    is_null = ((flags & F_NULL) > 0) & ~is_mask
    out = torch.where(is_null[:, None], 1.0,
                      torch.zeros((si.wi.shape[0], 3), device=si.wi.device))
    out = torch.where(is_mask[:, None], 1.0 - P[:, 14:15], out)
    # the optical elements attenuate straight-through rays by their
    # unpolarized weight
    is_att = torch.zeros_like(is_mask)
    for code in _ATTENUATORS:
        is_att = is_att | (btype == code)
    return torch.where(is_att[:, None], P[:, 0:3], out)


def spectral_fresnel_ratio(scene, meta, si, wo, lam):
    """A conductor's Fresnel term a hero wavelength at a time for the
    spectral variants. Their weights are upsample(f_rgb, lam); a
    conductor's f_rgb carries F_rgb(cos_h), so the factor F(lam, cos_h) /
    upsample(F_rgb, lam) puts the tabulated complex IOR's Fresnel in place
    of the upsampled one (exact for an achromatic specular reflectance).
    Returns an (N, L) factor (1 on other lanes and on conductors without a
    curve), or None when the scene has no tabulated curve. Conductor rows
    reached through a ``blendbsdf`` keep the RGB upsampling."""
    if not getattr(meta, 'has_conductor_spd', False):
        return None
    from ..core import spectral as sp
    if _has_perturb(meta):
        f0 = si.sh_frame
        si = _perturb_si(scene, meta, si)
        wo = si.sh_frame.to_local(f0.to_world(wo))
    btype, flags, P = _rows(scene, si)
    wi, wo = _maybe_flip(flags, si.wi, wo)
    is_cond = ((btype == BSDF_TYPES['conductor'])
               | (btype == BSDF_TYPES['roughconductor']))
    sid = P[:, 13].to(torch.int32) - 1
    use = is_cond & (sid >= 0)
    # the half-vector cosine: for the delta conductor wo = reflect(wi), so
    # normalize(wi + wo) is the normal and cos_h = cos_theta_i
    h = m.normalize(wi + wo)
    cos_h = torch.abs(m.dot(wi, h))
    curves = scene.conductor_spd[m.clip(sid, min=0).long()]
    eta_l = sp.cie_table_eval(curves[:, 0, :], lam)
    k_l = sp.cie_table_eval(curves[:, 1, :], lam)
    F_l = fresnel_conductor(cos_h, eta_l, k_l)                  # (N, L)
    F_rgb = fresnel_conductor(cos_h, P[:, 0:3], P[:, 3:6])      # (N, 3)
    F_up = sp.upsample_weight(F_rgb, lam)                       # (N, L)
    return torch.where(use[:, None] & (F_up > 1e-6),
                       F_l / m.clip(F_up, min=1e-6), 1.0)
