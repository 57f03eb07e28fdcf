"""Emitter evaluation and sampling with masked type dispatch.

Port of ``mitsuba_nlvrl_tpu/emitter/__init__.py`` for ``area``, ``point``,
``constant``, ``directional``, ``spot``, ``envmap`` and ``projector``:
uniform emitter pick plus per-type direction sampling toward a reference
point, emission for rays that hit emissive geometry or escape to the
environment (the constant light and the environment map, whose
luminance is importance-sampled through ``core/distr2d.py``), and
emission rays for light tracing (``sample_ray``). The reference's
one-hot-matmul gathers (``ops/gather.py``, a TPU workaround) are plain
indexing here.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..core import math as m
from ..core import warp
from ..core.frame import Frame
from ..core.ray import Ray
from ..core.records import DirectionSample
from ..scene.types import EMITTER_TYPES, EMITTER_NPARAM

E_AREA = EMITTER_TYPES['area']
E_POINT = EMITTER_TYPES['point']
E_CONSTANT = EMITTER_TYPES['constant']
E_DIRECTIONAL = EMITTER_TYPES['directional']
E_SPOT = EMITTER_TYPES['spot']
E_ENVMAP = EMITTER_TYPES['envmap']
E_PROJECTOR = EMITTER_TYPES['projector']


# --- environment map helpers -------------------------------------------------

def _env_uv_from_local(d):
    """Local direction -> equirectangular uv."""
    u = torch.atan2(d[..., 0], -d[..., 2]) * m.InvTwoPi
    u = torch.where(u < 0.0, u + 1.0, u)
    v = m.safe_acos(m.clip(d[..., 1], -1.0, 1.0)) * m.InvPi
    return u, v


def _env_dir_from_uv(u, v):
    """uv -> local direction (a spherical direction, then (y, z, -x))."""
    theta = v * m.Pi
    phi = u * (2.0 * m.Pi)
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.sin(phi), ct, -st * torch.cos(phi)],
                       dim=-1)


def _env_eval_uv(scene, u, v):
    """Bilinear environment-map lookup times its scale."""
    tex = scene.emitters.env_map
    H, W = tex.shape[0], tex.shape[1]
    x = u * W - 0.5
    y = m.clip(v * H - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = m.clip(y.to(torch.int64), 0, H - 1)
    y1 = m.clip(y0 + 1, max=H - 1)
    tx = x - x0
    ty = y - y0
    x0w = torch.remainder(x0, W)
    x1w = torch.remainder(x0 + 1, W)
    c = (tex[y0, x0w] * ((1 - tx) * (1 - ty))[..., None]
         + tex[y0, x1w] * (tx * (1 - ty))[..., None]
         + tex[y1, x0w] * ((1 - tx) * ty)[..., None]
         + tex[y1, x1w] * (tx * ty)[..., None])
    return c * scene.emitters.env_scale


def _env_solid_angle_pdf(pdf_uv, d_local):
    """The unit-square density of a direction over its solid angle
    (1 / (2 pi^2 sin theta))."""
    inv_sin = m.safe_rsqrt(m.clip(
        m.sqr(d_local[..., 0]) + m.sqr(d_local[..., 2]), min=1e-12))
    return pdf_uv * inv_sin / (2.0 * m.Pi * m.Pi)


def _env_sample(scene, u2):
    """A direction toward the environment map, sampled by luminance:
    (local direction, world direction, solid-angle pdf, radiance)."""
    from ..core import distr2d
    pos, pdf_uv = distr2d.sample_hierarchical(scene.emitters.env_warp, u2)
    uu, vv = pos[..., 0], pos[..., 1]
    d_local = _env_dir_from_uv(uu, vv)
    d_w = m.normalize(scene.emitters.env_to_world.apply_vector(d_local))
    return d_local, d_w, _env_solid_angle_pdf(pdf_uv, d_local), \
        _env_eval_uv(scene, uu, vv)


def _env_local(scene, ray_d):
    return m.normalize(
        scene.emitters.env_to_world.inverse().apply_vector(ray_d))


def _rotate(Rflat, v):
    """Row-major 3x3 matrices (N, 9) times vectors (N, 3)."""
    R = Rflat.reshape(-1, 3, 3)
    return (R[:, :, 0] * v[:, 0:1] + R[:, :, 1] * v[:, 1:2]
            + R[:, :, 2] * v[:, 2:3])


def _slide(scene, P, sel, uu, vv):
    """The projector's slide at (uu, vv) on the lanes ``sel``; 1 where the
    projector has no slide texture."""
    from .. import texture as tex_mod
    tex_id = torch.where(sel, P[:, 26].to(torch.int32) - 1, -1)
    slide = tex_mod.eval(scene, tex_id, torch.stack([uu, vv], -1))
    return torch.where((P[:, 26] > 0)[:, None], slide, 1.0)


SPEC_RGB = 0        # srgb_d65 expansion of the packed RGB (spectral mode)
SPEC_BLACKBODY = 1  # Planck's law at spec_param = temperature
SPEC_TABLE = 2      # tabulated SPD row spec_param of the scene's table


def spectrum_rgb(v: dict, spec: list) -> list:
    """The RGB radiance of a spectrum-valued emitter parameter (a
    blackbody, ``d65`` or a regular or irregular SPD), integrated at pack
    time as the reference's RGB variant does. ``spec`` (kind, param,
    scale, table row or None) receives the true spectrum, which the
    spectral variant samples at its hero wavelengths."""
    import numpy as np
    from ..core import spectral as sp
    from ..core.spectrum import (CIE_Y_NORMALIZATION, blackbody_rgb,
                                 spectrum_to_rgb)
    st = v.get('type', 'spectrum')
    scale = float(v.get('scale', 1.0))
    if st == 'blackbody':
        T = float(v.get('temperature', 6500.0))
        spec[0], spec[1], spec[2] = SPEC_BLACKBODY, T, \
            scale * CIE_Y_NORMALIZATION
        return [float(x) * scale for x in blackbody_rgb(T)]
    if st == 'd65':
        spec[0] = SPEC_TABLE
        spec[3] = (sp.D65_HAT * scale).astype(np.float32)
        return [scale] * 3
    if st == 'regular':
        wav = np.linspace(float(v.get('lambda_min', 360.0)),
                          float(v.get('lambda_max', 830.0)),
                          len(v['values']))
        vals = np.asarray(v['values'], np.float64)
    else:
        pairs = v.get('value', v.get('values'))
        wav = np.asarray([q[0] for q in pairs], np.float64)
        vals = np.asarray([q[1] for q in pairs], np.float64)
    grid = np.linspace(sp.CIE_MIN, sp.CIE_MAX, sp.CIE_SAMPLES)
    row = np.interp(grid, wav, vals, left=0.0, right=0.0)
    spec[0] = SPEC_TABLE
    spec[3] = (row * scale * CIE_Y_NORMALIZATION).astype(np.float32)
    return [float(x) * scale
            for x in spectrum_to_rgb(wav, vals, bounded=False)]


def pack_params(props: dict) -> Tuple[int, list, tuple]:
    """Pack an emitter to (type_code, params[EMITTER_NPARAM], spec), where
    ``spec`` = (kind, param, scale, table row or None) records its true
    spectrum for the spectral variant (RGB transport reads the packed,
    integrated RGB)."""
    t = props['type']
    if t not in EMITTER_TYPES:
        raise ValueError(f"unknown emitter type '{t}'")
    p = [0.0] * EMITTER_NPARAM
    spec = [SPEC_RGB, 0.0, 1.0, None]

    def rgb(key, default):
        v = props.get(key, default)
        if isinstance(v, dict):
            return spectrum_rgb(v, spec)
        if isinstance(v, (int, float)):
            return [float(v)] * 3
        return [float(x) for x in v]

    if t == 'area':
        p[0:3] = rgb('radiance', 1.0)
        return E_AREA, p, tuple(spec)
    if t == 'point':
        p[0:3] = [float(x) for x in props.get('position', (0, 0, 0))]
        p[3:6] = rgb('intensity', 1.0)
        return E_POINT, p, tuple(spec)
    if t == 'constant':
        p[0:3] = rgb('radiance', 1.0)
        return E_CONSTANT, p, tuple(spec)
    if t == 'directional':
        p[0:3] = [float(x) for x in props.get('direction', (0, 0, 1))]
        p[3:6] = rgb('irradiance', 1.0)
        return E_DIRECTIONAL, p, tuple(spec)
    if t == 'envmap':
        p[0] = float(props.get('scale', 1.0))
        return E_ENVMAP, p, tuple(spec)
    import numpy as np
    if t == 'spot':
        p[0:3] = [float(x) for x in props.get('position', (0, 0, 0))]
        p[3:6] = [float(x) for x in props.get('direction', (0, 0, 1))]
        p[6:9] = rgb('intensity', 1.0)
        cutoff = float(props.get('cutoff_angle', 20.0))
        beam = float(props.get('beam_width', cutoff * 0.75))
        p[9] = float(np.cos(np.deg2rad(cutoff)))
        p[10] = float(np.cos(np.deg2rad(beam)))
        return E_SPOT, p, tuple(spec)
    # projector: the reciprocal of the perspective camera, its irradiance
    # given on the virtual image plane at z = 1. Layout: position [0:3],
    # scale rgb [3:6], tan(fov/2) x and y [6], [7], the emitter-to-world
    # rotation [8:17] and its inverse [17:26], slide texture id + 1 [26].
    # The builder registers the slide (_irradiance_tex) and passes the
    # bitmap's aspect (_aspect).
    tw = props.get('to_world')
    M = np.asarray(tw.m) if tw is not None else np.eye(4)
    p[0:3] = [float(x) for x in M[:3, 3]]
    p[3:6] = rgb('scale', 1.0)
    fov = float(props.get('fov', 39.597755))  # 50mm-equivalent default
    tan_x = float(np.tan(np.deg2rad(fov) * 0.5))
    p[6] = tan_x
    p[7] = tan_x / max(float(props.get('_aspect', 1.0)), 1e-6)
    R = M[:3, :3]
    p[8:17] = [float(x) for x in R.reshape(-1)]
    p[17:26] = [float(x) for x in np.linalg.inv(R).reshape(-1)]
    p[26] = float(props.get('_irradiance_tex', -1)) + 1.0
    return E_PROJECTOR, p, tuple(spec)


def spectral_radiance(scene, rgb, e_idx, lam):
    """Promote an RGB emitter quantity (radiance, or a radiance/pdf NEE
    weight) to spectral samples at the hero wavelengths lam (N, L).

    Emitters given an RGB value take the srgb_d65 expansion; emitters
    given a true SPD (blackbody, d65, regular, irregular) evaluate it,
    and the achromatic factors the transport folded into ``rgb`` (pdfs,
    MIS weights, masks) come back as the luminance ratio against the
    emitter's packed radiance."""
    from ..core import spectral as sp
    from ..core.spectrum import luminance
    default = sp.emitter_spectrum(rgb, lam)
    em = scene.emitters
    e = m.clip(e_idx, min=0).long()
    kind = em.spec_kind[e]
    param = em.spec_param[e]
    scale = em.spec_scale[e]
    # the packed radiance's slot depends on the emitter type
    etype = em.type[e]
    offs = torch.where((etype == E_POINT) | (etype == E_DIRECTIONAL)
                       | (etype == E_PROJECTOR), 3,
                       torch.where(etype == E_SPOT, 6, 0))
    cols = offs[:, None].long() + torch.arange(3, device=lam.device)
    base_rgb = torch.gather(em.params[e], 1, cols)
    ratio = luminance(rgb) / m.clip(luminance(base_rgb), min=1e-12)
    bb = sp.planck(lam, m.clip(param, min=1.0)[:, None]) \
        * scale[:, None]
    # tabulated SPD rows on the regular 360-830 grid
    row = m.clip(param.to(torch.int32), 0,
                      em.spec_table.shape[0] - 1).long()
    t = (lam - sp.CIE_MIN) * ((sp.CIE_SAMPLES - 1)
                              / (sp.CIE_MAX - sp.CIE_MIN))
    ok = (lam >= sp.CIE_MIN) & (lam <= sp.CIE_MAX)
    i0 = t.to(torch.int32).clamp(0, sp.CIE_SAMPLES - 2).long()
    w1 = t - i0
    v0 = em.spec_table[row[:, None], i0]
    v1 = em.spec_table[row[:, None], i0 + 1]
    tab = torch.where(ok, v0 * (1.0 - w1) + v1 * w1, 0.0)
    spd = torch.where((kind == SPEC_BLACKBODY)[:, None], bb, tab) \
        * ratio[:, None]
    return torch.where((kind == SPEC_RGB)[:, None], default, spd)


def _segment_searchsorted(cdf, offset, count, u):
    """Per-lane binary search of u in cdf[offset:offset+count] with a
    fixed number of steps."""
    n_total = cdf.shape[0]
    lo = offset
    hi = offset + count  # exclusive
    steps = max(2, n_total.bit_length() + 1)
    for _ in range(steps):
        cont = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode='floor')
        go_right = cdf[m.clip(mid, 0, n_total - 1).long()] < u
        lo = torch.where(cont & go_right, mid + 1, lo)
        hi = torch.where(cont & ~go_right, mid, hi)
    return torch.minimum(torch.maximum(lo, offset), offset + count - 1)


def eval_hit(scene, meta, si, active):
    """Radiance emitted toward -ray.d at a surface hit (area emitters,
    front side only)."""
    if scene.emitters.type.shape[0] == 0:
        return torch.zeros(si.p.shape[:-1] + (3,), device=si.p.device)
    has = active & (si.emitter_idx >= 0)
    e = m.clip(si.emitter_idx, min=0).long()
    rad = scene.emitters.params[e][:, 0:3]
    front = si.wi[:, 2] > 0  # local frame: emitter normal side
    return torch.where((has & front)[:, None], rad, 0.0)


def eval_env(scene, meta, ray_d, active):
    """Environment radiance for escaped rays (constant and envmap)."""
    out = torch.zeros(ray_d.shape[:-1] + (3,), device=ray_d.device)
    if E_CONSTANT in meta.emitter_types:
        is_const = scene.emitters.type == E_CONSTANT
        rad = torch.where(is_const[:, None], scene.emitters.params[:, 0:3],
                          0.0)
        # rows summed left to right, as the reference's reduction adds them
        rad = functools.reduce(torch.add, rad.unbind(0))
        out = out + torch.where(active[:, None], rad[None, :], 0.0)
    if E_ENVMAP in meta.emitter_types:
        u, v = _env_uv_from_local(_env_local(scene, ray_d))
        out = out + torch.where(active[:, None], _env_eval_uv(scene, u, v),
                                0.0)
    return out


def env_emitter_idx(scene, meta):
    """The first constant emitter's row (meaningful where there is one)."""
    return torch.argmax((scene.emitters.type == E_CONSTANT).to(torch.int32))


def sample_direction(scene, meta, ref_p, u_sel, u2, active
                     ) -> Tuple[DirectionSample, torch.Tensor]:
    """Uniformly pick an emitter, sample a direction toward it.

    Returns (DirectionSample with pdf including the 1/E selection factor,
    weight = radiance / pdf). Occlusion is the integrator's shadow ray."""
    E = scene.emitters.type.shape[0]
    N = ref_p.shape[0]
    dev = ref_p.device
    if E == 0:
        zeros3 = torch.zeros((N, 3), device=dev)
        ds = DirectionSample(
            p=zeros3, n=zeros3, uv=torch.zeros((N, 2), device=dev),
            d=zeros3, dist=torch.zeros((N,), device=dev),
            pdf=torch.zeros((N,), device=dev),
            delta=torch.zeros((N,), dtype=torch.bool, device=dev),
            emitter_idx=torch.full((N,), -1, dtype=torch.int32, device=dev))
        return ds, zeros3

    e_idx = m.clip((u_sel * E).to(torch.int32), max=E - 1)
    el = e_idx.long()
    etype = scene.emitters.type[el]
    P = scene.emitters.params[el]

    p = torch.zeros((N, 3), device=dev)
    n = torch.zeros((N, 3), device=dev)
    pdf = torch.zeros((N,), device=dev)
    delta = torch.zeros((N,), dtype=torch.bool, device=dev)
    spec = torch.zeros((N, 3), device=dev)

    if E_AREA in meta.emitter_types:
        em = scene.emitters
        off = em.tri_offset[el]
        cnt = m.clip(em.tri_count[el], min=1)
        n_cdf = em.em_tri_cdf.shape[0]
        if E == 1:
            pos = m.clip(
                torch.searchsorted(em.em_tri_cdf, u2[:, 0].contiguous(),
                                   right=True),
                0, n_cdf - 1).to(torch.int32)
        else:
            pos = _segment_searchsorted(em.em_tri_cdf, off, cnt, u2[:, 0])
        # lanes of other emitters search past the table's end (the
        # reference relies on JAX clamping); they are masked out below
        pl = m.clip(pos.long(), 0, em.em_tri_cdf.shape[0] - 1)
        tri = em.em_tri_idx[pl].long()
        # remap u within the cdf cell for the barycentric sample
        cdf_hi = em.em_tri_cdf[pl]
        cdf_lo = torch.where(pos > off,
                             em.em_tri_cdf[m.clip(pl - 1, min=0)], 0.0)
        u0 = m.clip(m.safe_div(u2[:, 0] - cdf_lo, cdf_hi - cdf_lo),
                         0.0, m.OneMinusEpsilon)
        bary = warp.square_to_uniform_triangle(
            torch.stack([u0, u2[:, 1]], dim=-1))
        v0 = scene.geo.v0[tri]
        e1 = scene.geo.e1[tri]
        e2 = scene.geo.e2[tri]
        p_a = v0 + bary[:, 0:1] * e1 + bary[:, 1:2] * e2
        n_a = m.normalize(m.cross(e1, e2))
        d_a = p_a - ref_p
        dist2 = m.squared_norm(d_a)
        dist_a = m.safe_sqrt(dist2)
        d_a = d_a * m.safe_rcp(dist_a)[:, None]
        cos_l = -m.dot(d_a, n_a)
        area = m.clip(em.em_area[el], min=1e-20)
        pdf_a = m.safe_div(dist2, cos_l * area)
        ok = cos_l > 0
        pdf_a = torch.where(ok, pdf_a, 0.0)
        rad_a = torch.where(ok[:, None], P[:, 0:3], 0.0)
        sel = etype == E_AREA
        p = torch.where(sel[:, None], p_a, p)
        n = torch.where(sel[:, None], n_a, n)
        pdf = torch.where(sel, pdf_a, pdf)
        spec = torch.where(sel[:, None], rad_a, spec)

    if E_POINT in meta.emitter_types:
        pos_p = P[:, 0:3]
        d_p = pos_p - ref_p
        dist2 = m.squared_norm(d_p)
        inten = P[:, 3:6] * m.safe_rcp(dist2)[:, None]
        sel = etype == E_POINT
        p = torch.where(sel[:, None], pos_p, p)
        pdf = torch.where(sel, 1.0, pdf)
        delta = delta | sel
        spec = torch.where(sel[:, None], inten, spec)

    if E_SPOT in meta.emitter_types:
        pos_p = P[:, 0:3]
        dir_p = m.normalize(P[:, 3:6])
        d_p = pos_p - ref_p
        dist2 = m.squared_norm(d_p)
        cos_f = m.dot(m.normalize(-d_p), dir_p)     # emitter -> ref
        cos_cut, cos_beam = P[:, 9], P[:, 10]
        falloff = m.clip(m.safe_div(cos_f - cos_cut,
                                         cos_beam - cos_cut), 0.0, 1.0)
        inside = cos_f > cos_cut
        inten = P[:, 6:9] * (falloff * inside * m.safe_rcp(dist2))[:, None]
        sel = etype == E_SPOT
        p = torch.where(sel[:, None], pos_p, p)
        pdf = torch.where(sel, 1.0, pdf)
        delta = delta | sel
        spec = torch.where(sel[:, None], inten, spec)

    if E_CONSTANT in meta.emitter_types:
        d_c = warp.square_to_uniform_sphere(u2)
        r_world = 2.0 * scene.bsphere_r
        p_c = ref_p + d_c * r_world
        sel = etype == E_CONSTANT
        p = torch.where(sel[:, None], p_c, p)
        n = torch.where(sel[:, None], -d_c, n)
        pdf = torch.where(sel, warp.square_to_uniform_sphere_pdf(d_c), pdf)
        spec = torch.where(sel[:, None], P[:, 0:3], spec)

    if E_DIRECTIONAL in meta.emitter_types:
        dir_p = m.normalize(P[:, 0:3])
        p_d = ref_p - dir_p * (2.0 * scene.bsphere_r)
        sel = etype == E_DIRECTIONAL
        p = torch.where(sel[:, None], p_d, p)
        pdf = torch.where(sel, 1.0, pdf)
        delta = delta | sel
        spec = torch.where(sel[:, None], P[:, 3:6], spec)

    if E_PROJECTOR in meta.emitter_types:
        # a delta-position slide projector: the reference point in the
        # emitter's frame, the slide at its frustum uv, weighted by
        # pi / z^2 / cos(axis angle) so that a constant slide gives a
        # constant irradiance at z = 1
        pos_p = P[:, 0:3]
        rel = ref_p - pos_p
        local = _rotate(P[:, 17:26], rel)
        z = local[:, 2]
        uu = 0.5 * (1.0 - m.safe_div(m.safe_div(local[:, 0], z), P[:, 6]))
        vv = 0.5 * (1.0 - m.safe_div(m.safe_div(local[:, 1], z), P[:, 7]))
        inside = (z > 0) & (uu >= 0) & (uu <= 1) & (vv >= 0) & (vv <= 1)
        sel = etype == E_PROJECTOR
        slide = _slide(scene, P, sel & inside, uu, vv)
        cos_axis = m.safe_div(z, m.norm(rel))
        inten = slide * P[:, 3:6] * (m.Pi * m.safe_rcp(m.sqr(z))
                                     * m.safe_rcp(cos_axis)
                                     * inside)[:, None]
        p = torch.where(sel[:, None], pos_p, p)
        pdf = torch.where(sel, 1.0, pdf)
        delta = delta | sel
        spec = torch.where(sel[:, None], inten, spec)

    if E_ENVMAP in meta.emitter_types:
        _, d_w, pdf_e, spec_e = _env_sample(scene, u2)
        p_e = ref_p + d_w * (2.0 * scene.bsphere_r)
        sel = etype == E_ENVMAP
        p = torch.where(sel[:, None], p_e, p)
        n = torch.where(sel[:, None], -d_w, n)
        pdf = torch.where(sel, pdf_e, pdf)
        spec = torch.where(sel[:, None], spec_e, spec)

    d = p - ref_p
    dist = m.norm(d)
    d = d * m.safe_rcp(dist)[:, None]
    sel_pdf = pdf / E
    weight = torch.where((sel_pdf > 0)[:, None],
                         spec * m.safe_rcp(sel_pdf)[:, None], 0.0)
    weight = torch.where(active[:, None], weight, 0.0)
    ds = DirectionSample(p=p, n=n, uv=torch.zeros((N, 2), device=dev),
                         d=d, dist=dist,
                         pdf=torch.where(active, sel_pdf, 0.0), delta=delta,
                         emitter_idx=torch.where(active, e_idx, -1))
    return ds, weight


def pdf_direction(scene, meta, ref_p, si, active):
    """Solid-angle pdf of having sampled the hit point ``si`` on its
    emitter via sample_direction (for MIS), with the 1/E factor."""
    if scene.emitters.type.shape[0] == 0:
        return torch.zeros(ref_p.shape[:-1], device=ref_p.device)
    E = max(scene.emitters.type.shape[0], 1)
    has = active & (si.emitter_idx >= 0)
    e = m.clip(si.emitter_idx, min=0).long()
    etype = scene.emitters.type[e]
    area_e = scene.emitters.em_area[e]
    pdf = torch.zeros(ref_p.shape[:-1], device=ref_p.device)

    if E_AREA in meta.emitter_types:
        d = si.p - ref_p
        dist2 = m.squared_norm(d)
        dist = m.safe_sqrt(dist2)
        cos_l = torch.abs(m.dot(d * m.safe_rcp(dist)[..., None], si.n))
        area = m.clip(area_e, min=1e-20)
        pdf_a = m.safe_div(dist2, cos_l * area)
        pdf = torch.where(etype == E_AREA, pdf_a, pdf)

    if E_CONSTANT in meta.emitter_types:
        pdf = torch.where(etype == E_CONSTANT, m.InvFourPi, pdf)

    return torch.where(has, pdf / E, 0.0)


def pdf_env_direction(scene, meta, active, ray_d=None):
    """Solid-angle pdf for escaped rays hitting the environment (with a
    constant light present, the constant light's alone, as in the
    reference)."""
    E = max(scene.emitters.type.shape[0], 1)
    if E_CONSTANT in meta.emitter_types:
        return torch.where(active, m.InvFourPi / E, 0.0)
    if E_ENVMAP in meta.emitter_types and ray_d is not None:
        from ..core import distr2d
        d_local = _env_local(scene, ray_d)
        u, v = _env_uv_from_local(d_local)
        pdf_uv = distr2d.eval_hierarchical(scene.emitters.env_warp,
                                           torch.stack([u, v], dim=-1))
        pdf = _env_solid_angle_pdf(pdf_uv, d_local)
        return torch.where(active, pdf / E, 0.0)
    return torch.zeros(active.shape, device=active.device)


def sample_ray(scene, meta, u_sel, u_pos, u_dir, active
               ) -> Tuple[Ray, torch.Tensor, torch.Tensor, torch.Tensor]:
    """An emission ray for light tracing (photon and VRL shooting).

    Returns (ray, power weight, emitter_idx, normal at the origin). The
    weight is flux / pdf, so that the deposited energy sums to the
    emitters' power; it includes the 1/E emitter pick."""
    E = scene.emitters.type.shape[0]
    N = u_sel.shape[0]
    dev = u_sel.device
    e_idx = m.clip((u_sel * E).to(torch.int32), max=max(E - 1, 0))
    el = e_idx.long()
    etype = scene.emitters.type[el]
    P = scene.emitters.params[el]
    o = torch.zeros((N, 3), device=dev)
    d = torch.zeros((N, 3), device=dev)
    w = torch.zeros((N, 3), device=dev)
    n_o = torch.zeros((N, 3), device=dev)

    if E_AREA in meta.emitter_types:
        em = scene.emitters
        off = em.tri_offset[el]
        cnt = m.clip(em.tri_count[el], min=1)
        pos = _segment_searchsorted(em.em_tri_cdf, off, cnt, u_pos[:, 0])
        # lanes of other emitters search past the table's end (the
        # reference relies on JAX clamping); they are masked out below
        pl = m.clip(pos.long(), 0, em.em_tri_cdf.shape[0] - 1)
        tri = em.em_tri_idx[pl].long()
        cdf_hi = em.em_tri_cdf[pl]
        cdf_lo = torch.where(pos > off,
                             em.em_tri_cdf[m.clip(pl - 1, min=0)], 0.0)
        u0 = m.clip(m.safe_div(u_pos[:, 0] - cdf_lo, cdf_hi - cdf_lo),
                         0.0, m.OneMinusEpsilon)
        bary = warp.square_to_uniform_triangle(
            torch.stack([u0, u_pos[:, 1]], dim=-1))
        e1 = scene.geo.e1[tri]
        e2 = scene.geo.e2[tri]
        p_a = scene.geo.v0[tri] + bary[:, 0:1] * e1 + bary[:, 1:2] * e2
        n_a = m.normalize(m.cross(e1, e2))
        d_a = Frame.from_normal(n_a).to_world(
            warp.square_to_cosine_hemisphere(u_dir))
        area = m.clip(em.em_area[el], min=1e-20)
        # L * pi * area: the cosine-sampled direction cancels cos / pdf
        w_a = P[:, 0:3] * (m.Pi * area)[:, None]
        sel = (etype == E_AREA)[:, None]
        o = torch.where(sel, p_a, o)
        d = torch.where(sel, d_a, d)
        w = torch.where(sel, w_a, w)
        n_o = torch.where(sel, n_a, n_o)

    if E_POINT in meta.emitter_types:
        d_p = warp.square_to_uniform_sphere(u_dir)
        sel = (etype == E_POINT)[:, None]
        o = torch.where(sel, P[:, 0:3], o)
        d = torch.where(sel, d_p, d)
        w = torch.where(sel, P[:, 3:6] * (4.0 * m.Pi), w)
        n_o = torch.where(sel, d_p, n_o)

    if E_SPOT in meta.emitter_types:
        cos_cut = P[:, 9]
        local = warp.square_to_uniform_cone(u_dir, cos_cut)
        d_s = Frame.from_normal(m.normalize(P[:, 3:6])).to_world(local)
        falloff = m.clip(m.safe_div(local[:, 2] - cos_cut,
                                         P[:, 10] - cos_cut), 0.0, 1.0)
        inv_pdf = 2.0 * m.Pi * (1.0 - cos_cut)
        sel = (etype == E_SPOT)[:, None]
        o = torch.where(sel, P[:, 0:3], o)
        d = torch.where(sel, d_s, d)
        w = torch.where(sel, P[:, 6:9] * (falloff * inv_pdf)[:, None], w)
        n_o = torch.where(sel, d_s, n_o)

    if E_CONSTANT in meta.emitter_types:
        # origin uniform on the scene's bounding sphere, direction
        # cosine-sampled about the inward normal: L * 4 pi^2 R^2
        R = scene.bsphere_r
        v0 = warp.square_to_uniform_sphere(u_pos)
        v1 = warp.square_to_cosine_hemisphere(u_dir)
        o_c = scene.bsphere_c[None, :] + v0 * R
        d_c = Frame.from_normal(-v0).to_world(v1)
        w_c = P[:, 0:3] * (4.0 * m.sqr(m.Pi * R))
        sel = (etype == E_CONSTANT)[:, None]
        o = torch.where(sel, o_c, o)
        d = torch.where(sel, d_c, d)
        w = torch.where(sel, w_c, w)
        n_o = torch.where(sel, -v0, n_o)

    if E_DIRECTIONAL in meta.emitter_types:
        # origin on the disk across the beam on the bounding sphere, the
        # direction fixed: E * pi R^2
        R = scene.bsphere_r
        d_dir = m.normalize(P[:, 0:3])
        disk = warp.square_to_uniform_disk_concentric(u_pos) * R
        perp = Frame.from_normal(d_dir).to_world(torch.cat(
            [disk, torch.zeros((N, 1), device=dev)], dim=-1))
        o_d = scene.bsphere_c[None, :] + perp - d_dir * R
        sel = (etype == E_DIRECTIONAL)[:, None]
        o = torch.where(sel, o_d, o)
        d = torch.where(sel, d_dir, d)
        w = torch.where(sel, P[:, 3:6] * (m.Pi * R * R), w)
        n_o = torch.where(sel, d_dir, n_o)

    if E_PROJECTOR in meta.emitter_types:
        # through the frustum from the pinhole, uv uniform on the slide
        # (the reference's simplification: unbiased, not texel-weighted)
        uu, vv = u_dir[:, 0], u_dir[:, 1]
        dx = (1.0 - 2.0 * uu) * P[:, 6]
        dy = (1.0 - 2.0 * vv) * P[:, 7]
        d_local = m.normalize(torch.stack([dx, dy, torch.ones_like(dx)],
                                          -1))
        d_p = m.normalize(_rotate(P[:, 8:17], d_local))
        sel1 = etype == E_PROJECTOR
        w_p = _slide(scene, P, sel1, uu, vv) * P[:, 3:6]
        sel = sel1[:, None]
        o = torch.where(sel, P[:, 0:3], o)
        d = torch.where(sel, d_p, d)
        w = torch.where(sel, w_p, w)
        n_o = torch.where(sel, d_p, n_o)

    if E_ENVMAP in meta.emitter_types:
        # the direction toward the map by luminance; the photon starts on
        # the disk across it on the bounding sphere and flies inward
        _, d_w, pdf_dir, L_e = _env_sample(scene, u_dir)
        pdf_dir = m.clip(pdf_dir, min=1e-20)
        R = scene.bsphere_r
        disk = warp.square_to_uniform_disk_concentric(u_pos) * R
        o_e = scene.bsphere_c[None, :] + d_w * R \
            + Frame.from_normal(d_w).to_world(torch.cat(
                [disk, torch.zeros((N, 1), device=dev)], dim=-1))
        w_e = L_e * (m.Pi * R * R / pdf_dir)[:, None]
        sel = (etype == E_ENVMAP)[:, None]
        o = torch.where(sel, o_e, o)
        d = torch.where(sel, -d_w, d)
        w = torch.where(sel, w_e, w)
        n_o = torch.where(sel, -d_w, n_o)

    w = w * E
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
    d = m.normalize(torch.where(m.squared_norm(d, True) > 0, d, z_axis))
    ray = Ray.make(o, d)
    return ray, torch.where(active[:, None], w, 0.0), e_idx, n_o
