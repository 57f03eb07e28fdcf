"""Polarized BSDF layer: Mueller-matrix weights over the wavefront.

Port of ``mitsuba_nlvrl_tpu/bsdf/polarized.py``. The scalar dispatch of
``bsdf/__init__.py`` stays the source of directions, pdfs and unpolarized
magnitudes; this layer turns the returned weight into a world-frame
Mueller matrix ``(N, 3, 4, 4)`` whose (0, 0) entry is the unpolarized RGB
weight.

Polarization-aware types:
  * dielectric        -- specular reflection and transmission Mueller
  * conductor         -- complex-IOR specular reflection
  * roughconductor    -- the same about the microfacet normal
  * polarizer, retarder, circular -- optical elements with the axes of a
                        tilted element
  * pplastic          -- a two-lobe Mueller eval
  * measured_polarized -- the measured Mueller grid (bsdf/measured_pol.py)
Every other type depolarizes.

As in the reference, null and mask pass-through lanes keep their
polarization (the identity Mueller matrix) instead of depolarizing:
straight-through transmission does not depolarize, and polarized
null-walks stay meaningful. Twosided backface hits of aware types reuse
the mirrored local frame of the scalar dispatch.

Convention: a matrix maps Stokes vectors in ``stokes_basis(in_forward)``
to ``stokes_basis(out_forward)``, forward directions along the light's
propagation. In radiance transport light arrives along ``-wo`` and leaves
along ``+si.wi``.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core import frame as fr
from ..core import microfacet as mf
from ..core import mueller as mu
from ..core.fresnel import fresnel_conductor, fresnel_dielectric
from ..scene.types import BSDF_TYPES
from . import (RADIANCE, _blend_weight, _has_perturb, _maybe_flip,
               _perturb_si, _rows, eval as eval_unpol,
               sample as sample_unpol)

_AWARE_SCALAR = ('dielectric', 'polarizer', 'retarder', 'circular')
_AWARE_RGB = ('conductor', 'roughconductor')
_AWARE = _AWARE_SCALAR + _AWARE_RGB + ('pplastic', 'measured_polarized')


def has_polarized_types(meta) -> bool:
    """Whether the scene holds a polarization-aware BSDF."""
    return any(BSDF_TYPES[t] in meta.bsdf_types for t in _AWARE)


def _vec(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _ones(N, like):
    return torch.ones((N,), dtype=torch.float32, device=like.device)


def _safe_dir(v, fallback):
    """normalize(v), the fallback where v is (nearly) degenerate."""
    n = m.norm(v)
    safe = v / m.clip(n, min=1e-12)[..., None]
    return torch.where((n > 1e-6)[..., None], safe, fallback)


def _norm00(M):
    """M over its (0, 0) entry, so that the caller scales it by the RGB
    weight; degenerate matrices become the depolarizer."""
    m00 = M[..., 0:1, 0:1]
    ok = m00 > 1e-12
    Mn = torch.where(ok, M / torch.where(ok, m00, 1.0), 0.0)
    return torch.where(ok, Mn, mu.depolarizer(torch.ones(
        M.shape[:-2], dtype=torch.float32, device=M.device)))


def _rot_to_implicit(M, axis_n, wo_hat, wi_hat):
    """A Mueller matrix whose s axis is perpendicular to the plane of
    reflection about ``axis_n``, rotated into the implicit Stokes bases of
    -wo_hat and wi_hat."""
    in_fwd, out_fwd = -wo_hat, wi_hat
    in_basis = mu.stokes_basis(in_fwd)
    out_basis = mu.stokes_basis(out_fwd)
    s_in = _safe_dir(m.cross(axis_n, in_fwd), in_basis)
    s_out = _safe_dir(m.cross(axis_n, out_fwd), out_basis)
    return mu.rotate_mueller_basis(M, in_fwd, s_in, in_basis,
                                   out_fwd, s_out, out_basis)


def _element_mueller(P, btype, wi_loc, mode):
    """The straight-through Mueller matrix of polarizer, retarder and
    circular, normalised by its own (0, 0) entry."""
    N = wi_loc.shape[0]
    theta = P[:, 3]
    forward = wi_loc if mode == RADIANCE else -wi_loc
    is_pol = btype == BSDF_TYPES['polarizer']
    is_ret = btype == BSDF_TYPES['retarder']
    # the retarder's phase falls off with the cosine of incidence
    delta = P[:, 4] * torch.abs(fr.cos_theta(wi_loc))
    M_pol = mu.linear_polarizer(_ones(N, wi_loc))
    M_ret = mu.linear_retarder(delta)
    # circular: a linear polarizer, then a quarter-wave plate at +-45 deg;
    # slot 4 holds the handedness +1 (right) or -1 (left)
    qwp_rot = torch.where(P[:, 4] < 0, 3.0 * math.pi / 4.0, math.pi / 4.0)
    M_cir = mu.rotated_element(qwp_rot, mu.linear_retarder(
        torch.full((N,), 0.5 * math.pi, device=wi_loc.device))) @ M_pol
    M = torch.where(is_pol[:, None, None], M_pol,
                    torch.where(is_ret[:, None, None], M_ret, M_cir))
    M = mu.rotated_element(theta, M)
    # the effective axes of a tilted element (Korger et al. 2013)
    a_axis = _vec([0.0, 1.0, 0.0], wi_loc).expand(forward.shape)
    eff_a = _safe_dir(a_axis - m.dot(a_axis, forward)[:, None] * forward,
                      mu.stokes_basis(forward))
    eff_t = _safe_dir(m.cross(forward, eff_a), mu.stokes_basis(forward))
    M = mu.rotate_mueller_basis_collinear(M, forward, eff_t,
                                          mu.stokes_basis(forward))
    return _norm00(M)


def _pplastic_mueller_eval(P, wi_loc, wo_loc, mode):
    """The (N, 3, 4, 4) polarized pplastic eval: GGX specular reflection
    plus refract in, depolarizing subsurface, refract out."""
    cos_i, cos_o = fr.cos_theta(wi_loc), fr.cos_theta(wo_loc)
    act = (cos_i > 0) & (cos_o > 0)
    eta = P[:, 3] / P[:, 4]
    ax = ay = P[:, 9]
    wo_hat = wo_loc if mode == RADIANCE else wi_loc
    wi_hat = wi_loc if mode == RADIANCE else wo_loc
    N = wi_loc.shape[0]
    # --- specular lobe ---------------------------------------------------
    H = _safe_dir(wi_loc + wo_loc, _vec([0.0, 0.0, 1.0], wi_loc))
    D = mf.ggx_d(H, ax, ay)
    G = mf.smith_g1(wi_loc, H, ax, ay) * mf.smith_g1(wo_loc, H, ax, ay)
    F = mu.specular_reflection(m.dot(wo_hat, H), eta)
    F = _rot_to_implicit(F, H, wo_hat, wi_hat)
    val_spec = D * G / (4.0 * m.clip(cos_i, min=1e-9))
    spec = (P[:, 6:9] * val_spec[:, None])[:, :, None, None] \
        * F[:, None, :, :]
    # --- diffuse lobe ----------------------------------------------------
    To = mu.specular_transmission(torch.abs(fr.cos_theta(wo_hat)), eta)
    diff0 = mu.depolarizer(_ones(N, wi_loc))
    # refract wi_hat inside; Ti transmits back out (eta reversed). In the
    # local frame |cos_theta(refract(wi))| is |cos_theta_t|
    n_loc = _vec([0.0, 0.0, 1.0], wi_loc).expand(wi_loc.shape)
    _, cos_t_i, _, _ = fresnel_dielectric(cos_i, eta)
    Ti = mu.specular_transmission(torch.abs(cos_t_i), 1.0 / eta)
    Mdiff = Ti @ diff0 @ To
    Mdiff = _rot_to_implicit(Mdiff, n_loc, wo_hat, wi_hat)
    diff = (P[:, 0:3] * (m.InvPi * cos_o)[:, None])[:, :, None, None] \
        * Mdiff[:, None, :, :]
    out = spec + diff
    return torch.where(act[:, None, None, None], out, 0.0)


def _to_world_mueller(si, M, in_fwd_local, out_fwd_local):
    """A local-frame Mueller matrix (N, C, 4, 4) in the implicit
    world-frame Stokes bases (the rotations do not depend on C)."""
    f = si.sh_frame
    in_w = f.to_world(in_fwd_local)
    out_w = f.to_world(out_fwd_local)
    R_in = mu.rotate_stokes_basis(
        in_w, f.to_world(mu.stokes_basis(in_fwd_local)),
        mu.stokes_basis(in_w))
    R_out = mu.rotate_stokes_basis(
        out_w, f.to_world(mu.stokes_basis(out_fwd_local)),
        mu.stokes_basis(out_w))
    return R_out[:, None] @ M @ R_in.transpose(-1, -2)[:, None]


def _polarize_weight(scene, meta, si, wo_loc, w_unpol, mode,
                     null_lane=None, pdf_val=None):
    """An unpolarized RGB weight as an (N, 3, 4, 4) world Mueller
    matrix."""
    types = meta.bsdf_types
    btype, flags, P = _rows(scene, si)
    wi_loc, wo_l = _maybe_flip(flags, si.wi, wo_loc)
    N = wi_loc.shape[0]
    wo_hat = wo_l if mode == RADIANCE else wi_loc
    wi_hat = wi_loc if mode == RADIANCE else wo_l
    n_loc = _vec([0.0, 0.0, 1.0], wi_loc).expand(wi_loc.shape)

    # default: the depolarizer (the same for every channel)
    Mhat = mu.depolarizer(_ones(N, wi_loc))[:, None].expand(N, 3, 4, 4)
    if null_lane is not None:
        # pass-through lanes keep their polarization (module docstring)
        eye = torch.eye(4, device=wi_loc.device).expand(N, 3, 4, 4)
        Mhat = torch.where(null_lane[:, None, None, None], eye, Mhat)

    def put(sel, Mtype):
        nonlocal Mhat
        if Mtype.dim() == 3:
            Mtype = Mtype[:, None].expand(N, 3, 4, 4)
        Mhat = torch.where(sel[:, None, None, None], Mtype, Mhat)

    if BSDF_TYPES['dielectric'] in types:
        eta = P[:, 0] / P[:, 1]
        coh = fr.cos_theta(wo_hat)
        transmitted = fr.cos_theta(wi_loc) * fr.cos_theta(wo_l) < 0
        R = _norm00(mu.specular_reflection(coh, eta))
        T = _norm00(mu.specular_transmission(coh, eta))
        Md = torch.where(transmitted[:, None, None], T, R)
        put(btype == BSDF_TYPES['dielectric'],
            _rot_to_implicit(Md, n_loc, wo_hat, wi_hat))
    if BSDF_TYPES['conductor'] in types:
        Mc = _norm00(mu.specular_reflection_conductor(
            fr.cos_theta(wo_hat), P[:, 0:3], P[:, 3:6]))  # (N, 3, 4, 4)
        put(btype == BSDF_TYPES['conductor'],
            _rot_to_implicit(Mc, n_loc[:, None], wo_hat[:, None],
                             wi_hat[:, None]))
    if BSDF_TYPES['roughconductor'] in types:
        H = _safe_dir(wi_loc + wo_l, n_loc)
        Mr = _norm00(mu.specular_reflection_conductor(
            m.dot(wo_hat, H), P[:, 0:3], P[:, 3:6]))
        put(btype == BSDF_TYPES['roughconductor'],
            _rot_to_implicit(Mr, H[:, None], wo_hat[:, None],
                             wi_hat[:, None]))
    el_codes = [BSDF_TYPES[t] for t in ('polarizer', 'retarder', 'circular')
                if BSDF_TYPES[t] in types]
    if el_codes:
        sel = torch.zeros((N,), dtype=torch.bool, device=wi_loc.device)
        for c in el_codes:
            sel = sel | (btype == c)
        put(sel, _element_mueller(P, btype, wi_loc, mode))

    weight = w_unpol[:, :, None, None] * Mhat

    if BSDF_TYPES['pplastic'] in types:
        # the two-lobe Mueller eval, over the pdf for a sampling weight
        Mpp = _pplastic_mueller_eval(P, wi_loc, wo_l, mode)
        if pdf_val is not None:
            Mpp = Mpp * m.safe_rcp(pdf_val)[:, None, None, None]
        weight = torch.where((btype == BSDF_TYPES['pplastic'])
                             [:, None, None, None], Mpp, weight)

    if BSDF_TYPES['measured_polarized'] in types:
        # the measured Mueller eval, over the pdf for a sampling weight
        from . import measured_pol as mp_mod
        slot = P[:, 0].to(torch.int64)
        for k, data in enumerate(scene.measured_pol):
            Mk = mp_mod.eval_mueller_world_local(data, P, wi_loc, wo_l,
                                                 mode == RADIANCE)
            if pdf_val is not None:
                Mk = Mk * m.safe_rcp(pdf_val)[:, None, None, None]
            sel = (btype == BSDF_TYPES['measured_polarized']) & (slot == k)
            weight = torch.where(sel[:, None, None, None], Mk, weight)

    return _to_world_mueller(si, weight, -wo_hat, wi_hat)


def _conductor_row_terms(scene, si, wo_loc, lam, mode, btype, flags, P):
    """(use, F_lam, upsampled F_rgb, world Mueller structure) of one row
    assignment's conductor lanes, from one curve gather."""
    from ..core import spectral as sp
    wi_loc, wo_l = _maybe_flip(flags, si.wi, wo_loc)
    wo_hat = wo_l if mode == RADIANCE else wi_loc
    wi_hat = wi_loc if mode == RADIANCE else wo_l
    n_loc = _vec([0.0, 0.0, 1.0], wi_loc).expand(wi_loc.shape)
    is_rough = btype == BSDF_TYPES['roughconductor']
    is_cond = (btype == BSDF_TYPES['conductor']) | is_rough
    sid = P[:, 13].to(torch.int32) - 1
    use = is_cond & (sid >= 0)

    H = _safe_dir(wi_loc + wo_l, n_loc)
    axis = torch.where(is_rough[:, None], H, n_loc)
    # for a smooth (delta) conductor this cosine means something only
    # where wo is the mirror direction; NEE lanes elsewhere are zeroed by
    # the delta lobe's eval m00 == 0
    cosm = torch.where(is_rough, m.dot(wo_hat, H), fr.cos_theta(wo_hat))

    curves = scene.conductor_spd[m.clip(sid, min=0).long()]
    eta_l = sp.cie_table_eval(curves[:, 0, :], lam)       # (N, L)
    k_l = sp.cie_table_eval(curves[:, 1, :], lam)

    # the magnitude ratio's terms (half-vector cosine, abs)
    h_r = m.normalize(wi_loc + wo_l)
    cos_h = torch.abs(m.dot(wi_loc, h_r))
    F_l = fresnel_conductor(cos_h, eta_l, k_l)                # (N, L)
    F_rgb = fresnel_conductor(cos_h, P[:, 0:3], P[:, 3:6])    # (N, 3)
    F_up = sp.upsample_weight(F_rgb, lam)                     # (N, L)

    # the normalised per-wavelength Mueller structure
    Mc = _norm00(mu.specular_reflection_conductor(cosm, eta_l, k_l))
    Mc = _rot_to_implicit(Mc, axis[:, None], wo_hat[:, None],
                          wi_hat[:, None])
    Mw = _to_world_mueller(si, Mc, -wo_hat, wi_hat)
    return use, F_l, F_up, Mw


def spectral_conductor_terms(scene, meta, si, wo_loc, lam, mode=RADIANCE,
                             null_lane=None):
    """The per-hero-wavelength conductor terms of the spectral polarized
    integrator, from one complex-IOR curve gather: the magnitude ratio
    ``(N, L)`` (as ``bsdf.spectral_fresnel_ratio``) and the normalised
    Mueller structure ``(use (N,), Mw (N, L, 4, 4))``. Normalmap and
    bumpmap rows are resolved first; a blendbsdf lane mixes its two
    children's per-wavelength terms by the blend weight times each
    child's upsampled RGB eval. Returns None without tabulated curves."""
    if not getattr(meta, 'has_conductor_spd', False):
        return None
    types = meta.bsdf_types
    if (BSDF_TYPES['conductor'] not in types
            and BSDF_TYPES['roughconductor'] not in types):
        return None
    from ..core import spectral as sp
    if _has_perturb(meta):
        f0 = si.sh_frame
        si = _perturb_si(scene, meta, si)
        wo_loc = si.sh_frame.to_local(f0.to_world(wo_loc))
    btype, flags, P = _rows(scene, si)
    use, F_l, F_up, Mw = _conductor_row_terms(scene, si, wo_loc, lam, mode,
                                              btype, flags, P)
    ratio = torch.where(use[:, None] & (F_up > 1e-6),
                        F_l / m.clip(F_up, min=1e-6), 1.0)

    blend = BSDF_TYPES['blendbsdf']
    if blend in types:
        from . import eval as bsdf_eval
        is_b = btype == blend
        last = scene.bsdfs.type.shape[0] - 1
        ca = m.clip(P[:, 0].to(torch.int32), 0, last)
        cb = m.clip(P[:, 1].to(torch.int32), 0, last)
        si_a = si._replace(bsdf_idx=ca)
        si_b = si._replace(bsdf_idx=cb)
        bta, fla, Pa = _rows(scene, si_a)
        btb, flb, Pb = _rows(scene, si_b)
        ua, Fla, Fua, Ma = _conductor_row_terms(scene, si, wo_loc, lam,
                                                mode, bta, fla, Pa)
        ub, Flb, Fub, Mb = _conductor_row_terms(scene, si, wo_loc, lam,
                                                mode, btb, flb, Pb)
        wgt = _blend_weight(scene, meta, si, P)
        sh_a, sh_b = (1.0 - wgt), wgt
        # the children's RGB evals weight the ratio and the structure mix;
        # upsample_weight is not linear, so the denominator upsamples the
        # actual blend
        fa = bsdf_eval(scene, meta, si_a, wo_loc, mode, None, 1) \
            * sh_a[:, None]
        fb = bsdf_eval(scene, meta, si_b, wo_loc, mode, None, 1) \
            * sh_b[:, None]
        up_a = sp.upsample_weight(fa, lam)                    # (N, L)
        up_b = sp.upsample_weight(fb, lam)
        up_blend = sp.upsample_weight(fa + fb, lam)
        r_a = torch.where(ua[:, None] & (Fua > 1e-6),
                          Fla / m.clip(Fua, min=1e-6), 1.0)
        r_b = torch.where(ub[:, None] & (Fub > 1e-6),
                          Flb / m.clip(Fub, min=1e-6), 1.0)
        # a smooth (delta) conductor child evaluates to 0; on the lanes
        # that consume its structure (the sampled mirror direction) its
        # magnitude is share x the per-wavelength Fresnel. The sample
        # path emits wo == (-wi.x, -wi.y, wi.z) exactly, so alignment
        # picks those lanes out; NEE directions hit it with probability 0
        mir = torch.stack([-si.wi[:, 0], -si.wi[:, 1], si.wi[:, 2]], -1)
        mirror_lane = m.dot(wo_loc, mir) > 1.0 - 1e-5
        da = ua & (bta == BSDF_TYPES['conductor']) & mirror_lane
        db = ub & (btb == BSDF_TYPES['conductor']) & mirror_lane
        mag_a = up_a * r_a + torch.where(da[:, None],
                                         sh_a[:, None] * Fla, 0.0)
        mag_b = up_b * r_b + torch.where(db[:, None],
                                         sh_b[:, None] * Flb, 0.0)
        den = up_blend \
            + torch.where(da[:, None], sh_a[:, None] * Fua, 0.0) \
            + torch.where(db[:, None], sh_b[:, None] * Fub, 0.0)
        ratio_bl = torch.where(den > 1e-9,
                               (mag_a + mag_b) / m.clip(den, min=1e-9),
                               1.0)
        any_cond = is_b & (ua | ub)
        ratio = torch.where(any_cond[:, None], ratio_bl, ratio)
        # the Mueller mix: per-wavelength child magnitudes times child
        # structure; children that are not conductors depolarize
        dep = mu.depolarizer(_ones(up_a.shape[0], up_a))[:, None] \
            .expand(Mw.shape)
        Ma = torch.where(ua[:, None, None, None], Ma, dep)
        Mb = torch.where(ub[:, None, None, None], Mb, dep)
        Mmix = _norm00(mag_a[..., None, None] * Ma
                       + mag_b[..., None, None] * Mb)
        Mw = torch.where(any_cond[:, None, None, None], Mmix, Mw)
        use = use | any_cond

    use_struct = use if null_lane is None else use & ~null_lane
    return ratio, use_struct, Mw


def spectral_conductor_structure(scene, meta, si, wo_loc, lam, mode=RADIANCE,
                                 null_lane=None):
    """The per-hero-wavelength conductor Mueller structure (normalised,
    m00 == 1) in world Stokes bases: ``spectral_conductor_terms`` without
    the ratio. Returns (use, Mw) or None."""
    out = spectral_conductor_terms(scene, meta, si, wo_loc, lam, mode,
                                   null_lane)
    if out is None:
        return None
    _, use, Mw = out
    return use, Mw


def eval_pol(scene, meta, si, wo_loc, mode=RADIANCE):
    """The polarized f(wi, wo) cos: an (N, 3, 4, 4) world-frame Mueller
    matrix whose (0, 0) entries are ``bsdf.eval``'s."""
    f = eval_unpol(scene, meta, si, wo_loc, mode)
    return _polarize_weight(scene, meta, si, wo_loc, f, mode)


def sample_pol(scene, meta, si, u1, u2, mode=RADIANCE):
    """Polarized BSDF sampling: (record, weight Mueller (N, 3, 4, 4))."""
    bs, w = sample_unpol(scene, meta, si, u1, u2, mode)
    M = _polarize_weight(scene, meta, si, bs.wo, w, mode,
                         null_lane=bs.null, pdf_val=bs.pdf)
    return bs, M
