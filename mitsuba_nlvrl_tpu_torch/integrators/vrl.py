"""VRL integrator: Non-Linear Virtual Ray Lights.

Port of ``mitsuba_nlvrl_tpu/integrators/vrl.py``:

  * preprocess: wavefront photon and VRL shooting (``lighttrace.py``),
    thinning to the map budgets, hash grids and the VRL clusters;
  * camera pass: a bounce loop; inside (optically homogeneous or
    nonlinear) media the camera ray bends into a piecewise-linear
    ``BentRay``, volume photons are gathered at points spaced 2 * radius
    along it for direct light, and VRLs are queried per segment for
    indirect light;
  * VRL evaluation: Kulla and Fajardo inverse-CDF sampling in asinh space
    on the VRL and atan space on the camera segment, both phase functions
    and sigma_s, three transmittances with an occlusion walk;
  * VRL selection: a two-level Morton cluster hierarchy (coarse cluster,
    subcluster, member), the wavefront form of the reference's lightcut
    (``VRLClusters``), uniform selection, or (``vrl_ris``, alias
    ``rr_vrl``) resampled importance over every VRL in 512-VRL chunks;
  * the thesis's options: ``long_vrl`` extends each VRL to the first
    surface along it, ``dice_vrl`` > 1 cuts VRLs into sub-VRLs of a
    common length, ``vrl_aniso_cdf`` samples the camera segment from a
    tabulated CDF of both phase functions, and ``use_bre`` replaces the
    volume gather by the beam radiance estimate.

The reference's ``lax`` loops become host loops: the camera bounces and
the VRL query over the live segment count read the device once a trip
(``core/sync.py``); the volume gather and the beam estimate run the trips
some lane needs (one read), and in a scene with a heterogeneous medium
advance the sampler past the skipped trips' draws, so every later draw
keeps its dimension. ``map_psum_axis`` names a mesh axis over which
every map estimate is all-reduced (``_map_psum``): the camera pass of
maps sharded over ranks (``parallel/sharded_maps.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import rng
from ..core.ray import Ray
from ..core.rng import Sampler
from ..core.sync import any_on_host, int_on_host
from ..parallel import collectives
from .. import bsdf as bsdf_mod
from .. import emitter as emitter_mod
from .. import medium as medium_mod
from .. import phase as phase_mod
from ..medium import nonlinear as nl_mod
from ..ops import intersect as isect
from ..scene.types import F_SMOOTH, M_PHASE_G, MEDIUM_TYPES
from . import lighttrace
from . import photon_est
from .common import initial_active
from .volpath import _where_tree, transmittance_to_point

# luminance weights of the cluster flux
_LUM = (0.2126, 0.7152, 0.0722)


def scene_radius_of(scene):
    """The reference's radius convention: |bbox centre - bbox max|, a
    0-d tensor on the scene's device."""
    return m.norm(scene.bbox_hi - 0.5 * (scene.bbox_lo + scene.bbox_hi))


def _radii(scene, meta):
    sr = scene_radius_of(scene)
    return (meta.iprop('global_lookup_radius_relative', 0.05) * sr,
            meta.iprop('caustic_lookup_radius_relative', 0.0125) * sr,
            meta.iprop('volume_lookup_radius_relative', 0.005) * sr)


def preprocess(scene, meta, key, vp_all_scatters: bool = False):
    """Shoot light paths and build the photon and VRL maps."""
    target_vrls = int(meta.iprop('target_vrls', 1000))
    target_vp = int(meta.iprop('volume_photons', 1000))
    # the wavefront is sized from the map the scene uses (at most 64k
    # paths a shot: the scale factors keep the estimates unbiased)
    want = max(target_vrls, target_vp // 8 if vp_all_scatters else 0, 1024)
    n_paths = min(1 << (max(want - 1, 1)).bit_length(), 65536)
    # light-path depth: paths alive at the cap are counted
    # (maps.trunc_paths), not dropped silently
    max_depth = min(int(meta.iprop('max_depth', 512)),
                    int(meta.iprop('light_depth_cap', 64)))
    rr_depth = int(meta.iprop('rr_depth', 5))
    min_vrl = float(meta.iprop('min_vrl_length', 5.0))
    has_nl = MEDIUM_TYPES['nonlinear'] in meta.medium_types \
        and bool(meta.iprop('use_non_linear', True))
    max_bends = int(meta.iprop('max_nl_bends', 32)) if has_nl else 0

    photon_cap = max(int(meta.iprop('global_photons', 250000)), target_vp)
    vrl_budget = max(target_vrls, 8)

    # headroom-sized reservoirs, thinned to the budgets afterwards
    def head(cap):
        return min(4 * cap, max(cap, n_paths * (max_depth + 2)))
    raw = lighttrace.shoot(
        scene, meta, key, n_paths=n_paths, max_depth=max_depth,
        rr_depth=rr_depth, max_bends=max_bends, min_vrl_len=min_vrl,
        vp_all_scatters=vp_all_scatters, sp_cap=head(photon_cap),
        vp_cap=head(photon_cap), vrl_cap=head(vrl_budget))
    raw = lighttrace.thin_raw(rng.fold_in(key, 0x7411), raw,
                              sp_cap=photon_cap, vp_cap=photon_cap,
                              vrl_cap=vrl_budget)
    r_global, r_caustic, r_volume = _radii(scene, meta)
    # the volume grid's cell covers the jittered query radius (1.25 r)
    maps = lighttrace.build_maps(scene, meta, raw, r_global, r_caustic,
                                 1.25 * r_volume)
    if bool(meta.iprop('long_vrl', False)):
        maps = _lengthen_vrls(scene, maps)
    dice = int(meta.iprop('dice_vrl', 1))
    if dice > 1:
        maps = _dice_vrls(scene, meta, rng.fold_in(key, 0xd1ce), maps, dice)
    if bool(meta.iprop('use_light_cut', True)):
        n_cl = int(meta.iprop('vrl_clusters', 1024))
        maps = maps._replace(clusters=build_vrl_clusters(scene, maps, n_cl))
    return maps


def _repack_vrls(maps):
    """The maps with ``vrl_packed`` rebuilt from the VRL fields. (The
    reference leaves its packed rows as the light pass wrote them, so its
    camera pass reads the lengths before ``long_vrl`` and, after
    ``dice_vrl``, the undiced rows at clamped indices; ROADMAP queue C.)"""
    return maps._replace(vrl_packed=lighttrace.pack_vrls(
        maps.vrl_o, maps.vrl_d, maps.vrl_len, maps.vrl_flux, maps.vrl_medium,
        maps.vrl_valid))


def _lengthen_vrls(scene, maps):
    """long_vrl: extend every VRL to the first surface along its ray. The
    estimator integrates Tr from the VRL's origin, so only the length
    changes."""
    ray = Ray.make(maps.vrl_o + maps.vrl_d * 1e-4, maps.vrl_d)
    si = isect.ray_intersect(scene, ray)
    new_len = torch.where(si.valid & maps.vrl_valid, si.t + 1e-4,
                          maps.vrl_len)
    return _repack_vrls(maps._replace(vrl_len=new_len))


def _dice_vrls(scene, meta, key, maps, dice: int):
    """dice_vrl > 1: cut every VRL into sub-VRLs of the common length
    mean_len / dice, each sub-VRL's flux carrying Tr(origin -> its start)
    so the energy stays exact. As in the reference, a VRL has a static
    budget of 2 * dice slots (tails beyond twice the mean length are cut)
    and the diced map is compacted again on the device."""
    V = maps.vrl_len.shape[0]
    K = 2 * dice
    dev = maps.vrl_len.device
    nvalid = m.clip(maps.vrl_count.to(torch.float32), min=1.0)
    avg = torch.where(maps.vrl_valid, maps.vrl_len, 0.0).sum() / nvalid
    chunk = m.clip(avg / dice, min=1e-4)
    start = chunk * torch.arange(K, dtype=torch.float32, device=dev)  # (K,)
    sub_len = torch.minimum(m.clip(maps.vrl_len[:, None]
                                        - start[None, :], min=0.0), chunk)
    valid = (maps.vrl_valid[:, None] & (sub_len > 1e-5)).reshape(V * K)

    def rep(a):
        return a.repeat_interleave(K, dim=0)
    med = rep(maps.vrl_medium)
    start_f = start[None, :].expand(V, K).reshape(V * K)
    # Tr(VRL origin -> sub-VRL start), absorbed into the sub-VRL's flux
    # (stochastic for heterogeneous media: the flux is linear in it)
    tr, _ = medium_mod.segment_tr(
        scene, meta, Sampler.make(key, V * K, dev), rep(maps.vrl_o),
        rep(maps.vrl_d), start_f, med,
        torch.zeros((V * K,), dtype=torch.int32, device=dev), valid)
    o = (maps.vrl_o[:, None, :]
         + maps.vrl_d[:, None, :] * start[None, :, None]).reshape(V * K, 3)
    n, vmask, (o, d, ln, flux, med, dep, direct) = lighttrace._compact_dev(
        valid, [o, rep(maps.vrl_d), sub_len.reshape(V * K),
                rep(maps.vrl_flux) * tr, med, rep(maps.vrl_depth),
                rep(maps.vrl_direct)], V * K)
    return _repack_vrls(maps._replace(
        vrl_o=o, vrl_d=d, vrl_len=ln, vrl_flux=flux, vrl_medium=med,
        vrl_depth=dep, vrl_direct=direct, vrl_valid=vmask,
        vrl_count=n.to(maps.vrl_count.dtype)))


ANISO_CDF_KNOTS = 10     # cosine-spaced knots of the tabulated CDF
# peak knots at the VRL phase's maximum, in HG half-widths
_ANISO_PEAK_OFFSETS = (-4.0, -1.0, 0.0, 1.0, 4.0)


def _aniso_cam_cdf(scene, meta, cam_medium, med_v, seg_o, seg_d, seg_len,
                   p_vrl, d_v, u2, act):
    """Tabulated-CDF sampling of the camera-segment point: knots in
    Kulla's theta space (10 cosine-spaced, five more around the VRL
    phase's peak), the density at each the product of both phase
    functions, blended half and half with the constant density of the
    atan sampler, and the piecewise-linear CDF inverted exactly. As the
    reference documents, this departs from the C++ original, which
    renormalises u uniformly inside the bin but divides by the lerped
    density. Returns (t_cam, inv_pdf_c, ok)."""
    N = seg_o.shape[0]
    dev = seg_o.device
    u_hat = m.dot(seg_d, p_vrl - seg_o)
    u0_hat = -u_hat
    u1_hat = seg_len + u0_hat
    foot = seg_o + seg_d * u_hat[:, None]
    h = m.clip(m.norm(foot - p_vrl), min=1e-7)
    th0 = torch.atan(u0_hat / h)
    th1 = torch.atan(u1_hat / h)
    K = ANISO_CDF_KNOTS
    frac = 0.5 * (1.0 - torch.cos(
        m.Pi * torch.arange(K, dtype=torch.float32, device=dev) / (K - 1)))
    th = th0[:, None] + (th1 - th0)[:, None] * frac[None, :]    # (N, K)
    # peak knots: the VRL phase peaks where the segment-to-VRL direction
    # -sin(theta) seg_d + cos(theta) n_hat is closest to -d_v
    g_v = scene.media.params[m.clip(med_v, min=0).long(), M_PHASE_G]
    nhat = (p_vrl - foot) * m.safe_rcp(h)[:, None]
    A = m.dot(seg_d, d_v)
    B = m.dot(nhat, d_v)
    th_p = torch.atan2(B, A) + 0.5 * m.Pi
    th_p = torch.where(th_p > 0.5 * m.Pi, th_p - m.Pi, th_p)
    # the HG half-width in scattering angle, about sqrt(1 - |g|)
    delta = m.clip(m.sqrt(m.clip(1.0 - torch.abs(g_v),
                                               min=1e-4)) * 0.2, 0.01, 0.3)
    offs = torch.tensor(_ANISO_PEAK_OFFSETS, device=dev)
    th_pk = torch.minimum(torch.maximum(
        th_p[:, None] + delta[:, None] * offs[None, :], th0[:, None]),
        th1[:, None])
    th = torch.sort(torch.cat([th, th_pk], dim=1), dim=1).values
    K = K + offs.shape[0]
    t_k = h[:, None] * torch.tan(th) - u0_hat[:, None]          # (N, K)
    p_k = seg_o[:, None, :] + seg_d[:, None, :] * t_k[..., None]
    dir_k = p_vrl[:, None, :] - p_k
    dir_k = dir_k * m.safe_rcp(m.norm(dir_k))[..., None]        # (N, K, 3)

    def rep(x):
        return x.repeat_interleave(K, dim=0)
    dflat = dir_k.reshape(N * K, 3)
    ph_ray = phase_mod.eval(scene, meta, rep(cam_medium), rep(-seg_d),
                            dflat, rep(act)).reshape(N, K)
    ph_vrl = phase_mod.eval(scene, meta, rep(med_v), rep(-d_v), -dflat,
                            rep(act)).reshape(N, K)
    ph = m.clip(ph_ray * ph_vrl, min=0.0)
    dth = th[:, 1:] - th[:, :-1]                                # (N, K-1)
    total = (0.5 * (ph[:, 1:] + ph[:, :-1]) * dth).sum(dim=1)
    ok = act & (total > 1e-12) & torch.isfinite(total)
    # blend with the atan sampler's constant density: the pdf stays at
    # least half the atan sampler's, and a constant density reduces to it
    beta = 0.5
    span = m.clip(th1 - th0, min=1e-9)
    phi = (1.0 - beta) * ph * m.safe_rcp(total)[:, None] \
        + (beta * m.safe_rcp(span))[:, None]                    # (N, K)
    area = 0.5 * (phi[:, 1:] + phi[:, :-1]) * dth               # sums to 1
    cdf = torch.cumsum(area, dim=1)
    uu = m.clip(u2, 0.0, m.OneMinusEpsilon) * cdf[:, -1]
    j = m.clip((cdf < uu[:, None]).sum(dim=1), max=K - 2)[:, None]
    cdf0 = torch.cat([torch.zeros((N, 1), device=dev), cdf], dim=1)

    def at(x):
        return x.gather(1, j)[:, 0]
    pa = at(phi[:, :-1])
    pb = at(phi[:, 1:])
    xi = m.clip((uu - at(cdf0)) * m.safe_rcp(at(area)), 0.0, 1.0)
    # exact inversion of the linear density pa -> pb over the bin
    dp = pb - pa
    lin = torch.abs(dp) > 1e-9 * torch.maximum(pa, pb)
    s = torch.where(lin, (m.safe_sqrt(pa * pa + xi * (pb * pb - pa * pa))
                          - pa) * m.safe_rcp(dp), xi)
    theta = at(th[:, :-1]) + at(dth) * s
    q = pa + dp * s              # the blended density at the sample
    tc = h * torch.tan(theta)
    inv_pdf_c = (h * h + tc * tc) * m.safe_rcp(h * q)
    t_cam = torch.minimum(m.clip(tc - u0_hat, min=0.0), seg_len)
    ok = ok & torch.isfinite(inv_pdf_c) & (inv_pdf_c > 0)
    return t_cam, inv_pdf_c, ok


def vrl_contrib(scene, meta, maps, seg_o, seg_d, seg_len, cam_medium,
                vi, u1, u2, channel, sampler, active):
    """One VRL's contribution to each camera segment. Returns (spectrum,
    sampler)."""
    N = seg_o.shape[0]
    dev = seg_o.device
    row = maps.vrl_packed[vi.long()]
    o_v, d_v = row[:, 0:3], row[:, 3:6]
    len_v, flux = row[:, 6], row[:, 7:10]
    med_v = row[:, 10].to(torch.int32)
    act = active & (row[:, 11] > 0.5) & (len_v > 0) & (seg_len > 0)

    # --- the closest points of the two segments ---------------------------
    w0 = seg_o - o_v
    b = m.dot(seg_d, d_v)
    d_ = m.dot(seg_d, w0)
    e = m.dot(d_v, w0)
    denom = 1.0 - b * b
    s_c = torch.where(torch.abs(denom) > 1e-9, m.safe_div(b * e - d_, denom),
                      0.0)
    s_c = torch.minimum(m.clip(s_c, min=0.0), seg_len)
    t_v = torch.minimum(m.clip(e + b * s_c, min=0.0), len_v)
    s_c = torch.minimum(m.clip(-d_ + b * t_v, min=0.0), seg_len)

    h = m.norm((seg_o + seg_d * s_c[:, None]) - (o_v + d_v * t_v[:, None]))
    sin_theta = m.norm(m.cross(d_v, seg_d))
    degenerate = (h < 1e-7) | (sin_theta < 1e-6)

    # --- Kulla inverse CDF on the VRL (asinh space) -----------------------
    v0_hat = -t_v
    v1_hat = len_v + v0_hat
    s_safe = m.clip(sin_theta, min=1e-6)
    h_safe = m.clip(h, min=1e-7)

    def asinh(x):
        return torch.log(x + m.safe_sqrt(x * x + 1.0))

    a0 = asinh(v0_hat / h_safe * s_safe)
    a1 = asinh(v1_hat / h_safe * s_safe)
    v = h_safe * torch.sinh(m.lerp(a0, a1, u1)) / s_safe
    inv_pdf_v = (a1 - a0) * m.safe_sqrt(h_safe * h_safe
                                        + v * v * s_safe * s_safe) / s_safe
    t_vrl = torch.minimum(m.clip(v + t_v, min=0.0), len_v)
    p_vrl = o_v + d_v * t_vrl[:, None]

    # --- the camera segment (atan space) ----------------------------------
    u_hat = m.dot(seg_d, p_vrl - seg_o)
    u0_hat = -u_hat
    u1_hat = seg_len + u0_hat
    h_pt = m.clip(m.norm(seg_o + seg_d * u_hat[:, None] - p_vrl),
                       min=1e-7)
    th_a = torch.atan(u0_hat / h_pt)
    th_b = torch.atan(u1_hat / h_pt)
    uu = h_pt * torch.tan(m.lerp(th_a, th_b, u2))
    inv_pdf_c = (th_b - th_a) * (h_pt * h_pt + uu * uu) / h_pt
    t_cam = torch.minimum(m.clip(uu - u0_hat, min=0.0), seg_len)
    if bool(meta.iprop('vrl_aniso_cdf', False)):
        t_cam_a, inv_a, ok_a = _aniso_cam_cdf(
            scene, meta, cam_medium, med_v, seg_o, seg_d, seg_len, p_vrl,
            d_v, u2, act & ~degenerate)
        t_cam = torch.where(ok_a, t_cam_a, t_cam)
        inv_pdf_c = torch.where(ok_a, inv_a, inv_pdf_c)

    # degenerate pairs (and use_uniform_sampling): uniform sampling of
    # both segments
    if bool(meta.iprop('use_uniform_sampling',
                       meta.iprop('use_nl_atomic_query', False))):
        degenerate = torch.ones_like(degenerate)
    t_cam = torch.where(degenerate, u1 * seg_len, t_cam)
    t_vrl = torch.where(degenerate, u2 * len_v, t_vrl)
    p_cam = seg_o + seg_d * t_cam[:, None]
    p_vrl = o_v + d_v * t_vrl[:, None]
    inv_pdf = torch.where(degenerate, seg_len * len_v, inv_pdf_v * inv_pdf_c)
    act = act & torch.isfinite(inv_pdf) & (inv_pdf > 0)

    # --- both phase functions x sigma_s x three transmittances ------------
    dirv = p_vrl - p_cam
    dist = m.norm(dirv)
    act = act & (dist > 1e-6)
    dirn = dirv * m.safe_rcp(dist)[:, None]

    ray_pf = phase_mod.eval(scene, meta, cam_medium, -seg_d, dirn, act)
    vrl_pf = phase_mod.eval(scene, meta, med_v, -d_v, -dirn, act)
    sig_s_cam, _, _ = medium_mod.get_scattering_coefficients(
        scene, meta, cam_medium, p_cam, act)
    sig_s_vrl, _, _ = medium_mod.get_scattering_coefficients(
        scene, meta, med_v, p_vrl, act)

    tr_cam, sampler = medium_mod.segment_tr(scene, meta, sampler, seg_o,
                                            seg_d, t_cam, cam_medium,
                                            channel, act)
    tr_vrl, sampler = medium_mod.segment_tr(scene, meta, sampler, o_v, d_v,
                                            t_vrl, med_v, channel, act)
    act_tr = act & (ray_pf > 0) & (vrl_pf > 0)
    tr_link, sampler = transmittance_to_point(
        scene, meta, sampler, p_cam, dirn, dist, cam_medium, channel,
        act_tr, torch.ones((N,), dtype=torch.bool, device=dev))

    falloff = m.safe_rcp(dist * dist)
    contrib = flux * (falloff * vrl_pf * ray_pf * inv_pdf)[:, None] \
        * tr_vrl * tr_cam * tr_link * sig_s_cam * sig_s_vrl
    contrib = torch.where(torch.isfinite(contrib), contrib, 0.0)
    return torch.where(act_tr[:, None], contrib, 0.0), sampler


class VRLClusters(NamedTuple):
    """The VRL lightcut as a two-level Morton hierarchy: VRLs sorted by
    midpoint and chunked into K1 coarse clusters of K2 subclusters of M
    members. A query importance-samples coarse, sub and member with the
    lightcut's upper-bound terms (flux x Tr bound / distance), exact
    member weights at the last stage; dividing by the product pdf keeps
    the estimator unbiased."""
    c_centroid: torch.Tensor  # (K1, 3) flux-weighted centroid
    c_radius2: torch.Tensor   # (K1,) squared radius
    c_lum: torch.Tensor       # (K1,) total flux luminance
    s_centroid: torch.Tensor  # (K1, K2 * 3)
    s_radius2: torch.Tensor   # (K1, K2)
    s_lum: torch.Tensor       # (K1, K2)
    # one row a fine cluster: [midpoint xyz * M | luminance * M |
    # member VRL id * M], ids as float32 (exact below 2^24)
    rows: torch.Tensor        # (K1 * K2, 5 * M)


def _morton3(q):
    """Interleave 10-bit coordinates into a 30-bit Morton code."""
    def spread(x):
        x = x & 0x3ff
        x = (x | (x << 16)) & 0x30000ff
        x = (x | (x << 8)) & 0x300f00f
        x = (x | (x << 4)) & 0x30c30c3
        x = (x | (x << 2)) & 0x9249249
        return x
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def build_vrl_clusters(scene, maps, n_clusters: int) -> VRLClusters:
    """Morton-sort the VRL midpoints, chunk them into F = K1 * K2
    equal-count fine clusters of M members, and aggregate fine to coarse:
    the lightcut's tree as a sort and two reductions."""
    V = maps.vrl_o.shape[0]
    dev = maps.vrl_o.device
    # member ids ride the float32 rows table: exact only below 2^24
    assert V < (1 << 24), (
        f"VRL map capacity {V} >= 2^24: member ids no longer round-trip "
        "through the float32 cluster rows table")
    F = int(max(1, min(n_clusters, max(V // 4, 1))))
    K2 = int(min(16, F))
    K1 = -(-F // K2)
    F = K1 * K2
    M = -(-V // F)
    mid = maps.vrl_o + maps.vrl_d * (0.5 * maps.vrl_len)[:, None]
    ext = m.clip(scene.bbox_hi - scene.bbox_lo, min=1e-9)
    qm = m.clip(((mid - scene.bbox_lo) / ext * 1023.0).to(torch.int32),
                     0, 1023)
    code = torch.where(maps.vrl_valid, _morton3(qm), 0x7fffffff)
    order = torch.argsort(code, stable=True).to(torch.int32)
    member = torch.cat([order, torch.full((F * M - V,), V, dtype=torch.int32,
                                          device=dev)]).reshape(F, M)
    mi = m.clip(member, max=V - 1).long()
    mvalid = (member < V) & maps.vrl_valid[mi]

    lum = torch.tensor(_LUM, device=dev)
    lum_m = torch.where(mvalid, m.dot(maps.vrl_flux[mi], lum)
                        * m.clip(maps.vrl_len[mi], min=1e-6), 0.0)
    f_lum = lum_m.sum(dim=1)                                   # (F,)

    mid_m = maps.vrl_o[mi] + maps.vrl_d[mi] \
        * (0.5 * maps.vrl_len[mi])[..., None]                  # (F, M, 3)
    mid_m = torch.where(mvalid[..., None], mid_m, 0.0)
    f_cent = (mid_m * lum_m[..., None]).sum(dim=1) \
        * m.safe_rcp(f_lum)[:, None]                           # (F, 3)
    f_r2 = torch.where(mvalid, m.squared_norm(mid_m - f_cent[:, None, :])
                       * lum_m, 0.0).sum(dim=1) * m.safe_rcp(f_lum)

    # coarse aggregation over each run of K2 fine clusters
    s_lum = f_lum.reshape(K1, K2)
    s_cent = f_cent.reshape(K1, K2, 3)
    s_r2 = f_r2.reshape(K1, K2)
    c_lum = s_lum.sum(dim=1)
    c_cent = (s_cent * s_lum[..., None]).sum(dim=1) \
        * m.safe_rcp(c_lum)[:, None]
    c_r2 = ((m.squared_norm(s_cent - c_cent[:, None, :]) + s_r2)
            * s_lum).sum(dim=1) * m.safe_rcp(c_lum)

    rows = torch.cat([mid_m.reshape(F, M * 3), lum_m,
                      member.to(torch.float32)], dim=1)        # (F, 5M)
    return VRLClusters(c_centroid=c_cent, c_radius2=c_r2, c_lum=c_lum,
                       s_centroid=s_cent.reshape(K1, K2 * 3),
                       s_radius2=s_r2, s_lum=s_lum, rows=rows)


def _seg_point_dist2(seg_o, seg_d, seg_len, p):
    """Squared distance from the camera segments (N, 3) + (N,) to points
    (N, K, 3) -> (N, K)."""
    rel = p - seg_o[:, None, :]
    t = torch.minimum(m.clip(m.dot(rel, seg_d[:, None, :]), min=0.0),
                      seg_len[:, None])
    return m.squared_norm(rel - t[..., None] * seg_d[:, None, :])


def _sigma_min_bound(scene, meta, medium_idx):
    """A lower bound on the extinction along links into the camera
    medium a lane (the Tr term of the lightcut's cluster bound, Tr <=
    exp(-sigma_min d)): the smallest channel, times the grid's minimum
    for heterogeneous media."""
    sigma_unit, _, _, _, is_het = medium_mod._medium_facts(scene,
                                                           medium_idx)
    sig = sigma_unit.amin(dim=-1)
    if medium_mod._has_supervoxels(scene, meta):
        sig = torch.where(is_het, sig * scene.media.grid_sup_min.amin(), sig)
    return torch.where(medium_idx >= 0, sig, 0.0)


def _lc_stage_weights(lum, cent, r2, seg_o, seg_d, seg_len, sig_min):
    """One stage's selection weights: flux luminance over the softened
    segment-to-centroid distance (falloff exponent 1, the Kulla
    line-integral scaling and the reference's default), times the Tr
    bound to the cluster's face. ``lum``/``r2`` (..., K) and ``cent``
    (..., K, 3) broadcast against the (N,) lanes."""
    d2 = _seg_point_dist2(seg_o, seg_d, seg_len, cent)
    w = lum * m.safe_rcp(m.safe_sqrt(d2 + r2 + 1e-4))
    d_near = m.clip(m.safe_sqrt(d2) - m.safe_sqrt(r2), min=0.0)
    return w * torch.exp(-sig_min[:, None] * d_near)


def _pick(cdf, u):
    """Inverse-CDF index of u in [0, 1) along axis 1 of (N, K) running
    sums."""
    i = (cdf < u[:, None] * cdf[:, -1:]).sum(dim=1)
    return m.clip(i, max=cdf.shape[1] - 1)


def _sample_discrete(w, u):
    """Inverse-CDF draw along axis 1 of (N, K) weights. Returns (index,
    prob, total)."""
    cdf = torch.cumsum(w, dim=1)
    tot = cdf[:, -1]
    i = _pick(cdf, u)
    p = w.gather(1, i[:, None])[:, 0] * m.safe_rcp(tot)
    return i, p, tot


def _cluster_weights(clusters: VRLClusters, seg_o, seg_d, seg_len,
                     sig_min):
    """(N, K1) coarse selection weights (the first stage)."""
    return _lc_stage_weights(
        clusters.c_lum[None, :], clusters.c_centroid[None, :, :],
        clusters.c_radius2[None, :], seg_o, seg_d, seg_len, sig_min)


def sample_cluster_vrl(clusters: VRLClusters, w, w_cdf, seg_o, seg_d,
                       seg_len, u_c, u_s, u_m, V: int, sig_min):
    """Draw (coarse, sub, member) a lane: coarse from the precomputed
    (N, K1) weights, subcluster from the chosen coarse row's fine-cluster
    bounds, member with exact flux / distance weights over the chosen fine
    cluster's M members. Returns (vrl_index, inv_pdf, ok)."""
    K2 = clusters.s_lum.shape[1]
    M_ = clusters.rows.shape[1] // 5
    # coarse
    c1 = _pick(w_cdf, u_c)
    w_tot = w_cdf[:, -1]
    p_c = w.gather(1, c1[:, None])[:, 0] * m.safe_rcp(w_tot)
    # subcluster
    c1l = c1.long()
    ws = _lc_stage_weights(clusters.s_lum[c1l],
                           clusters.s_centroid[c1l].reshape(-1, K2, 3),
                           clusters.s_radius2[c1l], seg_o, seg_d, seg_len,
                           sig_min)
    c2, p_s, ws_tot = _sample_discrete(ws, u_s)
    # member: the chosen fine cluster's packed row
    row = clusters.rows[(c1 * K2 + c2).long()]                 # (N, 5M)
    mid = row[:, :M_ * 3].reshape(-1, M_, 3)
    mlum = row[:, M_ * 3:M_ * 4]
    mid_f = row[:, M_ * 4:]
    d2 = _seg_point_dist2(seg_o, seg_d, seg_len, mid)
    r2_f = clusters.s_radius2[c1l].gather(1, c2[:, None])      # (N, 1)
    wm = mlum * m.safe_rcp(m.safe_sqrt(d2 + 1e-2 * r2_f + 1e-6))
    wm = wm * torch.exp(-sig_min[:, None] * m.safe_sqrt(d2))
    j, p_m, wm_tot = _sample_discrete(wm, u_m)
    vi = torch.round(mid_f.gather(1, j[:, None])[:, 0]).to(torch.int32)
    ok = (vi < V) & (p_c > 0) & (p_s > 0) & (p_m > 0) \
        & (w_tot > 0) & (ws_tot > 0) & (wm_tot > 0)
    inv_pdf = m.safe_rcp(p_c * p_s * p_m)
    return m.clip(vi, max=V - 1), inv_pdf, ok


VRL_RIS_CHUNK = 512


def _vrl_ris_weights(maps, seg_o, seg_d, seg_len, sl):
    """Selection weights (N, C) of a chunk of VRL ids ``sl`` (C,), -1 for
    padding, against each camera segment: the VRL's power luminance times
    its length over the squared distance from its midpoint to the
    segment."""
    sl_c = m.clip(sl, min=0).long()
    vo, vd, vl = maps.vrl_o[sl_c], maps.vrl_d[sl_c], maps.vrl_len[sl_c]
    lum = m.dot(maps.vrl_flux[sl_c], torch.tensor(_LUM, device=vo.device))
    ok = maps.vrl_valid[sl_c] & (sl >= 0)
    mid = vo + vd * (0.5 * vl)[:, None]                        # (C, 3)
    # the closest point on the camera segment to each midpoint
    rel = mid[None, :, :] - seg_o[:, None, :]                  # (N, C, 3)
    t = torch.minimum(m.clip(m.dot(rel, seg_d[:, None, :]), min=0.0),
                      seg_len[:, None])
    d2 = m.squared_norm(rel - t[..., None] * seg_d[:, None, :])
    w = (lum * vl)[None, :] / (d2 + 1e-3 * (1.0 + d2))
    return torch.where(ok[None, :], m.clip(w, min=0.0), 0.0)


def _ris_chunks(V: int, dev):
    """The VRL ids in chunks of ``VRL_RIS_CHUNK``, the last padded with
    -1."""
    ch = min(VRL_RIS_CHUNK, V)
    n_chunks = -(-V // ch)
    idx = torch.cat([torch.arange(V, dtype=torch.int32, device=dev),
                     torch.full((n_chunks * ch - V,), -1, dtype=torch.int32,
                                device=dev)])
    return idx.reshape(n_chunks, ch)


def _ris_select(maps, seg_o, seg_d, seg_len, chunks, thresh):
    """Invert the running sum of the weights over the chunks in order:
    the first VRL whose running sum reaches ``thresh``. Returns (id, its
    weight); id -1 where none does."""
    N = seg_o.shape[0]
    dev = seg_o.device
    run = torch.zeros((N,), device=dev)
    sel_i = torch.full((N,), -1, dtype=torch.int32, device=dev)
    sel_w = torch.zeros((N,), device=dev)
    for sl in chunks:
        w = _vrl_ris_weights(maps, seg_o, seg_d, seg_len, sl)
        cw = torch.cumsum(w, dim=1) + run[:, None]
        hit = (cw >= thresh[:, None]) & (sel_i < 0)[:, None]
        first = hit.to(torch.int32).argmax(dim=1)
        take = hit.any(dim=1)
        sel_i = torch.where(take, sl[first], sel_i)
        sel_w = torch.where(take, w.gather(1, first[:, None])[:, 0], sel_w)
        run = cw[:, -1]
    return sel_i, sel_w


def query_vrls(scene, meta, maps, seg_o, seg_d, seg_len, cam_medium, channel,
               sampler, active, samples_per_query: int,
               strategy: str = 'cluster'):
    """The VRL query of each camera segment: ``samples_per_query`` draws,
    each evaluated by ``vrl_contrib``. ``cluster`` selects through the
    VRL clusters (the reference's lightcut analog, the thesis's
    configurations), ``uniform`` uniformly (the reference's
    no-acceleration default), ``ris`` by resampled importance over every
    VRL, two passes over 512-VRL chunks (the total weight, then the
    inverted running sum), weighted by w_total / w_vi."""
    N = seg_o.shape[0]
    dev = seg_o.device
    V = maps.vrl_o.shape[0]
    if V == 0:
        return torch.zeros((N, 3), device=dev), sampler
    acc = torch.zeros((N, 3), device=dev)

    if strategy == 'cluster' and maps.clusters is not None and V >= 64:
        clusters = maps.clusters
        sig_min = _sigma_min_bound(scene, meta, cam_medium)
        w = _cluster_weights(clusters, seg_o, seg_d, seg_len, sig_min)
        w_cdf = torch.cumsum(w, dim=1)
        for _ in range(samples_per_query):
            u_c, sampler = sampler.next_1d()
            u_s, sampler = sampler.next_1d()
            u_m, sampler = sampler.next_1d()
            u1, sampler = sampler.next_1d()
            u2, sampler = sampler.next_1d()
            vi, inv_pdf, ok = sample_cluster_vrl(clusters, w, w_cdf, seg_o,
                                                 seg_d, seg_len, u_c, u_s,
                                                 u_m, V, sig_min)
            c, sampler = vrl_contrib(scene, meta, maps, seg_o, seg_d,
                                     seg_len, cam_medium, vi, u1, u2,
                                     channel, sampler, active & ok)
            acc = acc + c * torch.where(ok, inv_pdf, 0.0)[:, None]
        return acc * (maps.vrl_scale / samples_per_query), sampler

    if strategy == 'ris' and V >= 64:
        chunks = _ris_chunks(V, dev)
        w_total = torch.zeros((N,), device=dev)
        for sl in chunks:
            w_total = w_total + _vrl_ris_weights(maps, seg_o, seg_d, seg_len,
                                                 sl).sum(dim=1)
        ok_lane = active & (w_total > 0)
        for _ in range(samples_per_query):
            u_sel, sampler = sampler.next_1d()
            u1, sampler = sampler.next_1d()
            u2, sampler = sampler.next_1d()
            sel_i, sel_w = _ris_select(maps, seg_o, seg_d, seg_len, chunks,
                                       u_sel * w_total)
            lane_ok = ok_lane & (sel_i >= 0) & (sel_w > 0)
            c, sampler = vrl_contrib(scene, meta, maps, seg_o, seg_d,
                                     seg_len, cam_medium,
                                     m.clip(sel_i, min=0), u1, u2,
                                     channel, sampler, lane_ok)
            inv_p = torch.where(lane_ok, w_total * m.safe_rcp(sel_w), 0.0)
            acc = acc + c * inv_p[:, None]
        return acc * (maps.vrl_scale / samples_per_query), sampler

    count = m.clip(maps.vrl_count, min=1)
    for _ in range(samples_per_query):
        u_sel, sampler = sampler.next_1d()
        u1, sampler = sampler.next_1d()
        u2, sampler = sampler.next_1d()
        vi = torch.minimum((u_sel * count).to(torch.int32), count - 1)
        c, sampler = vrl_contrib(scene, meta, maps, seg_o, seg_d, seg_len,
                                 cam_medium, vi, u1, u2, channel, sampler,
                                 active)
        acc = acc + c
    scale = count.to(torch.float32) / samples_per_query * maps.vrl_scale
    return acc * scale, sampler


class VRLCamState(NamedTuple):
    sampler: Sampler
    ray: Ray
    throughput: torch.Tensor
    result: torch.Tensor
    depth: torch.Tensor
    active: torch.Tensor
    medium_idx: torch.Tensor
    specular_chain: torch.Tensor


def maps_to_numpy(maps: lighttrace.PhotonMaps) -> dict:
    """The maps as numpy arrays keyed by dotted field path, the form
    ``maps_from_numpy`` takes."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, torch.Tensor):
            out[prefix] = node.cpu().numpy()
        elif node is not None:
            for f in node._fields:
                walk(f'{prefix}.{f}' if prefix else f, getattr(node, f))
    walk('', maps)
    return out


def maps_from_numpy(arrays: dict, device=None) -> lighttrace.PhotonMaps:
    """The port's ``PhotonMaps`` from numpy arrays keyed by dotted field
    path ("sp_pos", "vp_grid.order", "clusters.rows", ...), the form a
    reference map set flattens to: the state the camera pass carries
    across from another package or device. Without "clusters.*" keys the
    maps have no clusters."""
    from ..scene.builder import resolve_device
    from ..ops.hashgrid import HashGrid
    device = resolve_device(device)

    def get(key):
        return torch.as_tensor(np.array(arrays[key]), device=device)

    def table(cls, prefix):
        return cls(*(get(f'{prefix}.{f}') for f in cls._fields))
    kw = {}
    for f in lighttrace.PhotonMaps._fields:
        if f.endswith('_grid'):
            kw[f] = table(HashGrid, f)
        elif f == 'clusters':
            kw[f] = (table(VRLClusters, f) if 'clusters.rows' in arrays
                     else None)
        else:
            kw[f] = get(f)
    return lighttrace.PhotonMaps(**kw)


def _map_psum(x, meta):
    """All-reduce a photon or VRL map estimate over the map axis
    ``map_psum_axis`` (the group ``collectives.bind`` bound to it); the
    identity without the property. Under ``parallel.sharded_maps`` each
    rank holds a shard of the maps, so every estimate is a partial sum.
    The calls are unconditional at their sites: each rank of the axis
    makes the same all-reduces in the same order, as their trip counts
    read only ray state."""
    ax = meta.iprop('map_psum_axis', None)
    if not ax:
        return x
    return collectives.all_reduce_sum(x, collectives.group_of(ax))


def _skip_segment_tr(meta, sampler, n: int) -> Sampler:
    """The sampler after ``n`` skipped ``medium.segment_tr`` calls: each
    draws one dimension in a scene with a heterogeneous medium, none
    otherwise."""
    if MEDIUM_TYPES['heterogeneous'] in meta.medium_types:
        return sampler._replace(dim=sampler.dim + n)
    return sampler


def _requires_grad(tree) -> bool:
    """Whether any tensor of a record (nested named tuples) requires
    grad."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, tuple):
        return any(_requires_grad(x) for x in tree)
    return False


def make_sample(use_vrls: bool):
    """The camera pass of ``vrl`` (use_vrls) or ``photonmapper``."""
    name = 'vrl' if use_vrls else 'photonmapper'

    def sample(scene, meta, sampler: Sampler, ray: Ray, active=None,
               diff: bool = False, aux=None):
        """The camera pass. It is not differentiable, as in the reference:
        there its bounce loop is a ``lax.while_loop``, which ``jax.grad``
        cannot reverse, and its differentiable render passes no maps. So
        under ``diff``, or where autograd would record a gradient of the
        scene or the maps, it raises. The light pass (``preprocess``) is
        differentiable in both packages."""
        if diff or (torch.is_grad_enabled()
                    and (_requires_grad(scene) or _requires_grad(aux))):
            raise ValueError(
                f"the {name} camera pass cannot be differentiated: the "
                f"reference runs it in lax.while_loops, which reverse-mode "
                f"differentiation cannot go through, and its "
                f"differentiable render gives it no photon or VRL maps; "
                f"differentiate the light pass (preprocess), or render "
                f"with path, volpath or volpathmis")
        maps: lighttrace.PhotonMaps = aux
        N = ray.o.shape[0]
        dev = ray.o.device
        max_depth = int(meta.iprop('max_depth', 512))
        # null-BSDF pass-throughs do not advance the depth: +16 slack
        max_iters = int(meta.iprop('max_cam_iters', min(max_depth + 16, 64)))
        spq = int(meta.iprop('samples_per_query', 2))
        use_direct = bool(meta.iprop('use_direct_illum', True)) \
            or not use_vrls
        use_bre = bool(meta.iprop('use_bre', False))
        # rr_vrl (the reference's distance roulette) is an alias of vrl_ris
        if bool(meta.iprop('vrl_ris', meta.iprop('rr_vrl', False))):
            strategy = 'ris'
        elif bool(meta.iprop('use_light_cut', True)):
            strategy = 'cluster'
        else:
            strategy = 'uniform'
        nl_cam = bool(meta.iprop('use_non_linear_camera', True)) \
            and bool(meta.iprop('use_non_linear', True)) \
            and MEDIUM_TYPES['nonlinear'] in meta.medium_types
        max_bends = int(meta.iprop('max_nl_bends', 32))
        g_cap = int(meta.iprop('gather_points_cap', 64))
        r_global, r_caustic, r_volume = _radii(scene, meta)
        inf = torch.full((N,), m.Infinity, device=dev)
        zeros3 = torch.zeros((N, 3), device=dev)

        u_ch, sampler = sampler.next_1d()
        channel = m.clip((u_ch * 3).to(torch.int32), max=2)
        st = VRLCamState(
            sampler=sampler, ray=ray, throughput=torch.ones((N, 3),
                                                            device=dev),
            result=zeros3, depth=torch.ones((N,), dtype=torch.int32,
                                            device=dev),
            active=initial_active(active, N, dev),
            medium_idx=torch.full((N,), meta.camera_medium,
                                  dtype=torch.int32, device=dev),
            specular_chain=torch.ones((N,), dtype=torch.bool, device=dev))

        it = 0
        while it < max_iters and any_on_host(st.active):
            it += 1
            smp = st.sampler
            result = st.result
            throughput = st.throughput
            active = st.active & (st.depth < max_depth)

            si = isect.ray_intersect(scene, st.ray)
            smp = smp.count_rays(active)
            in_medium = active & (st.medium_idx >= 0) & si.valid

            # ---- medium leg: bend, gather photons, query VRLs ---------
            if nl_cam:
                bent, si_b = nl_mod.bend_ray(
                    scene, meta, Ray(st.ray.o, st.ray.d, st.ray.mint, inf),
                    st.medium_idx, in_medium, max_bends, stop_at_scene=True)
                # each bent segment cost one scene intersection
                smp = smp.count_rays(torch.where(in_medium, bent.count, 0))
                si = _where_tree(in_medium & si_b.valid, si_b, si)
            else:
                slen = torch.where(in_medium, torch.where(
                    torch.isfinite(si.t), si.t, 0.0), 0.0)
                bent = nl_mod.BentRay(
                    seg_o=st.ray.o[:, None, :], seg_d=st.ray.d[:, None, :],
                    seg_len=slen[:, None],
                    count=in_medium.to(torch.int32), total=slen)

            # direct: volume photons gathered along the bent ray
            u_r, smp = smp.next_1d()
            radius = r_volume * m.lerp(0.75, 1.25, u_r)
            if use_direct and use_bre:
                direct_v, smp = _beam_segments(
                    scene, meta, maps, bent, st, in_medium, radius, g_cap,
                    smp, channel)
                result = result + throughput * direct_v * maps.vp_scale
            elif use_direct:
                direct_v, smp = _gather_volume(
                    scene, meta, maps, bent, st, in_medium, radius, g_cap,
                    smp, channel)
                result = result + throughput * direct_v * maps.vp_scale

            # indirect: the VRL query of each bent segment, over the live
            # segment count
            if use_vrls:
                vrl_acc, smp = _query_segments(
                    scene, meta, maps, bent, st, in_medium, spq, strategy,
                    smp, channel)
                result = result + throughput * vrl_acc

            # camera attenuation through the medium
            thr_med, smp = medium_mod.segment_tr(
                scene, meta, smp, st.ray.o, st.ray.d, bent.total,
                st.medium_idx, channel, in_medium)
            throughput = throughput * thr_med

            # ---- surface leg ------------------------------------------
            active_surface = active & si.valid
            hit_em = active_surface & st.specular_chain \
                & (si.emitter_idx >= 0)
            le = emitter_mod.eval_hit(scene, meta, si, hit_em)
            result = result + torch.where(hit_em[:, None], throughput * le,
                                          0.0)
            esc = active & ~si.valid & st.specular_chain
            result = result + torch.where(
                esc[:, None], throughput * emitter_mod.eval_env(
                    scene, meta, st.ray.d, esc), 0.0)
            # emitter surfaces end the path
            active_surface = active_surface & (si.emitter_idx < 0)

            flags = bsdf_mod.flags_of(scene, si)
            gather_here = active_surface & ((flags & F_SMOOTH) > 0)
            est_c = _map_psum(photon_est.estimate_surface(
                scene, meta, maps, si, gather_here, r_caustic, True), meta)
            est_g = _map_psum(photon_est.estimate_surface(
                scene, meta, maps, si, gather_here, r_global, False), meta)
            result = result + torch.where(gather_here[:, None],
                                          throughput * (est_c + est_g), 0.0)
            # smooth surfaces end the path
            cont = active_surface & ~gather_here

            u1b, smp = smp.next_1d()
            u2b, smp = smp.next_2d()
            bs, b_weight = bsdf_mod.sample(scene, meta, si, u1b, u2b)
            throughput = torch.where(cont[:, None], throughput * b_weight,
                                     throughput)
            wo_world = si.to_world(bs.wo)
            non_null = cont & ~bs.null
            depth = torch.where(non_null, st.depth + 1, st.depth)
            specular_chain = st.specular_chain | (non_null & bs.delta)
            specular_chain = specular_chain & ~(cont & ~bs.delta & ~bs.null)
            new_medium = torch.where(cont & si.is_medium_transition(),
                                     si.target_medium(wo_world),
                                     st.medium_idx)
            new_ray = Ray(o=torch.where(cont[:, None], si.p, st.ray.o),
                          d=torch.where(cont[:, None], wo_world, st.ray.d),
                          mint=torch.full((N,), m.RayEpsilon, device=dev),
                          maxt=inf)
            alive = cont & (bs.pdf > 0) & (throughput != 0).any(dim=-1)
            st = VRLCamState(
                sampler=smp, ray=new_ray, throughput=throughput,
                result=result, depth=depth, active=alive,
                medium_idx=new_medium, specular_chain=specular_chain)
        return st.result, torch.ones((N,), dtype=torch.bool, device=dev), \
            st.sampler

    return sample


def _gather_volume(scene, meta, maps, bent, st, in_medium, radius, g_cap,
                   smp, channel):
    """Volume photons gathered at t = radius + 2 radius g (g < g_cap)
    along the bent ray, each attenuated from the previous gather point.
    Runs the trips some lane needs (t_g within its curve): one host
    read."""
    N = in_medium.shape[0]
    dev = in_medium.device
    g_all = torch.arange(g_cap, device=dev, dtype=torch.float32)
    t_all = radius[:, None] + 2.0 * radius[:, None] * g_all[None, :]
    need = in_medium[:, None] & (t_all <= bent.total[:, None])
    n_g = int_on_host(need.sum(dim=1).amax())
    acc = torch.zeros((N, 3), device=dev)
    tr_run = torch.ones((N, 3), device=dev)
    last_t = torch.zeros((N,), device=dev)
    for g in range(n_g):
        t_g = radius + 2.0 * radius * g
        ok = in_medium & (t_g <= bent.total)
        p_g = bent.at(t_g)
        # transmittance from the previous gather point
        step_tr, smp = medium_mod.segment_tr(
            scene, meta, smp, bent.at(last_t), st.ray.d, t_g - last_t,
            st.medium_idx, channel, ok)
        tr_run = torch.where(ok[:, None], tr_run * step_tr, tr_run)
        est = _map_psum(photon_est.estimate_volume(
            scene, meta, maps, p_g, -st.ray.d, st.medium_idx, ok, radius),
            meta)
        acc = acc + torch.where(ok[:, None], tr_run * est, 0.0)
        last_t = torch.where(ok, t_g, last_t)
    return acc, _skip_segment_tr(meta, smp, g_cap - n_g)


def _beam_segments(scene, meta, maps, bent, st, in_medium, radius, g_cap,
                   smp, channel):
    """The beam radiance estimate of every bent segment (``g_cap`` steps
    of 2 radius each at most), attenuated by the segments before it, over
    the live segment count (one host read)."""
    N = in_medium.shape[0]
    dev = in_medium.device
    n_seg = int_on_host(torch.where(in_medium, bent.count, 0).amax())
    acc = torch.zeros((N, 3), device=dev)
    seg_tr = torch.ones((N, 3), device=dev)
    for s_i in range(n_seg):
        so = bent.seg_o[:, s_i].contiguous()
        sd = bent.seg_d[:, s_i].contiguous()
        sl = bent.seg_len[:, s_i].contiguous()
        ok = in_medium & (s_i < bent.count) & (sl > 0)
        est = _map_psum(photon_est.estimate_beam(
            scene, meta, maps, so, sd, sl, -sd, st.medium_idx, ok, radius,
            g_cap), meta)
        acc = acc + torch.where(ok[:, None], seg_tr * est, 0.0)
        tr_s, smp = medium_mod.segment_tr(scene, meta, smp, so, sd, sl,
                                          st.medium_idx, channel, ok)
        seg_tr = seg_tr * tr_s
    return acc, _skip_segment_tr(meta, smp, bent.seg_len.shape[1] - n_seg)


def _query_segments(scene, meta, maps, bent, st, in_medium, spq, strategy,
                    smp, channel):
    """The VRL query of every bent segment, attenuated by the segments
    before it, over the live segment count (one host read)."""
    N = in_medium.shape[0]
    dev = in_medium.device
    n_seg = int_on_host(torch.where(in_medium, bent.count, 0).amax())
    vrl_acc = torch.zeros((N, 3), device=dev)
    seg_tr = torch.ones((N, 3), device=dev)
    for s_i in range(n_seg):
        so = bent.seg_o[:, s_i].contiguous()
        sd = bent.seg_d[:, s_i].contiguous()
        sl = bent.seg_len[:, s_i].contiguous()
        seg_ok = in_medium & (s_i < bent.count) & (sl > 0)
        q, smp = query_vrls(scene, meta, maps, so, sd, sl, st.medium_idx,
                            channel, smp, seg_ok, spq, strategy=strategy)
        q = _map_psum(q, meta)
        vrl_acc = vrl_acc + torch.where(seg_ok[:, None], seg_tr * q, 0.0)
        tr_s, smp = medium_mod.segment_tr(scene, meta, smp, so, sd, sl,
                                          st.medium_idx, channel, seg_ok)
        seg_tr = seg_tr * tr_s
    return vrl_acc, smp


sample = make_sample(use_vrls=True)
